"""The inputs are the same for the same seed, other for another, and take
seeds past 32 bits."""

import pytest
import torch

import _tiny
from portbench import inputs, serve
from portbench.reference import Model

M = Model.from_config(_tiny.MOE)
BIG = 2 ** 31 + 12345


def same(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    return torch.equal(a, b)


@pytest.mark.parametrize("make", [
    lambda s: inputs.weights(M, s, "cpu"),
    lambda s: [inputs.Prompts(M, s, "cpu", 2, 9).next() for _ in range(3)],
], ids=["weights", "prompts"])
def test_same_seed_same_inputs(make):
    a, b, c = make(BIG), make(BIG), make(BIG + 1)
    if isinstance(a, (list, tuple)):
        assert all(same(x, y) for x, y in zip(a, b))
        assert not all(same(x, y) for x, y in zip(a, c))
    else:
        assert same(a, b) and not same(a, c)


def test_prompts_differ_request_to_request_and_stay_in_vocab():
    p = inputs.Prompts(M, BIG, "cpu", 4, 64)
    a, b = p.next(), p.next()
    assert not torch.equal(a, b)
    assert int(a.max()) < M.vocab and int(a.min()) >= 0


def test_padding_rows_of_the_embedding_are_zero():
    w = inputs.weights(M, BIG, "cpu")
    assert w["embed"].shape[0] == inputs.padded(M.vocab) == 1024
    assert not w["embed"][M.vocab:].any()


@pytest.mark.parametrize("batch,rows,within", [
    (8, 4, 8), (1, 1, 8), (16, 2, 3), (3, 5, 2), (256, 4, 8)])
def test_picks_spread_over_the_batch_and_the_first_requests(batch, rows,
                                                            within):
    t = dict(_tiny.PREFILL, batch=batch, check={"rows": rows,
                                                "within": within})
    got = serve.picks(t, BIG)
    assert got == serve.picks(t, BIG) == sorted(got)
    assert len(got) == len({b for _, b in got}) == min(rows, batch)
    assert {r for r, _ in got} <= set(range(within))
    assert len({r for r, _ in got}) == min(rows, batch, within)
    if batch > 1:
        assert {b < batch / 2 for _, b in got} == {True, False}
