"""The port's dispatch module ``repro_torch.kernels.ops`` on CPU tensors:
each function with ``impl="auto"`` and ``impl="torch"`` against the plain
versions of ``repro_torch.kernels.ref`` (equal: on the CPU both routes run
them), against the reference's ``repro.kernels.ops`` with ``impl="xla"``
on the same numpy inputs (float32, within 2e-5: both sum in float32, in
other orders), attention also against the reference's Pallas kernel in
interpret mode; and the port's refusals: ``impl="cuda"`` on a CPU tensor,
``impl="interpret"`` and an unknown ``impl``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels import ops as jops  # noqa: E402

from repro_torch.kernels import launch_counts, ops, ref  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)
NAMES = ["attention", "decode_attention", "segment_sum_sorted",
         "embedding_bag", "triple_scan"]


def _inputs(name: str, seed: int = 0):
    """(numpy positional args, keyword args) of a small call of ``name``."""
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    if name == "attention":                 # GQA group 2, window, softcap
        return ([normal(1, 4, 64, 16), normal(1, 2, 64, 16),
                 normal(1, 2, 64, 16)], dict(window=24, softcap=30.0))
    if name == "decode_attention":
        return ([normal(3, 4, 16), normal(3, 2, 64, 16), normal(3, 2, 64, 16),
                 np.array([1, 40, 64], np.int32)], dict(window=0,
                                                        softcap=0.0))
    if name == "segment_sum_sorted":
        dst = np.sort(rng.integers(0, 20, 90)).astype(np.int32)
        return [normal(90, 8), dst, 20], {}
    if name == "embedding_bag":
        ids = rng.integers(0, 50, (4, 3, 5)).astype(np.int32)
        mask = (rng.random((4, 3, 5)) < 0.7).astype(np.float32)
        return [normal(50, 8), ids, mask], dict(combiner="mean")
    triples = rng.integers(0, 6, (500, 3)).astype(np.int32)
    return [triples, np.array([2, -1, 3], np.int32)], {}


def _torch(args):
    return [torch.from_numpy(a) if isinstance(a, np.ndarray) else a
            for a in args]


def _plain(name, args, kw):
    """The port's plain version of ``name`` on torch ``args``."""
    if name == "attention":
        return ref.mha_reference(*args, True, **kw)
    if name == "decode_attention":
        return ref.decode_reference(*args, **kw)
    if name == "segment_sum_sorted":
        return ref.segment_sum_sorted_reference(*args)
    if name == "embedding_bag":
        return ref.embedding_bag_reference(*args, **kw)
    return ref.triple_scan_reference(args[0], *args[1].tolist())


@pytest.mark.parametrize("impl", ["auto", "torch"])
@pytest.mark.parametrize("name", NAMES)
def test_ops_equal_plain_versions_on_cpu(name, impl):
    args, kw = _inputs(name)
    t = _torch(args)
    before = launch_counts()
    got = getattr(ops, name)(*t, impl=impl, **kw)
    want = _plain(name, t, kw)
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert launch_counts() == before             # the CPU launches nothing


@pytest.mark.parametrize("name", NAMES)
def test_ops_match_reference_ops(name):
    args, kw = _inputs(name, seed=1)
    want = getattr(jops, name)(*[jnp.asarray(a) if isinstance(a, np.ndarray)
                                 else a for a in args], impl="xla", **kw)
    got = getattr(ops, name)(*_torch(args), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_attention_matches_reference_pallas_interpret():
    """The reference's Pallas flash kernel in interpret mode (its blocks of
    128 rows cover S = 64 in one tile) against the port's ``auto``."""
    args, kw = _inputs("attention", seed=2)
    want = jops.attention(*[jnp.asarray(a) for a in args], impl="interpret",
                          **kw)
    got = ops.attention(*_torch(args), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("impl,match", [("cuda", "CUDA tensor"),
                                        ("interpret", "no counterpart"),
                                        ("pallas", "must be one of")])
@pytest.mark.parametrize("name", NAMES)
def test_ops_refuse_impls_the_cpu_cannot_run(name, impl, match):
    args, kw = _inputs(name)
    with pytest.raises(ValueError, match=match):
        getattr(ops, name)(*_torch(args), impl=impl, **kw)
