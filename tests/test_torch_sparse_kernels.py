"""The port's recsys and GNN kernels: the plain torch versions against the
JAX package's Pallas kernels (interpret mode, as ``tests/test_kernels.py``
runs them), on the same inputs drawn from a numpy seed, and the wrappers'
CPU dispatch and argument checks. Tolerances: float32 2e-5 (both sum in
float32, in other orders); bfloat16 ``test_kernels.py``'s 2e-2 (the
Pallas embedding bag multiplies in bfloat16, the port in float32). The
CUDA kernels are held against the plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.embedding_bag import embedding_bag_pallas  # noqa: E402
from repro.kernels.segment_mp import \
    segment_sum_sorted as j_segment_sum_sorted  # noqa: E402

from repro_torch.kernels import launch_counts, ref  # noqa: E402
from repro_torch.kernels.embedding_bag import embedding_bag  # noqa: E402
from repro_torch.kernels.segment_mp import segment_sum_sorted  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _pair(a, dtype):
    """The same values as a JAX and a torch array of ``dtype``."""
    jd, td = DTYPES[dtype]
    return (jnp.asarray(a, jnp.float32).astype(jd),
            torch.from_numpy(np.asarray(a, np.float32)).to(td))


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


def _segment_inputs(E, N, D, seed, extra=()):
    """msg [E, D] normal; dst [E] sorted, in [0, N) plus ``extra``."""
    rng = np.random.default_rng(seed)
    msg = rng.normal(size=(E + len(extra), D)).astype(np.float32)
    dst = np.sort(np.concatenate([rng.integers(0, N, E),
                                  np.asarray(extra, np.int64)])
                  ).astype(np.int32)
    return msg, dst


# (E, N, D) of test_kernels.py's grid, plus the GCN path's narrow rows
@pytest.mark.parametrize("E,N,D", [(100, 40, 16), (1000, 64, 32),
                                   (257, 130, 8), (64, 256, 128),
                                   (700, 90, 1), (300, 50, 7)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_segment_sum_plain_matches_pallas(E, N, D, dtype):
    msg, dst = _segment_inputs(E, N, D, seed=E + D)
    jmsg, tmsg = _pair(msg, dtype)
    want = j_segment_sum_sorted(jmsg, jnp.asarray(dst), N, bn=32, bc=64,
                                interpret=True)
    got = ref.segment_sum_sorted_reference(tmsg, torch.from_numpy(dst), N)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (N, D)
    _close(got, want, dtype)


@pytest.mark.parametrize("case", ["hot_nodes", "dst_out_of_range", "empty"])
def test_segment_sum_plain_matches_pallas_at_edges(case):
    """Nodes with no edges around one hot node (test_kernels.py's case),
    destinations outside [0, n_nodes) dropped by both, and E = 0."""
    N, D = 64, 16
    if case == "hot_nodes":
        msg = np.ones((512, D), np.float32)
        dst = np.sort(np.where(np.arange(512) < 256, 0, 63)).astype(np.int32)
    elif case == "dst_out_of_range":
        msg, dst = _segment_inputs(300, N, D, seed=5,
                                   extra=(-3, -1, N, N, N + 1, 10 ** 6))
    else:
        msg, dst = np.zeros((0, D), np.float32), np.zeros(0, np.int32)
    got = ref.segment_sum_sorted_reference(torch.from_numpy(msg),
                                           torch.from_numpy(dst), N)
    if len(dst):
        want = j_segment_sum_sorted(jnp.asarray(msg), jnp.asarray(dst), N,
                                    bn=16, bc=128, interpret=True)
    else:   # the Pallas wrapper needs one edge chunk; the sum is zeros
        want = np.zeros((N, D), np.float32)
    _close(got, want, "float32")
    if case == "hot_nodes":
        assert float(got[0, 0]) == 256.0 and float(got[63, 0]) == 256.0
        assert float(got[1:63].abs().max()) == 0.0


def _bag_inputs(B, F, NNZ, V, D, seed):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(V, D)).astype(np.float32)
    ids = rng.integers(0, V, (B, F, NNZ)).astype(np.int32)
    mask = (rng.random((B, F, NNZ)) < 0.7).astype(np.float32)
    mask[:, :, 0] = 1.0
    return table, ids, mask


@pytest.mark.parametrize("B,F,NNZ,V,D", [(4, 3, 4, 100, 16),
                                         (2, 8, 2, 1000, 32),
                                         (8, 1, 6, 50, 64),
                                         (3, 40, 4, 500, 32)])
@pytest.mark.parametrize("combiner", ["mean", "sum"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embedding_bag_plain_matches_pallas(B, F, NNZ, V, D, combiner,
                                            dtype):
    table, ids, mask = _bag_inputs(B, F, NNZ, V, D, seed=B * V + D)
    jt, tt = _pair(table, dtype)
    want = embedding_bag_pallas(jt, jnp.asarray(ids), jnp.asarray(mask),
                                combiner=combiner, interpret=True)
    got = ref.embedding_bag_reference(tt, torch.from_numpy(ids),
                                      torch.from_numpy(mask), combiner)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (B, F, D)
    _close(got, want, dtype)


def test_embedding_bag_plain_matches_pallas_on_weighted_and_empty_bags():
    """Mask entries are weights (0, 0.5, 1, 2), not booleans; a bag whose
    entries are all masked gives zeros under both combiners."""
    table, ids, _ = _bag_inputs(5, 3, 4, 60, 8, seed=9)
    mask = np.random.default_rng(9).choice([0.0, 0.5, 1.0, 2.0],
                                           (5, 3, 4)).astype(np.float32)
    mask[0, 1] = 0.0
    for combiner in ("mean", "sum"):
        want = embedding_bag_pallas(jnp.asarray(table), jnp.asarray(ids),
                                    jnp.asarray(mask), combiner=combiner,
                                    interpret=True)
        got = ref.embedding_bag_reference(torch.from_numpy(table),
                                          torch.from_numpy(ids),
                                          torch.from_numpy(mask), combiner)
        _close(got, want, "float32")
        assert float(got[0, 1].abs().max()) == 0.0


def test_cpu_tensors_take_the_plain_version_without_launching():
    before = launch_counts()
    msg, dst = _segment_inputs(50, 10, 4, seed=1)
    out = torch.full((10, 4), 7.0)
    got = segment_sum_sorted(torch.from_numpy(msg), torch.from_numpy(dst),
                             10, out=out)
    assert got is out
    torch.testing.assert_close(out, ref.segment_sum_sorted_reference(
        torch.from_numpy(msg), torch.from_numpy(dst), 10))
    table, ids, mask = _bag_inputs(2, 3, 4, 20, 8, seed=2)
    args = (torch.from_numpy(table), torch.from_numpy(ids),
            torch.from_numpy(mask))
    for combiner in ("mean", "sum"):
        torch.testing.assert_close(
            embedding_bag(*args, combiner=combiner),
            ref.embedding_bag_reference(*args, combiner))
    assert launch_counts() == before


_M = torch.zeros((6, 4))
_D = torch.zeros(6, dtype=torch.int32)
_T = torch.zeros((10, 4))
_I = torch.zeros((2, 3, 4), dtype=torch.int32)


@pytest.mark.parametrize("call", [
    lambda: segment_sum_sorted(_M, _D.long(), 3),            # int64 dst
    lambda: segment_sum_sorted(_M, _D[:5], 3),               # E mismatch
    lambda: segment_sum_sorted(_M[0], _D, 3),                # 1-D msg
    lambda: segment_sum_sorted(_M, _D, -1),                  # n_nodes < 0
    lambda: segment_sum_sorted(_M, _D, 3, out=torch.zeros((3, 5))),
    lambda: embedding_bag(_T, _I.long(), _I.float()),        # int64 ids
    lambda: embedding_bag(_T, _I, _I[:1].float()),           # mask shape
    lambda: embedding_bag(_T[0], _I, _I.float()),            # 1-D table
    lambda: embedding_bag(_T, _I, _I.float(), combiner="max"),
])
def test_wrappers_check_arguments(call):
    with pytest.raises((TypeError, ValueError)):
        call()
