"""The port's CUDA kernels against their plain torch versions, on the card.

Needs torch built with CUDA and a card; it needs no JAX, so it runs on the
GPU machine too (``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_cuda.py``). Elsewhere the tests skip themselves. The
query kernels' comparisons are exact (all results are integers); the
attention kernels' are within the per-element tolerance that
``chip_smoke.py`` states per dtype; the sparse kernels' are exact on
integer-valued inputs and within ``chip_smoke.sum_err``'s bound on normal
ones."""

import importlib
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import launch_counts, ref  # noqa: E402
from repro_torch.kernels.join_probe import (probe_sorted,  # noqa: E402
                                            scan_probe)
from repro_torch.kernels.triple_scan import (triple_scan,  # noqa: E402
                                             triple_scan_many)

ROOT = Path(__file__).resolve().parents[1]
PATTERNS = [(-1, 3, -1), (7, -1, -1), (-1, -1, -1), (1, 2, 3), (-1, 4, 9)]
# -1 padding and probes outside the key range
EDGE_PROBES = np.asarray([-1, -1, -10, 0, 59, 60, 10 ** 6, 2 ** 31 - 1],
                         np.int32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions():
    """Each CUDA kernel equals its plain version on the card, edge cases
    included, and counts its launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.kernels import reset_launch_counts
    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    reset_launch_counts()
    for T in (1, 257, 5000):
        tri = _t(rng.integers(0, 40, (T, 3))).to(dev)
        for K in (0, 1, 300, 1000):
            keys = _t(np.sort(rng.integers(0, 40, K)) if K != 1000
                      else np.full(K, 7)).to(dev)     # one long run
            for pat in PATTERNS:
                _eq(triple_scan(tri, pat).cpu(),
                    ref.triple_scan_reference(tri, *pat).cpu())
                for col in (0, 2):
                    for g, w in zip(scan_probe(tri, pat, keys, col),
                                    ref.scan_probe_reference(tri, *pat, keys,
                                                             col)):
                        _eq(g.cpu(), w.cpu())
            probes = _t(np.concatenate([rng.integers(-5, 50, 200),
                                        EDGE_PROBES])).to(dev)
            for g, w in zip(probe_sorted(keys, probes),
                            ref.probe_sorted_reference(keys, probes)):
                _eq(g.cpu(), w.cpu())
        pats = _t(rng.integers(-1, 40, (1100, 3))).to(dev)
        _eq(triple_scan_many(tri, pats).cpu(),
            ref.triple_scan_many_reference(tri, pats).cpu())
    torch.cuda.synchronize()
    counts = launch_counts()
    assert all(counts[k] > 0 for k in ("triple_scan", "triple_scan_many",
                                       "probe_sorted_many", "scan_probe"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_attention_kernels_match_plain_versions(dtype):
    """``flash_attention`` and ``decode_attention`` equal their plain
    versions on the card within the dtype's per-element tolerance, on the
    cases of ``chip_smoke.check_attention_cases``: ragged S, GQA groups of
    1, 2 and 8, every compiled head dim, windows and softcaps, lengths at
    the kernels' tile and chunk edges and 0, strided views."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.kernels import reset_launch_counts
    sys.path.insert(0, str(ROOT))
    try:
        smoke = importlib.import_module("chip_smoke")
    finally:
        sys.path.remove(str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    reset_launch_counts()
    cases = smoke.check_attention_cases(torch.device("cuda"), (dtype,))
    assert cases[dtype]["max_ratio"] <= 1.0
    counts = launch_counts()
    assert counts["flash_attention"] + counts["decode_attention"] == \
        cases["cases"]
    assert counts["flash_attention"] > 0 and counts["decode_attention"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_sparse_kernels_match_plain_versions(dtype):
    """``segment_sum_sorted`` and ``embedding_bag`` equal their plain
    versions on the card on the cases of ``chip_smoke.check_sparse_cases``:
    an empty graph and E = 0, nodes without edges, one hot node, dst
    outside [0, n_nodes), ragged E, D of 1 to 300; empty batches, NNZ of 0
    to 37, weighted and all-masked bags; integer-valued inputs exactly."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.kernels import reset_launch_counts
    sys.path.insert(0, str(ROOT))
    try:
        smoke = importlib.import_module("chip_smoke")
    finally:
        sys.path.remove(str(ROOT))
    reset_launch_counts()
    cases = smoke.check_sparse_cases(torch.device("cuda"), (dtype,))
    assert cases[dtype]["max_ratio"] <= 1.0
    counts = launch_counts()
    assert counts["segment_sum_sorted"] > 0 and counts["embedding_bag"] > 0


@pytest.mark.cuda
def test_cuda_flash_bf16_serving_layout_launches_tensor_core_kernel():
    """A bf16 call in the model's layout ([B, S, H, d] transposed views,
    qwen3 heads) makes no operand copy, launches ``flash_attention`` once
    (the tensor-core kernel of ``csrc/flash_tc.cu``) and agrees with the
    plain version within the bf16 flash route's check."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.kernels.flash_attention import flash_attention
    sys.path.insert(0, str(ROOT))
    try:
        smoke = importlib.import_module("chip_smoke")
    finally:
        sys.path.remove(str(ROOT))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    q, k, v = smoke._attn_inputs(gen, 1, 16, 8, 1000, 128, torch.bfloat16,
                                 dev)
    copies = flash_attention.copies
    reset_launch_counts()
    out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert launch_counts().get("flash_attention", 0) == 1
    assert flash_attention.copies == copies
    want = ref.mha_reference(q, k, v)
    assert smoke.attn_err(out, want, smoke.split_bound(q, k, v))[1] <= 1.0


@pytest.mark.cuda
def test_cuda_decode_bf16_serving_layout_launches_ring_kernel():
    """A bf16 call in the model's layout ([B, S, Hkv, d] caches as
    transposed views, qwen3 heads, lengths at the kernel's tile and chunk
    edges and 0) makes no cache copy, launches ``decode_attention`` once
    (the kernel of ``csrc/decode_tc.cu``, built into its own library) and
    agrees with the plain version within ATTN_TOL; a second call gives the
    same output, so the kernel left its ticket counters at 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.kernels import _build, reset_launch_counts
    from repro_torch.kernels.decode_attention import decode_attention
    sys.path.insert(0, str(ROOT))
    try:
        smoke = importlib.import_module("chip_smoke")
    finally:
        sys.path.remove(str(ROOT))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    B, H, Hkv, S, d = 8, 16, 8, 3000, 128
    _, k, v = smoke._attn_inputs(gen, B, H, Hkv, S, d, torch.bfloat16, dev)
    q = torch.randn((B, H, d), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    lengths = torch.tensor(smoke.decode_edge_lengths(B, Hkv, S, d),
                           dtype=torch.int32, device=dev)
    copies = decode_attention.copies
    reset_launch_counts()
    out = decode_attention(q, k, v, lengths)
    torch.cuda.synchronize()
    assert launch_counts().get("decode_attention", 0) == 1
    assert decode_attention.copies == copies
    assert _build.library_path("decode").exists()
    want = ref.decode_reference(q, k, v, lengths)
    assert smoke.attn_err(out, want)[1] <= 1.0
    assert not out[lengths.tolist().index(0)].any()
    assert torch.equal(decode_attention(q, k, v, lengths), out)


@pytest.mark.cuda
def test_cuda_qad_solve_both_routes_match_plain_version():
    """``qad_solve`` against its plain version on the card on
    ``chip_smoke.QAD_SEEDED``: the register route (one warp a child at 8
    rows, two warps at 33 and 64) and the generic route (K = 18), each
    launch counted under its route; D within ``QAD_TOL`` plus the one-ulp
    spread, f and lb within ``QAD_TOL`` relative."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.kernels import reset_launch_counts
    sys.path.insert(0, str(ROOT))
    try:
        smoke = importlib.import_module("chip_smoke")
    finally:
        sys.path.remove(str(ROOT))
    reset_launch_counts()
    rows = [smoke.qad_compare(smoke.qad_instance(N, K, B, seed),
                              torch.device("cuda"))
            for N, K, B, seed in smoke.QAD_SEEDED]
    assert all(r["ok"] for r in rows), rows
    counts = launch_counts()
    for route in smoke.QAD_ROUTES:
        assert counts[f"qad_solve/{route}"] == \
            sum(r["route"] == route for r in rows) > 0
    assert counts["qad_solve"] == len(rows)


@pytest.mark.cuda
def test_cuda_moe_routing_with_drops_matches_cpu():
    """``_moe_core`` of one granite-moe layer at full width on the card
    against the CPU, with capacity factor 0.5 (``chip_smoke.
    moe_drop_check``): the same expert ids, keep mask and kept count on
    both, equal to the count recomputed from the ids; a capacity off by
    one on the card fails the check."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the MoE check compares it with "
                    "the CPU")
    from repro_torch.configs.registry import get_spec
    sys.path.insert(0, str(ROOT))
    try:
        smoke = importlib.import_module("chip_smoke")
    finally:
        sys.path.remove(str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_spec(smoke.MOE_ARCH).config
    dev = torch.device("cuda")
    drops = smoke.moe_drop_check(cfg, 0, dev)
    assert drops["ok"], drops
    assert not smoke.moe_drop_check(cfg, 0, dev, planted=True)["ok"]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["pna", "egnn", "nequip"])
def test_cuda_gnn_zoo_matches_cpu(arch):
    """PNA at full_graph_sm, EGNN and NequIP at the molecule shape, full
    width, on the card against the CPU (``chip_smoke.gnn_model_check``:
    every output within ``SPARSE_MODEL_TOL``, its TF32, dropped-edge and,
    for PNA, clamped-max controls above it); EGNN and NequIP also under a
    rotation, the planted permutation failing it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the GNN check compares it with "
                    "the CPU")
    sys.path.insert(0, str(ROOT))
    try:
        smoke = importlib.import_module("chip_smoke")
    finally:
        sys.path.remove(str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = smoke.gnn_config(arch, "full_graph_sm")
    check = smoke.gnn_model_check(cfg, 0, dev)
    assert check["ok"], check
    assert launch_counts()["segment_sum_sorted"] > 0
    if cfg.model != "pna":
        assert smoke.rotation_check(cfg, 0, dev)["ok"]
        assert not smoke.rotation_check(cfg, 0, dev, planted=True)["ok"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_backward_kernels_match_plain_versions(dtype):
    """``flash_attention_bwd`` against autograd of the plain attention and
    ``embedding_bag_bwd`` against ``zeros`` + ``index_add_`` on the card,
    on ``chip_smoke.check_backward_cases``: ragged S, windows and softcaps
    on and off, GQA groups of 1, 2 and 4, d 16 to 256, element by element
    within ``flash_bwd_bound`` (the forward's output and row lse checked
    too); repeated rows, empty bags, NNZ 0, sum and mean, integer-valued
    inputs exactly; each case's planted faults fail it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.kernels import reset_launch_counts
    sys.path.insert(0, str(ROOT))
    try:
        smoke = importlib.import_module("chip_smoke")
    finally:
        sys.path.remove(str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    reset_launch_counts()
    cases = smoke.check_backward_cases(torch.device("cuda"), (dtype,))
    assert cases[f"flash_attention_bwd {dtype}"]["max_ratio"] <= 1.0
    assert cases[f"flash_attention_bwd {dtype}"]["min_planted_ratio"] > 1.0
    counts = launch_counts()
    assert counts["flash_attention_bwd"] > 0
    assert counts["embedding_bag_bwd"] > 0


@pytest.mark.cuda
def test_cuda_lm_loss_step_matches_cpu_and_checkpoints():
    """One f32 ``lm_loss`` step of qwen3-0.6b at 2 layers of full width on
    the card against the CPU (``chip_smoke.lm_loss_check``: the loss and
    every gradient leaf within ``GRAD_TOL``, the TF32 control outside);
    then that model and its AdamW state saved and restored on the card
    (``chip_smoke.checkpoint_check``: bit-exact, a stale step differs, a
    wrong shape raises)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the check compares it with the CPU")
    import dataclasses

    from repro_torch.configs.registry import get_spec
    from repro_torch.models.transformer import init_lm_params
    from repro_torch.optim.adamw import adamw_init
    sys.path.insert(0, str(ROOT))
    try:
        smoke = importlib.import_module("chip_smoke")
    finally:
        sys.path.remove(str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_spec(smoke.LM_ARCH).config,
                              n_layers=smoke.GRAD_CHECK_LAYERS)
    check = smoke.lm_loss_check(cfg, 0, dev)
    assert check["ok"], check
    assert launch_counts()["flash_attention_bwd"] > 0
    params = init_lm_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            torch.float32, dev)
    ck = smoke.checkpoint_check({"params": params,
                                 "opt": adamw_init(params)}, dev)
    assert ck["ok"], ck
