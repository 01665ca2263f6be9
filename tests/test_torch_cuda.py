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
@pytest.mark.parametrize("case", [(2, 16, 8, 1000, 128, 0.0),
                                  (1, 8, 4, 1000, 256, 50.0)])
def test_cuda_flash_bwd_bf16_training_layout_launches_tensor_core_kernel(
        case):
    """A bf16 backward in the training layout ([B, S, H, d] transposed
    views, a ragged S) at qwen3's heads (d = 128) and at gemma2's (d = 256,
    softcap 50) launches ``flash_attention_bwd`` once on the tensor-core
    route (``csrc/flash_bwd_tc.cu``), copies no operand, is within
    ``chip_smoke.flash_bwd_bound`` of autograd of the plain version and
    gives the same bits twice."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    sys.path.insert(0, str(ROOT))
    try:
        smoke = importlib.import_module("chip_smoke")
    finally:
        sys.path.remove(str(ROOT))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    B, H, Hkv, S, d, cap = case
    q, k, v = smoke._attn_inputs(gen, B, H, Hkv, S, d, torch.bfloat16, dev)
    if cap > 0:     # scores ~ N(0, (c/2)^2): the cap bites
        q = q * (cap / 2)  # keeps q's strides
    dout = torch.randn((B, S, H, d), generator=gen, device=dev,
                       dtype=torch.bfloat16).transpose(1, 2)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=dev)
    o = flash_attention(q, k, v, softcap=cap, lse=lse)
    copies = flash_attention_bwd.copies
    reset_launch_counts()
    got = flash_attention_bwd(q, k, v, o, dout, lse, 0, cap)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts.get("flash_attention_bwd", 0) == 1
    assert counts.get("flash_attention_bwd/tc", 0) == 1
    assert flash_attention_bwd.copies == copies
    again = flash_attention_bwd(q, k, v, o, dout, lse, 0, cap)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = ref.flash_attention_backward_reference(q, k, v, dout, 0, cap)
    bound = smoke.flash_bwd_bound(q, k, v, o, dout, want, 0, cap)
    assert smoke.bwd_err(got, want, bound)[1] <= 1.0


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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_decode_lse_and_split_over_views(dtype):
    """``decode_attention``'s ``lse`` on both routes within
    ``chip_smoke.LSE_TOL`` of the plain version's (rows of length 0 -inf,
    lengths at the tile and chunk edges), the output bit for bit the
    call's without ``lse`` and its float32 output (``out_dtype``)
    rounded to q's dtype bit for bit that output; the cache cut into 8
    views at non-zero offsets, attended and combined through the lse,
    within ATTN_TOL of the whole call, with no operand copy
    (``chip_smoke.lse_check`` and ``split_check``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    sys.path.insert(0, str(ROOT))
    try:
        smoke = importlib.import_module("chip_smoke")
    finally:
        sys.path.remove(str(ROOT))
    from repro_torch.kernels.decode_attention import decode_attention
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(8)
    B, H, Hkv, S, d = 8, 16, 8, 4096, 128
    _, k, v = smoke._attn_inputs(gen, B, H, Hkv, S, d, dtype, dev)
    q = torch.randn((B, H, d), generator=gen, device=dev, dtype=dtype)
    lengths = torch.tensor(smoke.decode_edge_lengths(B, Hkv, S, d),
                           dtype=torch.int32, device=dev)
    for window, cap in ((0, 0.0), (1000, 30.0)):
        got = smoke.lse_check(q, k, v, lengths, window, cap, timed=False)
        assert got["ok"], got
        unrounded = decode_attention(q, k, v, lengths, window, cap,
                                     out_dtype=torch.float32)
        assert unrounded.dtype == torch.float32
        assert torch.equal(unrounded.to(dtype),
                           decode_attention(q, k, v, lengths, window, cap))
        split = smoke.split_check(q, k.transpose(1, 2), v.transpose(1, 2),
                                  S - 100, window, cap, 8)
        assert split["ok"], split


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
    on and off, GQA groups of 1 to 8, d 16 to 256, element by element
    within ``flash_bwd_bound`` (the forward's output and row lse checked
    too), every bf16 case on the tensor-core route; repeated rows, empty
    bags, NNZ 0, sum and mean, integer-valued inputs exactly; each case's
    planted faults fail it."""
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
    assert set(cases["flash_routes"]) == (
        {"bfloat16 tc"} if dtype == "bfloat16" else {"float32 tc32"})
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


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["gcn-cora", "pna", "egnn", "nequip"])
def test_cuda_gnn_loss_step_matches_cpu(arch):
    """One f32 ``gnn_loss`` step at full width and depth on the card
    against the CPU (``chip_smoke.gnn_loss_check``: GCN and PNA at
    full_graph_sm, EGNN and NequIP at the molecule shape, in several
    chunks; the loss and every gradient leaf within ``GRAD_TOL``, PNA's
    max and min on the card's subgradient; each planted fault outside),
    through the ``segment_sum_sorted`` kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the check compares it with the CPU")
    from repro_torch.kernels import reset_launch_counts
    sys.path.insert(0, str(ROOT))
    try:
        smoke = importlib.import_module("chip_smoke")
    finally:
        sys.path.remove(str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    reset_launch_counts()
    check = smoke.gnn_loss_check(smoke.gnn_config(arch, "full_graph_sm"), 0,
                                 torch.device("cuda"))
    assert check["ok"], check
    assert launch_counts()["segment_sum_sorted"] > 0


@pytest.mark.cuda
def test_cuda_segment_sum_gradient_is_the_gather():
    """``segment_sum_sorted`` under autograd on the card: the kernel's
    forward (one launch), the message gradient equal to the cotangent
    gathered by dst with zeros for dst outside [0, N), as on the CPU;
    ``out=`` raises under autograd."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.kernels.segment_mp import segment_sum_sorted
    rng = np.random.default_rng(4)
    n, E, D = 300, 5000, 75
    dst = np.sort(rng.integers(-3, n + 3, E)).astype(np.int32)
    msg = rng.standard_normal((E, D)).astype(np.float32)
    cot = rng.standard_normal((n, D)).astype(np.float32)
    grads = []
    for dev in ("cuda", "cpu"):
        m = torch.from_numpy(msg).to(dev).requires_grad_()
        reset_launch_counts()
        out = segment_sum_sorted(m, _t(dst).to(dev), n)
        assert launch_counts().get("segment_sum_sorted", 0) == \
            (dev == "cuda")
        grads.append(torch.autograd.grad(out, m, torch.from_numpy(cot).to(
            dev))[0].cpu())
        with pytest.raises(ValueError, match="out="):
            segment_sum_sorted(m, _t(dst).to(dev), n,
                               out=torch.empty((n, D), device=dev))
    assert torch.equal(grads[0], grads[1])


@pytest.mark.cuda
def test_cuda_meta_branches_match_the_card():
    """Each kernel wrapper on meta tensors (the dry run) returns the
    shapes and dtypes its launch returns on the card, forward and
    backward, and launches nothing; on the card each launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the comparison is with a launch")
    from repro_torch.kernels import meta_ops, reset_launch_counts, \
        reset_meta_ops
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.embedding_bag import EmbeddingBag
    from repro_torch.kernels.flash_attention import FlashAttention
    from repro_torch.kernels.segment_mp import segment_sum_sorted

    def calls(dev):
        gen = torch.Generator().manual_seed(5)

        def rnd(*shape, dtype=torch.bfloat16):
            return torch.randn(shape, generator=gen).to(dev, dtype)
        q = rnd(2, 8, 300, 256).requires_grad_()
        k, v = (rnd(2, 4, 300, 256).requires_grad_() for _ in range(2))
        o = FlashAttention.apply(q, k, v, 0, 50.0)
        out = [o, *torch.autograd.grad(o.float().sum(), (q, k, v))]
        lengths = torch.tensor([1, 300], dtype=torch.int32, device=dev)
        out.append(decode_attention(q[:, :, 0].detach(), k.detach(),
                                    v.detach(), lengths, 0, 50.0))
        msg = rnd(500, 75, dtype=torch.float32).requires_grad_()
        dst = torch.arange(500, dtype=torch.int32, device=dev) // 7
        s = segment_sum_sorted(msg, dst, 80)
        out += [s, torch.autograd.grad(s.sum(), msg)[0]]
        table = rnd(100, 32, dtype=torch.float32).requires_grad_()
        ids = (torch.arange(96, dtype=torch.int32, device=dev) % 100
               ).view(4, 6, 4)
        mask = torch.ones((4, 6, 4), device=dev)
        b = EmbeddingBag.apply(table, ids, mask, "mean")
        out += [b, torch.autograd.grad(b.sum(), table)[0]]
        return out

    reset_launch_counts()
    want = calls(torch.device("cuda"))
    torch.cuda.synchronize()
    launched = launch_counts()
    for name in ("flash_attention", "flash_attention_bwd",
                 "decode_attention", "segment_sum_sorted", "embedding_bag",
                 "embedding_bag_bwd"):
        assert launched.get(name, 0) >= 1, name
    reset_launch_counts()
    reset_meta_ops()
    got = calls(torch.device("meta"))
    assert launch_counts() == {}
    assert set(meta_ops()) == {"flash_attention", "flash_attention_bwd",
                               "decode_attention", "segment_sum_sorted",
                               "embedding_bag", "embedding_bag_bwd"}
    for g, w in zip(got, want):
        assert g.device.type == "meta"
        assert g.shape == w.shape and g.dtype == w.dtype


@pytest.mark.cuda
def test_cuda_compressed_psum_on_nccl():
    """``compressed_psum`` over a (1, 1) NCCL mesh on the card
    (``chip_smoke.psum_check``): equal bit for bit to the dequantized
    ``ef_compress`` and its residual, the residual left out unequal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: NCCL runs on the card")
    sys.path.insert(0, str(ROOT))
    try:
        smoke = importlib.import_module("chip_smoke")
    finally:
        sys.path.remove(str(ROOT))
    out = smoke.psum_check(0, torch.device("cuda"))
    assert out["backend"] == "nccl"
    assert out["exact"] and not out["planted_equal"]


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        return importlib.import_module("chip_smoke")
    finally:
        sys.path.remove(str(ROOT))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_norm_kernels_match_plain_versions(dtype):
    """``norm_rope`` and ``rms_norm_rows`` against the plain ``rms_norm``
    and ``apply_rope`` on ``chip_smoke.NORM_ROPE_CASES`` and
    ``NORM_ROW_CASES`` (qwen3's heads at B 1 x 32,768 and B 8 x 4,096,
    granite's rope-only d 64, gemma2's d 256, ragged token counts,
    broadcast and transposed tables, bf16 scales; rows of 1,024, 2,304
    and 8,192), within ``NORM_BAR``: in bf16 at least 99.9% of the
    elements bit-equal and none more than 2 ulps apart (at the element's
    or, after RoPE, its pair's magnitude), in float32 none more than 8.
    In bf16 the planted controls fail the bar; each wrapper refuses a
    gradient-requiring input."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    smoke = _chip_smoke()
    cases = smoke.check_norm_cases(torch.device("cuda"), (dtype,))
    assert cases[dtype]["min_equal"] >= smoke.NORM_BAR[dtype][0]
    assert cases[dtype]["max_ulps"] <= smoke.NORM_BAR[dtype][1]
    if dtype == "bfloat16":
        assert set(cases["controls"]) == {"norm_rope", "rms_norm_rows"}


@pytest.mark.cuda
def test_cuda_qwen3_prefill_launches_norm_kernels(monkeypatch):
    """One qwen3-0.6b ``lm_prefill`` (full width and depth, bf16, B 2 x
    256) launches ``norm_rope`` once a layer (q and k together) and
    ``rms_norm_rows`` twice a layer and once for the final norm: 28 and
    57. Its logits agree with the plain route's (both norm kernels turned
    away) within ``chip_smoke.CONSISTENCY_TOL``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.configs.registry import get_spec
    from repro_torch.kernels import norm, reset_launch_counts
    from repro_torch.models.transformer import init_lm_params, lm_prefill
    smoke = _chip_smoke()
    cfg = get_spec("qwen3-0.6b").config
    dev = torch.device("cuda")
    params = init_lm_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            torch.bfloat16, dev)
    tokens = torch.randint(0, cfg.vocab, (2, 256), device=dev)
    reset_launch_counts()
    got = lm_prefill(cfg, params, tokens)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts.get("norm_rope", 0) == cfg.n_layers == 28
    assert counts.get("rms_norm_rows", 0) == 2 * cfg.n_layers + 1 == 57
    monkeypatch.setattr(norm, "takes_rows", lambda *a: False)
    monkeypatch.setattr(norm, "takes_norm_rope", lambda *a: False)
    reset_launch_counts()
    want = lm_prefill(cfg, params, tokens)
    torch.cuda.synchronize()
    assert "norm_rope" not in launch_counts()
    assert "rms_norm_rows" not in launch_counts()
    scale = max(1.0, float(want.float().abs().max()))
    assert float((got.float() - want.float()).abs().max()) <= \
        smoke.CONSISTENCY_TOL * scale


@pytest.mark.cuda
def test_cuda_gradient_inputs_take_the_plain_norms():
    """A gradient-requiring input under autograd keeps the plain version
    (no launch, its gradient flows), and the wrapper refuses it; under
    ``torch.no_grad`` the same call launches ``rms_norm_rows``. A 2-layer
    qwen3-0.6b ``lm_loss`` with its backward launches neither kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    import dataclasses

    from repro_torch.configs.registry import get_spec
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.kernels.norm import rms_norm_rows
    from repro_torch.models.common import rms_norm
    from repro_torch.models.transformer import init_lm_params, lm_loss
    dev = torch.device("cuda")
    x = torch.randn((4, 1024), device=dev, requires_grad=True)
    scale = torch.ones(1024, device=dev, requires_grad=True)
    reset_launch_counts()
    rms_norm(x, scale).sum().backward()
    assert x.grad is not None and scale.grad is not None
    assert "rms_norm_rows" not in launch_counts()
    with pytest.raises(ValueError, match="gradient"):
        rms_norm_rows(x, scale)
    with torch.no_grad():
        rms_norm(x, scale)
    assert launch_counts().get("rms_norm_rows", 0) == 1
    cfg = dataclasses.replace(get_spec("qwen3-0.6b").config, n_layers=2)
    params = init_lm_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            torch.float32, dev)
    for leaf in [params["final_norm"], *params["layers"].values()]:
        leaf.requires_grad_()
    tokens = torch.randint(0, cfg.vocab, (2, 64), device=dev)
    reset_launch_counts()
    loss, _ = lm_loss(cfg, params, tokens)
    loss.backward()
    torch.cuda.synchronize()
    assert "norm_rope" not in launch_counts()
    assert "rms_norm_rows" not in launch_counts()
