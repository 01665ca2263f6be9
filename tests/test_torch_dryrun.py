"""The port's dry run (``repro_torch.launch.dryrun``) and the kernel
wrappers' meta branches: each wrapper on ``meta`` tensors returns the
shapes and dtypes the CPU plain route returns, forward and backward,
launches nothing and tallies the kernel's operations; ``PeakMemory``
counts new storages while they live; a reduced LM prefill cell's FLOPs
equal a closed-form count of its products exactly; ``argument_bytes`` is
the meta arguments' bytes; one full-size cell a family dry-runs ``ok``;
``--list`` prints the reference's cells and skips in its format. On the
reference's production meshes (``MetaMesh``, rank 0's pieces): an LM
decode cell's and the recsys train cell's per-rank argument bytes and
their all-gather bytes equal a closed form of the layouts.
"""

import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

from repro.configs import registry as jreg  # noqa: E402

from repro_torch import tree  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.kernels import (launch_counts, meta_ops,  # noqa: E402
                                 reset_launch_counts, reset_meta_ops)
from repro_torch.kernels.decode_attention import decode_attention  # noqa: E402
from repro_torch.kernels.embedding_bag import EmbeddingBag  # noqa: E402
from repro_torch.kernels.embedding_bag import embedding_bag  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    FlashAttention, causal_pairs, flash_attention)
from repro_torch.kernels.segment_mp import segment_sum_sorted  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.train import reduce_config  # noqa: E402
from repro_torch.models import gnn  # noqa: E402

META = torch.device("meta")


def _both(fn, make):
    """``fn`` on CPU inputs from ``make(device)`` and on meta ones: the
    outputs (a tensor or a tuple), the meta tally and the launches."""
    want = fn(*make(torch.device("cpu")))
    reset_meta_ops()
    reset_launch_counts()
    got = fn(*make(META))
    return want, got, meta_ops(), launch_counts()


def _same_layout(got, want):
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.device == META
        assert g.shape == w.shape and g.dtype == w.dtype


def _attn_inputs(dev, dtype, B=2, H=4, Hkv=2, S=37, d=16, grad=False):
    gen = torch.Generator().manual_seed(0)
    out = []
    for h in (H, Hkv, Hkv):
        t = torch.randn((B, h, S, d), generator=gen, dtype=dtype)
        t = t.to(dev).requires_grad_(grad)
        out.append(t)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 5])
def test_flash_attention_meta_matches_cpu(dtype, window):
    def run(q, k, v):
        lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
        return flash_attention(q, k, v, window=window, lse=lse), lse
    want, got, ops, launches = _both(
        run, lambda dev: _attn_inputs(dev, dtype))
    _same_layout(got, want)
    assert ops == {"flash_attention": 4 * 16 * 2 * 4
                   * causal_pairs(37, window)}
    assert launches == {}


@pytest.mark.parametrize("dtype,d", [(torch.float32, 16),
                                     (torch.bfloat16, 16),
                                     (torch.bfloat16, 256)])
def test_flash_attention_backward_meta_matches_cpu(dtype, d):
    """Through ``FlashAttention``: forward and the backward's dq, dk,
    dv (the tensor-core routes' workspace: bf16 at d = 16 and 256, the
    three-piece float32 route at d = 16)."""
    def run(q, k, v):
        o = FlashAttention.apply(q, k, v, 3, 0.0)
        return (o, *torch.autograd.grad(o.float().sum(), (q, k, v)))
    want, got, ops, launches = _both(
        run, lambda dev: _attn_inputs(dev, dtype, S=19, d=d, grad=True))
    _same_layout(got, want)
    fwd = 4 * d * 2 * 4 * causal_pairs(19, 3)
    assert ops == {"flash_attention": fwd,
                   "flash_attention_bwd": fwd * 5 // 2}
    assert launches == {}


@pytest.mark.parametrize("dtype,window", [(torch.bfloat16, 0),
                                          (torch.float32, 0),
                                          (torch.bfloat16, 6)])
def test_decode_attention_meta_matches_cpu(dtype, window):
    def make(dev):
        q, k, v = _attn_inputs(dev, dtype, S=600)
        lengths = torch.tensor([5, 600], dtype=torch.int32, device=dev)
        return q[:, :, 0], k, v, lengths
    want, got, ops, launches = _both(
        lambda q, k, v, n: decode_attention(q, k, v, n, window=window),
        make)
    _same_layout(got, want)
    assert ops == {"decode_attention": 4 * 2 * 4 * 16
                   * (window if window else 600)}
    assert launches == {}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_segment_sum_meta_matches_cpu(dtype):
    """Forward, and the gradient through ``SegmentSum``."""
    def make(dev):
        gen = torch.Generator().manual_seed(1)
        msg = torch.randn((50, 7), generator=gen, dtype=dtype)
        dst = torch.sort(torch.randint(0, 9, (50,), generator=gen,
                                       dtype=torch.int32)).values
        return msg.to(dev).requires_grad_(), dst.to(dev)

    def run(msg, dst):
        out = segment_sum_sorted(msg, dst, 9)
        return out, torch.autograd.grad(out.float().sum(), msg)[0]
    want, got, ops, launches = _both(run, make)
    _same_layout(got, want)
    assert ops == {"segment_sum_sorted": 50 * 7}
    assert launches == {}


@pytest.mark.parametrize("combiner", ["mean", "sum"])
def test_embedding_bag_meta_matches_cpu(combiner):
    """Forward, and the table's gradient through ``EmbeddingBag``."""
    def make(dev):
        gen = torch.Generator().manual_seed(2)
        table = torch.randn((30, 8), generator=gen)
        ids = torch.randint(0, 30, (5, 3, 4), generator=gen,
                            dtype=torch.int32)
        mask = (torch.rand((5, 3, 4), generator=gen) > 0.3).float()
        return table.to(dev).requires_grad_(), ids.to(dev), mask.to(dev)

    def run(table, ids, mask):
        out = EmbeddingBag.apply(table, ids, mask, combiner)
        plain = embedding_bag(table.detach(), ids, mask, combiner)
        return out, plain, torch.autograd.grad(out.sum(), table)[0]
    want, got, ops, launches = _both(run, make)
    _same_layout(got, want)
    assert ops == {"embedding_bag": 2 * 2 * 5 * 3 * 4 * 8,
                   "embedding_bag_bwd": 2 * 5 * 3 * 4 * 8}
    assert launches == {}


def test_edge_chunks_meta_is_uniform():
    dst = torch.empty((10_000,), dtype=torch.int32, device=META)
    chunks = gnn.edge_chunks(dst, 333, cap=3_000)
    assert len(chunks) == 4
    assert chunks[0].e0 == 0 and chunks[-1].e1 == 10_000
    assert chunks[0].lo == 0 and chunks[-1].hi == 333
    for a, b in zip(chunks, chunks[1:]):
        assert a.e1 == b.e0 and a.hi == b.lo
    assert all(c.e1 - c.e0 <= 3_000 for c in chunks)
    assert gnn.edge_chunks(dst, 333) == [gnn.EdgeChunk(0, 10_000, 0, 333)]


def test_peak_memory_counts_live_storages():
    base = torch.empty((4,), device=META)
    with dryrun.PeakMemory(dryrun.storages(base)) as mem:
        a = torch.empty((100,), device=META)             # 400 bytes
        view = a[10:]
        b = torch.empty((50,), dtype=torch.float64, device=META)  # 400
        del a                                            # the view holds it
        assert mem.now == 800
        del view
        c = torch.empty((10,), device=META)              # 40
        base.add_(1.0)                                   # no new storage
        del b, c
    assert mem.peak == 800
    assert mem.now == 0


def _matmul_flops(cfg, B: int, S: int) -> int:
    """The products of a dense LM prefill, in closed form: per layer q, k,
    v, o and the three FFN GEMMs (2 m n k each), the logits' GEMM, and the
    attention kernel's 4 d for each visited (query, key) pair."""
    T, d, dh = B * S, cfg.d_model, cfg.d_head
    H, Kh, F = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    per_layer = (2 * T * d * H * dh + 2 * 2 * T * d * Kh * dh
                 + 2 * T * H * dh * d + 3 * 2 * T * d * F)
    attn = sum(4 * dh * B * H * causal_pairs(S, int(w))
               for w in cfg.layer_windows())
    return cfg.n_layers * per_layer + 2 * T * d * cfg.padded_vocab + attn


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "gemma2-2b"])
def test_reduced_prefill_flops_closed_form(arch):
    spec = registry.get_spec(arch)
    spec = dataclasses.replace(spec, config=reduce_config(spec))
    cell = registry.build_cell(spec, "prefill_32k")
    got = dryrun.analyze(cell)
    sh = registry.LM_SHAPES["prefill_32k"]
    assert got["flops"] == _matmul_flops(spec.config, sh["batch"],
                                         sh["seq"])
    assert got["argument_bytes"] == sum(
        t.nbytes for t in tree.leaves(cell.abstract_args))
    # the logits are the output: [B, S, V_padded] in the params' bf16
    assert got["output_bytes"] == (sh["batch"] * sh["seq"]
                                   * spec.config.padded_vocab * 2)
    assert got["peak_bytes"] >= got["argument_bytes"] + got["output_bytes"]


@pytest.mark.parametrize("arch,shape", [("qwen3-0.6b", "prefill_32k"),
                                        ("gcn-cora", "ogb_products"),
                                        ("wide-deep", "serve_bulk")])
def test_full_size_cell_dry_runs(arch, shape, tmp_path):
    rec = dryrun.run_cell(arch, shape, "single", str(tmp_path),
                          log=lambda *_: None)
    assert rec["ok"], rec.get("traceback")
    cell = registry.build_cell(registry.get_spec(arch), shape)
    assert rec["argument_bytes"] == sum(
        t.nbytes for t in tree.leaves(cell.abstract_args))
    assert rec["mesh_shape"] == [1, 1]
    assert rec["description"] == cell.description
    assert rec["peak_bytes"] == (rec["argument_bytes"] + rec["output_bytes"]
                                 + rec["temp_bytes"])
    assert rec["flops"] > 0
    on_disk = json.loads((tmp_path / f"{arch}__{shape}__single.json")
                         .read_text())
    assert on_disk == rec
    if shape == "ogb_products":
        assert rec["chunk_plan"] == "uniform"
        assert rec["flops_by"]["segment_sum_sorted"] > 0


def _piece_bytes(tree_, specs: dict, sizes: dict) -> int:
    """The bytes of rank 0's pieces: each leaf's over the ranks of the
    axes its layout names."""
    total = 0
    for path, t in tree.flatten(tree_):
        n = 1
        for axes in specs.get(tree.path_key(path)) or ():
            for a in (axes,) if isinstance(axes, str) else axes or ():
                n *= sizes[a]
        total += t.nbytes // n
    return total


def test_meta_mesh_dry_run_lm_decode(tmp_path):
    """qwen3-0.6b ``decode_32k`` on 16 x 16: per-rank argument bytes (the
    params' pieces, the cache's [L, B/16, S/16, Kh, dh], the tokens') and
    all-gather bytes (each layer's seven weights gathered over ``data``,
    q over ``model``, and the embedding twice: lookup and head)."""
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import AxisRules
    rec = dryrun.run_cell("qwen3-0.6b", "decode_32k", "16x16", str(tmp_path),
                          log=lambda *_: None)
    assert rec["ok"], rec.get("traceback")
    assert rec["mesh_shape"] == [16, 16]
    cfg = registry.get_spec("qwen3-0.6b").config
    sizes = {"data": 16, "model": 16}
    rules = AxisRules()
    params = tf.init_lm_params(cfg, torch.Generator(), device=META)
    cache = tf.init_kv_cache(cfg, 128, 32768, device=META)
    assert rec["argument_bytes"] == (
        _piece_bytes(params, tf.param_shardings(cfg, rules), sizes)
        + _piece_bytes(cache, tf.cache_shardings(cfg, rules), sizes)
        + 128 // 16 * 4)
    d, H, Kh, dh, F = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                       cfg.d_head, cfg.d_ff)
    per_layer = (d * H * dh // 16 + 2 * d * Kh * dh + H * dh // 16 * d
                 + 2 * d * F // 16 + F // 16 * d + 8 * H * dh) * 2
    gathers = cfg.n_layers * per_layer + 2 * cfg.padded_vocab // 16 * d * 2
    coll = rec["collectives"]
    assert coll["bytes_by_kind"]["all-gather"] == gathers
    assert coll["ops_by_kind"]["all-gather"] == 8 * cfg.n_layers + 2
    assert coll["total_bytes"] == sum(coll["bytes_by_kind"].values())


def test_meta_mesh_dry_run_recsys_train(tmp_path):
    """Wide&Deep ``train_batch`` on 16 x 16: the tables' rows over
    ``model`` and the batch over ``data`` in the per-rank argument bytes
    (params, the AdamW moments as the params, the batch), no all-gather
    (the candidates are not scored in training) and all-reduces for the
    bags, the loss and the gradients."""
    from repro_torch.models import recsys as rs
    from repro_torch.models.common import AxisRules
    from repro_torch.optim.adamw import adamw_init
    rec = dryrun.run_cell("wide-deep", "train_batch", "16x16",
                          str(tmp_path), log=lambda *_: None)
    assert rec["ok"], rec.get("traceback")
    cfg = registry.get_spec("wide-deep").config
    sizes = {"data": 16, "model": 16}
    params = rs.init_recsys_params(cfg, torch.Generator(), device=META)
    specs = rs.recsys_param_shardings(cfg, AxisRules())
    B = 65536 // 16
    batch = 2 * B * cfg.n_sparse * cfg.nnz_per_field * 4 + B * (
        cfg.n_dense + 1) * 4
    assert rec["argument_bytes"] == (
        _piece_bytes(params, specs, sizes)
        + _piece_bytes(adamw_init(params)["m"], specs, sizes) * 2 + 4
        + batch)
    coll = rec["collectives"]
    assert "all-gather" not in coll["bytes_by_kind"]
    assert coll["ops_by_kind"]["all-reduce"] > 0


@pytest.mark.parametrize("kind", ["all_gather", "psum_scatter", "psum",
                                  "pmax", "all_reduce_"])
def test_meta_mesh_collective_refuses_a_real_tensor(kind):
    """A collective on a ``MetaMesh`` takes meta tensors only: a CPU tensor
    raises instead of coming back uninitialized or unreduced, and the
    tally is left as it was; the same call on meta counts one op."""
    from repro_torch.launch import collectives as col
    from repro_torch.launch.mesh import MetaMesh
    mesh = MetaMesh((2, 2), ("data", "model"))
    fn = getattr(col, kind)
    col.reset_collective_counts()
    with pytest.raises(ValueError, match="meta tensors"):
        fn(torch.ones(4, 3), mesh, "model")
    assert col.collective_counts()["total_bytes"] == 0
    out = fn(torch.ones(4, 3, device=META), mesh, "model")
    assert out.is_meta
    assert sum(col.collective_counts()["ops_by_kind"].values()) == 1


def test_failing_cell_is_a_record(tmp_path):
    rec = dryrun.run_cell("gcn-cora", "train_4k", "single", str(tmp_path),
                          log=lambda *_: None)
    assert rec["ok"] is False
    assert "KeyError" in rec["error"] and rec["traceback"]


def test_list_prints_reference_cells(capsys):
    dryrun.main(["--list"])
    lines = capsys.readouterr().out.splitlines()
    want = ([f"{a:26s} {s}" for a, s in jreg.all_cells()]
            + [f"{a:26s} {s}  SKIPPED: {why}"
               for a, s, why in jreg.skipped_cells()])
    assert lines == want
    assert len(lines) == 40


@pytest.fixture()
def smoke():
    import importlib
    import sys
    from pathlib import Path
    root = str(Path(__file__).resolve().parents[1])
    sys.path.insert(0, root)
    try:
        return importlib.import_module("chip_smoke")
    finally:
        sys.path.remove(root)


@pytest.mark.parametrize("arch", ["gcn-cora", "pna", "egnn", "nequip"])
def test_chip_smoke_minibatch_cell_on_cpu(arch, smoke, monkeypatch):
    """``chip_smoke``'s minibatch_lg cell rehearsed on the CPU at a small
    shape of the same kind: the sampler's subgraph padded to the cell's
    sizes, the batch's leaves equal to the cell's abstract ones, three
    steps of ``cell.fn``, every loss and gradient norm finite and the
    loss falling. The padding is left out of the loss: moving the padding
    nodes' features or coordinates leaves it bit for bit as it was; EGNN
    and NequIP have no self-loop."""
    monkeypatch.setitem(registry.GNN_SHAPES, "minibatch_lg", dict(
        kind="sampled", n_nodes=1000, n_edges=900, d_feat=24,
        batch_nodes=16, fanout=(5, 4)))
    monkeypatch.setattr(smoke, "REDDIT_NODES", 3000)
    monkeypatch.setattr(smoke, "REDDIT_DEGREE", 20)
    sub = smoke.minibatch(smoke.reddit_like(0), 0)
    assert len(sub["nodes"]) == 1024 and len(sub["edge_index"]) == 1024
    dst = sub["edge_index"][:, 1]
    assert (dst[1:] >= dst[:-1]).all()          # the sampler's order
    run = smoke.gnn_cell(arch, sub, 0, "cpu")
    assert run["ok"], run
    assert run["launches"] == {}                # the plain route on the CPU
    cfg, sh = registry.gnn_cell_config(registry.get_spec(arch).config,
                                       "minibatch_lg")
    params = gnn.gnn_init(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = smoke.minibatch_batch(cfg, sub, sh["d_feat"], 0, "cpu")
    key = "feat" if "feat" in batch else "coords"
    pad = torch.from_numpy(sub["node_mask"] == 0)[:, None]
    moved = {**batch, key: batch[key] * (1 + pad)}
    assert torch.equal(gnn.gnn_loss(cfg, params, moved)[0],
                       gnn.gnn_loss(cfg, params, batch)[0])
    if key == "coords":
        ei = batch["edge_index"]
        assert not (ei[:, 0] == ei[:, 1]).any()


def test_chip_smoke_cut_cell_dry_run(smoke):
    """The cells phase's cut of an LM cell: the tokens' batch cut, the
    rest of the cell as built; its dry run counts the cut batch."""
    cell = smoke.cut_cell("qwen3-1.7b", "prefill_32k", 1)
    assert tuple(cell.abstract_args[1].shape) == (1, 32768)
    train = smoke.cut_cell("gemma2-2b", "train_4k", 4)
    assert tuple(train.abstract_args[2].shape) == (4, 1, 4096)
    full = dryrun.run_cell("qwen3-1.7b", "prefill_32k",
                           log=lambda *_: None)
    cut = smoke._dry_cell("qwen3-1.7b", "prefill_32k", 1)
    assert cut["output_bytes"] * 32 == full["output_bytes"]
    assert cut["argument_bytes"] < full["argument_bytes"]
