"""The LM and recsys weights' layouts on a mesh: the port's FSDP + TP
routes against the reference's ``jit`` with the cells' ``in_shardings``.

The port runs in gloo worlds of spawned processes (``FileStore``): two
ranks on meshes (2, 1) and (1, 2) of ``("data", "model")``, four on
(2, 2); each rank gets its pieces through ``convert.local_shard`` of the
reference's layouts (``param_shardings``, ``cache_shardings``,
``recsys_param_shardings``). The reference runs once in a subprocess with
four host devices (``XLA_FLAGS=--xla_force_host_platform_device_count=4``),
each function under ``jax.jit(..., in_shardings=...)`` of its own
layouts on the same meshes. Weights are the reference's (float32),
carried to the port with ``convert.*_params_from_reference``; inputs are
made from seeds with numpy. Tiny configs: qwen-like (qk norms, GQA with
two ranks sharing a kv head at tp = 2), gemma-like (three heads, so
``n_heads % tp != 0`` takes the replicated-attention route; a window,
softcaps, sandwich norms, tied embeddings) and phi-like (untied
``lm_head``, MoE with FSDP experts and router). Checked:

- ``lm_forward``'s logits, the rank's vocabulary shard, within 2e-5 *
  max(1, max |logit|); ``lm_loss`` within 1e-5 relative; each gradient
  piece (reduced as the train step reduces it) within 1e-4 * max |leaf|
  of ``local_shard`` of the reference's gradient;
- 8 decode steps on a random cache on the ``decode_32k`` layout (batch
  over ``data``, sequence over ``model``) on (1, 2) and (2, 2), and under
  ``seq_shard`` (sequence over both) on (2, 2), the window spanning two
  shards, within 2e-5 * max(1, max |logit|);
- Wide&Deep's scores, loss and gradients on the row-sharded tables
  within 1e-6 relative; the retrieval top-k's indices (distinct scores)
  equal;
- one AdamW step of an LM cell and of the recsys cell built on the mesh
  (``build_cell``, shapes cut small) against the cell without one, the
  moments and params within 1e-6 relative; ``global_norm`` with sharded
  leaves within 1e-6 relative;
- a checkpoint saved from the pieces on one mesh (whole leaves on disk)
  and restored as pieces on another, exact.

Planted faults, each at least 50 times its tolerance: the row-parallel
``psum`` left out, the cross-entropy's sum of exponentials not
``psum``med, the decode combine without the lse weights, the new K/V
written on a shard that does not own ``pos``, the bag's out-of-range ids
left unmasked, an FSDP leaf's gradient all-reduced over ``data`` again,
and ``global_norm`` without the ``psum`` of the sharded squares.

Also, without a mesh: ``ref.decode_reference``'s lse against the
log-sum-exp of the reference's ``cache_attention`` logits, and the
split of a decode over slices combined through the lse equal to the
whole call.
"""

import contextlib
import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import torch.distributed as dist  # noqa: E402

from repro_torch import tree  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.convert import (lm_params_from_reference,  # noqa: E402
                                 local_shard, recsys_params_from_reference)
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch import collectives as col  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import recsys as prs  # noqa: E402
from repro_torch.models import transformer as ptf  # noqa: E402
from repro_torch.models.common import AxisRules  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime import train_loop  # noqa: E402
from repro_torch.runtime.train_loop import value_and_grad  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
AXES = ("data", "model")
PAIR = ((2, 1), (1, 2))          # the world of two's meshes
QUAD = (2, 2)
LM = {
    "qwen": dict(name="qwen", n_layers=2, d_model=32, n_heads=4,
                 n_kv_heads=1, d_head=8, d_ff=32, vocab=211, qk_norm=True),
    "gemma": dict(name="gemma", n_layers=2, d_model=32, n_heads=3,
                  n_kv_heads=1, d_head=16, d_ff=32, vocab=211,
                  attn_pattern="local_global", window=5, attn_softcap=50.0,
                  final_softcap=30.0, sandwich_norm=True, scale_embed=True,
                  act="gelu"),
    "phi": dict(name="phi", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
                d_head=8, d_ff=16, vocab=211, n_experts=4, top_k=2,
                capacity_factor=2.0, tie_embeddings=False),
}
TOKENS = (4, 12)
CACHE = 16                      # positions of the decode caches
DECODE = (4, 12)                # the steps' positions [4, 12): 8 steps
DECODE_BATCH = 2


def _decodes(name: str, shape: tuple) -> tuple:
    """The decode layouts run on ``shape``: the decode_32k layout (batch
    over ``data``, sequence over ``model``) on (1, 2) and (2, 2), and
    ``seq_shard`` (the sequence over both) on (2, 2) but for the MoE (its
    expert-parallel route shards the batch of one over ``data``, which the
    reference's ``shard_map`` refuses; no MoE arch has a long_500k cell).
    (2, 1) cuts no sequence."""
    if shape == QUAD:
        return (False,) if LM[name].get("n_experts") else (False, True)
    return (False,) if shape[1] > 1 else ()


RECSYS = dict(name="rs", n_sparse=4, vocab_per_field=50, embed_dim=8,
              n_dense=3, nnz_per_field=3, mlp_dims=(32, 16),
              n_candidates=64, retrieval_dim=16)
RECSYS_BATCH = 8
TOPK = 5
LOGIT_TOL = 2e-5
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
RECSYS_RTOL = 1e-6
STEP_RTOL = 1e-6
FAULT_FACTOR = 50
# the cells' shapes, cut to CPU size
CELL_LM = ("qwen3-0.6b", "train_4k", dict(kind="train", seq=12, batch=4))
CELL_RECSYS = ("wide-deep", "train_batch", dict(kind="train", batch=8))


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for these small CPU ops (the suite's workers
    share the CPU)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# inputs, made once here and read by both sides
# ---------------------------------------------------------------------------

def _make_inputs() -> dict:
    import jax.numpy as jnp
    from repro.models import recsys as jrs
    from repro.models import transformer as jtf
    rng = np.random.default_rng(5)
    lm = {}
    for name, kw in LM.items():
        cfg = jtf.LMConfig(**kw)
        Kh, dh = cfg.n_kv_heads, cfg.d_head
        cache = rng.normal(size=(cfg.n_layers, DECODE_BATCH, CACHE, Kh, dh))
        lm[name] = {
            "params": jax.tree.map(np.asarray, jtf.init_lm_params(
                cfg, jax.random.PRNGKey(1), dtype=jnp.float32)),
            "tokens": rng.integers(0, cfg.vocab, TOKENS).astype(np.int32),
            "steps": rng.integers(0, cfg.vocab, (DECODE_BATCH, DECODE[1]
                                                 - DECODE[0])).astype(
                                                     np.int32),
            "k": cache.astype(np.float32),
            "v": rng.normal(size=cache.shape).astype(np.float32)}
    rcfg = jrs.RecsysConfig(**RECSYS)
    B, F, Z = RECSYS_BATCH, RECSYS["n_sparse"], RECSYS["nnz_per_field"]
    rec = {"params": jax.tree.map(np.asarray, jrs.init_recsys_params(
               rcfg, jax.random.PRNGKey(2))),
           "batch": {"ids": rng.integers(0, RECSYS["vocab_per_field"],
                                         (B, F, Z)).astype(np.int32),
                     "id_mask": (rng.random((B, F, Z)) < 0.7).astype(
                         np.float32),
                     "dense": rng.normal(size=(B, 3)).astype(np.float32),
                     "labels": (rng.random(B) < 0.5).astype(np.float32)}}
    return {"lm": lm, "recsys": rec}


_INPUTS = {}


def _inputs() -> dict:
    if not _INPUTS:
        _INPUTS.update(_make_inputs())
    return _INPUTS


# ---------------------------------------------------------------------------
# the reference, in a subprocess with four host devices
# ---------------------------------------------------------------------------

def _reference(inputs_path: str, out_path: str) -> None:
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.models import recsys as jrs
    from repro.models import transformer as jtf
    from repro.models.common import AxisRules as JRules
    with open(inputs_path, "rb") as f:
        inp = pickle.load(f)
    out = {}

    def named(mesh, t):
        return jax.tree.map(lambda s: NamedSharding(mesh, s), t,
                            is_leaf=lambda x: isinstance(x, P))

    def np_tree(t):
        return jax.tree.map(np.asarray, t)

    for shape in PAIR + (QUAD,):
        n = shape[0] * shape[1]
        mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape), AXES)
        rules = JRules.for_mesh(mesh)
        repl = NamedSharding(mesh, P())
        bspec = NamedSharding(mesh, P(rules.batch))
        with mesh:
            for name, kw in LM.items():
                cfg = jtf.LMConfig(**kw)
                d = inp["lm"][name]
                p_sh = named(mesh, jtf.param_shardings(cfg, rules))
                if shape != QUAD:
                    def f(p, t):
                        logits = jtf.lm_forward(cfg, p, t, rules)[0]
                        (loss, _), g = jax.value_and_grad(
                            lambda pp: jtf.lm_loss(cfg, pp, t, rules),
                            has_aux=True)(p)
                        return logits, loss, g
                    logits, loss, g = jax.jit(f, in_shardings=(
                        p_sh, bspec))(d["params"], d["tokens"])
                    out["lm", name, shape] = (np.asarray(logits),
                                              float(loss), np_tree(g))
                for seq_shard in _decodes(name, shape):
                    B = 1 if seq_shard else DECODE_BATCH
                    c_sh = named(mesh, jtf.cache_shardings(cfg, rules,
                                                           seq_shard))
                    t_sh = repl if seq_shard else NamedSharding(
                        mesh, P(rules.batch, None))
                    step = jax.jit(
                        lambda p, c, t, pos: jtf.lm_decode_step(
                            cfg, p, c, t, pos, rules),
                        in_shardings=(p_sh, c_sh, t_sh, repl))
                    cache = {"k": d["k"][:, :B], "v": d["v"][:, :B]}
                    logits = []
                    for i, pos in enumerate(range(*DECODE)):
                        lg, cache = step(d["params"], cache,
                                         d["steps"][:B, i:i + 1],
                                         jnp.int32(pos))
                        logits.append(np.asarray(lg))
                    out["decode", name, shape, seq_shard] = logits
            if shape == QUAD:
                continue
            rcfg = jrs.RecsysConfig(**RECSYS)
            rp = inp["recsys"]["params"]
            batch = inp["recsys"]["batch"]
            r_sh = named(mesh, jrs.recsys_param_shardings(rcfg, rules))
            b_sh = {k: NamedSharding(mesh, P(rules.batch))
                    for k in batch}

            def rf(p, b):
                scores = jrs.recsys_score(rcfg, p, b, rules)
                (loss, _), g = jax.value_and_grad(
                    lambda pp: jrs.recsys_loss(rcfg, pp, b, rules),
                    has_aux=True)(p)
                top = jrs.retrieval_topk(rcfg, p, b, rules, k=TOPK)
                return scores, loss, g, top
            scores, loss, g, (tv, ti) = jax.jit(rf, in_shardings=(
                r_sh, b_sh))(rp, batch)
            out["recsys", shape] = (np.asarray(scores), float(loss),
                                    np_tree(g), np.asarray(tv),
                                    np.asarray(ti))
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


# ---------------------------------------------------------------------------
# the port, in gloo worlds
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def patched(module, name: str, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def _numpy(ts) -> list:
    return [t.detach().numpy().copy() for t in ts]


def _reduced(grads, specs: dict, rules) -> list:
    """The gradient pieces as the train step reduces them: each over the
    batch axes its layout does not shard it over."""
    out = []
    for path, g in tree.flatten(grads):
        g = g.clone()
        axes = train_loop.reduce_axes(rules, specs.get(tree.path_key(path)))
        if axes:
            col.all_reduce_(g, rules.mesh, axes)
        out.append(g)
    return out


def _lm_setup(name, inp, mesh, rules):
    cfg = ptf.LMConfig(**LM[name])
    full = lm_params_from_reference(inp["lm"][name]["params"], "cpu",
                                    torch.float32)
    specs = ptf.param_shardings(cfg, rules)
    return cfg, full, specs, local_shard(full, specs, mesh)


def _rows(t: torch.Tensor, mesh, rules) -> torch.Tensor:
    return local_shard({"t": t}, {"t": (rules.batch,)}, mesh)["t"]


def _without_tp_sum(fn):
    """Planted fault: ``fn`` (a row-parallel product) without its ``psum``
    over ``tp``."""
    def faulty(*a, **k):
        with patched(ptf, "_tp_sum", lambda x, r: x):
            return fn(*a, **k)
    return faulty


def _nll_sum_exp_unsummed(logits, labels, rules):
    """Planted fault: the vocabulary-parallel cross-entropy with the sum
    of exponentials left on the rank's shard."""
    n = logits.shape[-1]
    m = col.pmax(logits.max(dim=-1).values, rules.mesh, rules.tp)
    total = torch.exp(logits - m[:, None]).sum(dim=-1)
    local = labels - col.axis_index(rules.mesh, rules.tp) * n
    mine = (local >= 0) & (local < n)
    picked = logits.gather(-1, local.clamp(0, n - 1)[:, None])[:, 0]
    picked = col.psum(picked * mine, rules.mesh, rules.tp)
    return torch.log(total) + m - picked


def _combine_unweighted(out, lse, pmax, psum, dtype):
    """Planted fault: the slices' outputs averaged without the lse
    weights."""
    return (psum(out) / psum(torch.ones_like(lse))[..., None]).to(dtype)


def _lm_rank(name, inp, mesh, rules) -> dict:
    cfg, full, specs, params = _lm_setup(name, inp, mesh, rules)
    tokens = torch.from_numpy(inp["lm"][name]["tokens"])
    local = _rows(tokens, mesh, rules)

    def grads():
        loss, _, g = value_and_grad(
            lambda p, b: ptf.lm_loss(cfg, p, b, rules), params, local)
        return float(loss), _numpy(_reduced(g, specs, rules))

    res = {"paths": [tree.path_key(p) for p, _ in tree.flatten(params)]}
    res["logits"] = _numpy([ptf.lm_forward(cfg, params, local, rules)[0]])[0]
    res["loss"], res["grads"] = grads()
    with patched(ptf, "_attn_out", _without_tp_sum(ptf._attn_out)), \
            patched(ptf, "dense_ffn", _without_tp_sum(ptf.dense_ffn)):
        res["fault_row_sum"] = _numpy([ptf.lm_forward(cfg, params, local,
                                                      rules)[0]])[0]
    with patched(ptf, "_vocab_parallel_nll", _nll_sum_exp_unsummed):
        res["fault_sum_exp"] = float(ptf.lm_loss(cfg, params, local,
                                                 rules)[0])
    with patched(train_loop, "reduce_axes", lambda r, s: r.batch):
        res["fault_fsdp_twice"] = grads()[1]
    return res


def _decode_rank(name, inp, mesh, rules, seq_shard: bool,
                 faults: bool = False) -> dict:
    cfg, _, _, params = _lm_setup(name, inp, mesh, rules)
    d = inp["lm"][name]
    B = 1 if seq_shard else DECODE_BATCH
    cache = {k: torch.from_numpy(d[k][:, :B].copy()) for k in ("k", "v")}
    cache = local_shard(cache, ptf.cache_shardings(cfg, rules, seq_shard),
                        mesh)
    steps = torch.from_numpy(d["steps"][:B])
    if not seq_shard:
        steps = _rows(steps, mesh, rules)

    def run(c):
        return [_numpy([ptf.lm_decode_step(
            cfg, params, c, steps[:, i:i + 1], pos, rules, seq_shard)[0]])[0]
            for i, pos in enumerate(range(*DECODE))]

    res = {"logits": run(tree.tree_map(torch.clone, cache))}
    if faults:
        with patched(ptf, "lse_combine", _combine_unweighted):
            res["fault_combine"] = run(tree.tree_map(torch.clone, cache))
        with patched(ptf, "owner_slot",
                     lambda pos, base, held: (pos - base) % held):
            res["fault_owner"] = run(tree.tree_map(torch.clone, cache))
    return res


def _recsys_setup(inp, mesh, rules):
    cfg = prs.RecsysConfig(**RECSYS)
    full = recsys_params_from_reference(inp["recsys"]["params"], "cpu")
    specs = prs.recsys_param_shardings(cfg, rules)
    batch = {k: torch.from_numpy(v) for k, v in
             inp["recsys"]["batch"].items()}
    local = local_shard(batch, {k: (rules.batch,) for k in batch}, mesh)
    return cfg, full, specs, local_shard(full, specs, mesh), local


def _recsys_rank(inp, mesh, rules) -> dict:
    cfg, full, specs, params, local = _recsys_setup(inp, mesh, rules)

    def run():
        loss, _, g = value_and_grad(
            lambda p, b: prs.recsys_loss(cfg, p, b, rules), params, local)
        return float(loss), _numpy(_reduced(g, specs, rules))

    res = {"scores": _numpy([prs.recsys_score(cfg, params, local,
                                              rules)])[0]}
    res["loss"], res["grads"] = run()
    vals, idx = prs.retrieval_topk(cfg, params, local, k=TOPK, rules=rules)
    res["top_values"], res["top_indices"] = _numpy([vals, idx])

    def unmasked(rows, mask, r0, n):
        return (rows - r0).clamp(0, n - 1), mask
    with patched(prs, "local_rows", unmasked):
        res["fault_unmasked"] = _numpy([prs.recsys_score(cfg, params, local,
                                                         rules)])[0]
    res["paths"] = [tree.path_key(p) for p, _ in tree.flatten(params)]
    return res


def _cut_cell(arch, shape, cut, mesh, cfg):
    """``arch``'s cell at ``shape`` cut to CPU size: a tiny config and a
    small shape."""
    spec = dataclasses.replace(registry.get_spec(arch), config=cfg,
                               microbatches=1)
    table = (registry.LM_SHAPES if spec.family == "lm"
             else registry.RECSYS_SHAPES)
    with patched(registry, "LM_SHAPES" if spec.family == "lm"
                 else "RECSYS_SHAPES", {**table, shape: cut}):
        return registry.build_cell(spec, shape, mesh)


def _cell_step(cell, params, batch, mesh=None) -> dict:
    """One AdamW step of ``cell`` on ``params`` (its pieces on a mesh)."""
    if mesh is not None:
        params = local_shard(params, cell.in_specs[0], mesh)
        batch = local_shard(batch, cell.in_specs[2], mesh)
    p, opt, metrics = cell.fn(params, adamw.adamw_init(params), batch)
    return {"params": _numpy(tree.leaves(p)),
            "m": _numpy(tree.leaves(opt["m"])),
            "grad_norm": float(metrics["grad_norm"]),
            "loss": float(metrics["loss"])}


def _cells_rank(inp, mesh) -> dict:
    """The qwen-like LM cell and the recsys cell, one AdamW step each on
    the mesh and without one (the whole batch), and ``global_norm`` of the
    LM cell's local gradient pieces."""
    rules = AxisRules.for_mesh(mesh)
    out = {}
    arch, shape, cut = CELL_LM
    cfg = ptf.LMConfig(**LM["qwen"])
    full = lm_params_from_reference(inp["lm"]["qwen"]["params"], "cpu",
                                    torch.float32)
    tokens = torch.from_numpy(inp["lm"]["qwen"]["tokens"])
    cells = {m: _cut_cell(arch, shape, cut, m, cfg) for m in (mesh, None)}
    out["lm_mesh"] = _cell_step(cells[mesh], tree.tree_map(torch.clone, full),
                                tokens, mesh)
    out["lm_one"] = _cell_step(cells[None], tree.tree_map(torch.clone, full),
                               tokens)
    with patched(train_loop, "reduce_axes", lambda r, s: r.batch):
        out["lm_fault"] = _cell_step(cells[mesh], tree.tree_map(
            torch.clone, full), tokens, mesh)
    out["lm_specs"] = cells[mesh].in_specs[0]
    # global_norm of sharded pieces against the whole gradient's
    specs = cells[mesh].in_specs[0]
    pieces = local_shard(full, specs, mesh)
    local = local_shard(tokens, cells[mesh].in_specs[2], mesh)
    _, _, g = value_and_grad(lambda p, b: ptf.lm_loss(cfg, p, b, rules),
                             pieces, local)
    g = tree.unflatten(g, _reduced(g, specs, rules))
    out["norm"] = float(adamw.global_norm(g, specs, mesh))
    with patched(adamw, "spec_axes", lambda s: set()):
        out["norm_fault"] = float(adamw.global_norm(g, specs, mesh))
    _, _, whole = value_and_grad(lambda p, b: ptf.lm_loss(cfg, p, b),
                                 full, tokens)
    out["norm_one"] = float(adamw.global_norm(whole))

    arch, shape, cut = CELL_RECSYS
    rcfg = prs.RecsysConfig(**RECSYS)
    rfull = recsys_params_from_reference(inp["recsys"]["params"], "cpu")
    batch = {k: torch.from_numpy(v) for k, v in
             inp["recsys"]["batch"].items()}
    cells = {m: _cut_cell(arch, shape, cut, m, rcfg) for m in (mesh, None)}
    out["rs_mesh"] = _cell_step(cells[mesh], tree.tree_map(
        torch.clone, rfull), batch, mesh)
    out["rs_one"] = _cell_step(cells[None], tree.tree_map(
        torch.clone, rfull), batch)
    out["rs_specs"] = cells[mesh].in_specs[0]
    return out


def _checkpoint_rank(inp, ckpt_dir: str) -> dict:
    """qwen's params and AdamW state saved from their pieces on (1, 2) and
    restored as pieces on (2, 1) (the elastic re-mesh): each restored
    piece against ``local_shard`` of the whole, and the file's leaves
    against the whole."""
    from repro_torch.runtime.checkpoint import (restore_checkpoint,
                                                save_checkpoint)
    cfg = ptf.LMConfig(**LM["qwen"])
    full = lm_params_from_reference(inp["lm"]["qwen"]["params"], "cpu",
                                    torch.float32)
    whole = {"params": full, "opt": adamw.adamw_init(full)}
    whole["opt"]["m"] = tree.tree_map(lambda t: t + 1, full)
    meshes = [tmesh.make_compat_mesh(s, AXES, "cpu") for s in PAIR]
    p_specs = ptf.param_shardings(cfg, AxisRules.for_mesh(meshes[0]))
    specs = {f"params/{k}": v for k, v in p_specs.items()}
    specs.update({f"opt/{k}": v for k, v in
                  registry._opt_specs(p_specs).items()})
    save_checkpoint(ckpt_dir, 3, local_shard(whole, specs, meshes[1]),
                    specs=specs, mesh=meshes[1])
    like = local_shard(whole, specs, meshes[0])
    step, got = restore_checkpoint(ckpt_dir, tree.tree_map(torch.zeros_like,
                                                          like),
                                   specs=specs, mesh=meshes[0])
    arrays = np.load(os.path.join(ckpt_dir, "step_00000003", "arrays.npz"))
    return {"step": step,
            "pieces_equal": all(torch.equal(a, b) for a, b in zip(
                tree.leaves(got), tree.leaves(like))),
            "file_equal": all(np.array_equal(arrays[tree.path_key(p)],
                                             t.numpy())
                              for p, t in tree.flatten(whole))}


def _port_rank(rank: int, world: int, store: str, inputs_path: str,
               out: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        with open(inputs_path, "rb") as f:
            inp = pickle.load(f)
        res = {}
        shapes = PAIR if world == 2 else (QUAD,)
        for shape in shapes:
            mesh = tmesh.make_compat_mesh(shape, AXES, "cpu")
            rules = AxisRules.for_mesh(mesh)
            for name in LM:
                if shape != QUAD:
                    res["lm", name, shape] = _lm_rank(name, inp, mesh, rules)
                for seq_shard in _decodes(name, shape):
                    res["decode", name, shape, seq_shard] = _decode_rank(
                        name, inp, mesh, rules, seq_shard,
                        faults=name == "gemma")
            if shape != QUAD:
                res["recsys", shape] = _recsys_rank(inp, mesh, rules)
            res["cells", shape] = _cells_rank(inp, mesh)
        if world == 2:
            res["checkpoint"] = _checkpoint_rank(inp, f"{out}.ckpt")
        with open(f"{out}.{world}.{rank}", "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def _spawn_world(world: int, tmp: Path, inputs: Path) -> None:
    torch.multiprocessing.spawn(
        _port_rank, args=(world, str(tmp / f"store{world}"), str(inputs),
                          str(tmp / "port")), nprocs=world, join=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's outputs, {(world, rank): the port's}): the
    reference's subprocess runs beside the port's world of two, then its
    world of four."""
    tmp = tmp_path_factory.mktemp("mesh_layouts")
    inputs = tmp / "inputs.pkl"
    with open(inputs, "wb") as f:
        pickle.dump(_inputs(), f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), str(ROOT / "tests"),
                    os.environ.get("PYTHONPATH", "")]))
    code = ("import sys, test_torch_mesh_layouts as t; "
            "t._reference(sys.argv[1], sys.argv[2])")
    ref_proc = subprocess.Popen([sys.executable, "-c", code, str(inputs),
                                 str(tmp / "ref.pkl")], env=env,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT)
    try:     # one world at a time: the suite's workers share the CPU
        _spawn_world(2, tmp, inputs)
        _spawn_world(4, tmp, inputs)
    finally:
        log = ref_proc.communicate(timeout=600)[0].decode(errors="replace")
    assert ref_proc.returncode == 0, log[-4000:]
    with open(tmp / "ref.pkl", "rb") as f:
        want = pickle.load(f)
    got = {}
    for world in (2, 4):
        for r in range(world):
            with open(tmp / f"port.{world}.{r}", "rb") as f:
                got[world, r] = pickle.load(f)
    return want, got


class _Rank:
    """The coordinates of one rank of a mesh, for cutting the reference's
    outputs as that rank holds them."""

    def __init__(self, shape, rank, names=AXES):
        self.shape, self.rank, self.mesh_dim_names = shape, rank, names

    def get_local_rank(self, axis):
        coords = np.unravel_index(self.rank, self.shape)
        return int(coords[self.mesh_dim_names.index(axis)])

    def size(self):
        return int(np.prod(self.shape))


def _piece(a: np.ndarray, spec, shape, rank) -> np.ndarray:
    return local_shard({"a": torch.from_numpy(np.asarray(a))},
                       {"a": spec}, _Rank(shape, rank))["a"].numpy()


def _ranks(shape):
    world = shape[0] * shape[1]
    return [(world, r) for r in range(world)]


def _grad_ratio(got: list, want: list, tol: float) -> float:
    """The largest error of a leaf over tol * max |leaf|."""
    worst = 0.0
    for g, w in zip(got, want):
        assert g.shape == w.shape
        err = float(np.abs(g - w).max()) if w.size else 0.0
        limit = tol * float(np.abs(w).max()) if w.size else 0.0
        worst = max(worst, err / limit if limit else
                    (0.0 if err == 0 else np.inf))
    return worst


def _logit_ratio(got, want) -> float:
    return float(np.abs(got - want).max()) / (
        LOGIT_TOL * max(1.0, float(np.abs(want).max())))


def _want_grads(res, want_tree, specs, shape, rank) -> list:
    flat = {tree.path_key(p): w for p, w in tree.flatten(want_tree)}
    return [_piece(flat[p], specs.get(p), shape, rank)
            for p in res["paths"]]


# ---------------------------------------------------------------------------
# the LM: forward, loss, gradients, decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", PAIR)
@pytest.mark.parametrize("name", list(LM))
def test_lm_forward_loss_and_grads_match_reference(runs, name, shape):
    want, got = runs
    wl, wloss, wg = want["lm", name, shape]
    cfg = ptf.LMConfig(**LM[name])
    specs = ptf.param_shardings(cfg, AxisRules.for_mesh(_Rank(shape, 0)))
    for world, r in _ranks(shape):
        res = got[world, r]["lm", name, shape]
        rules = AxisRules.for_mesh(_Rank(shape, r))
        logits = _piece(wl, (rules.batch, None, rules.tp), shape, r)
        assert _logit_ratio(res["logits"], logits) <= 1.0, (name, shape)
        assert abs(res["loss"] - wloss) <= LOSS_RTOL * abs(wloss)
        wants = _want_grads(res, wg, specs, shape, r)
        assert _grad_ratio(res["grads"], wants, GRAD_TOL) <= 1.0, (name,
                                                                  shape)


@pytest.mark.parametrize("name,shape,seq_shard", [
    (name, shape, seq_shard) for name in LM for shape in PAIR + (QUAD,)
    for seq_shard in _decodes(name, shape)])
def test_lm_decode_matches_reference(runs, name, shape, seq_shard):
    """8 steps from a random cache: on the decode_32k layout the sequence
    is cut over ``model``, under ``seq_shard`` over both axes; gemma's
    window (5) spans two shards of 8 or 4 positions."""
    want, got = runs
    rules0 = AxisRules.for_mesh(_Rank(shape, 0))
    lead = None if seq_shard else rules0.batch
    for world, r in _ranks(shape):
        res = got[world, r]["decode", name, shape, seq_shard]
        for step, (g, w) in enumerate(zip(res["logits"],
                                          want["decode", name, shape,
                                               seq_shard])):
            w = _piece(w, (lead, None, rules0.tp), shape, r)
            assert _logit_ratio(g, w) <= 1.0, (name, shape, seq_shard, step)


# ---------------------------------------------------------------------------
# Wide&Deep
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", PAIR)
def test_recsys_scores_loss_and_grads_match_reference(runs, shape):
    want, got = runs
    ws, wloss, wg, _, _ = want["recsys", shape]
    cfg = prs.RecsysConfig(**RECSYS)
    specs = prs.recsys_param_shardings(cfg, AxisRules.for_mesh(
        _Rank(shape, 0)))
    for world, r in _ranks(shape):
        res = got[world, r]["recsys", shape]
        rules = AxisRules.for_mesh(_Rank(shape, r))
        np.testing.assert_allclose(res["scores"],
                                   _piece(ws, (rules.batch,), shape, r),
                                   rtol=RECSYS_RTOL)
        assert abs(res["loss"] - wloss) <= RECSYS_RTOL * abs(wloss)
        wants = _want_grads(res, wg, specs, shape, r)
        assert _grad_ratio(res["grads"], wants, RECSYS_RTOL) <= 1.0, shape


@pytest.mark.parametrize("shape", PAIR)
def test_retrieval_topk_indices_match_reference(runs, shape):
    want, got = runs
    _, _, _, wv, wi = want["recsys", shape]
    for world, r in _ranks(shape):
        res = got[world, r]["recsys", shape]
        rules = AxisRules.for_mesh(_Rank(shape, r))
        wvals = _piece(wv, (rules.batch,), shape, r)
        # distinct scores: no tie decides the order
        assert all(len(set(row.tolist())) == len(row) for row in wvals)
        np.testing.assert_array_equal(res["top_indices"],
                                      _piece(wi, (rules.batch,), shape, r))
        np.testing.assert_allclose(res["top_values"], wvals,
                                   rtol=RECSYS_RTOL)


def test_merge_topk_breaks_ties_to_the_lower_index():
    vals = torch.tensor([[3.0, 1.0, 3.0, 2.0, 3.0, 1.0]])
    idx = torch.tensor([[40, 2, 7, 9, 5, 1]])
    v, i = prs.merge_topk(vals, idx, 4)
    assert v.tolist() == [[3.0, 3.0, 3.0, 2.0]]
    assert i.tolist() == [[5, 7, 40, 9]]


# ---------------------------------------------------------------------------
# the cells' AdamW steps and global_norm
# ---------------------------------------------------------------------------

def _step_ratio(mesh_res, one_res, specs, shape, r, paths) -> float:
    worst = 0.0
    for key in ("m", "params"):
        wants = [_piece(w, specs.get(p), shape, r)
                 for p, w in zip(paths, one_res[key])]
        worst = max(worst, _grad_ratio(mesh_res[key], wants, STEP_RTOL))
    return worst


@pytest.mark.parametrize("shape", PAIR + (QUAD,))
@pytest.mark.parametrize("family", ["lm", "rs"])
def test_cell_adamw_step_on_a_mesh_equals_no_mesh(runs, family, shape):
    _, got = runs
    for world, r in _ranks(shape):
        res = got[world, r]["cells", shape]
        specs = res[f"{family}_specs"]
        one = res[f"{family}_one"]
        mesh_ = res[f"{family}_mesh"]
        cfg = (ptf.LMConfig(**LM["qwen"]) if family == "lm"
               else prs.RecsysConfig(**RECSYS))
        paths = [tree.path_key(p) for p, _ in tree.flatten(
            ptf.init_lm_params(cfg, torch.Generator(), device="meta")
            if family == "lm" else prs.init_recsys_params(
                cfg, torch.Generator(), device="meta"))]
        assert abs(mesh_["loss"] - one["loss"]) <= STEP_RTOL * abs(
            one["loss"])
        assert abs(mesh_["grad_norm"] - one["grad_norm"]) <= \
            STEP_RTOL * one["grad_norm"]
        assert _step_ratio(mesh_, one, specs, shape, r, paths) <= 1.0


@pytest.mark.parametrize("shape", PAIR + (QUAD,))
def test_global_norm_with_sharded_leaves(runs, shape):
    _, got = runs
    for world, r in _ranks(shape):
        res = got[world, r]["cells", shape]
        assert abs(res["norm"] - res["norm_one"]) <= \
            STEP_RTOL * res["norm_one"]


def test_checkpoint_saved_on_one_mesh_restores_on_another(runs):
    """Saved from the pieces on (1, 2), the file holds whole leaves;
    restored on (2, 1), each rank's pieces equal ``local_shard`` of the
    whole."""
    _, got = runs
    for r in range(2):
        res = got[2, r]["checkpoint"]
        assert res["step"] == 3
        assert res["pieces_equal"] and res["file_equal"]


# ---------------------------------------------------------------------------
# planted faults
# ---------------------------------------------------------------------------

def test_planted_row_parallel_psum_left_out_fails(runs):
    want, got = runs
    shape = (1, 2)
    for name in LM:
        wl = want["lm", name, shape][0]
        for world, r in _ranks(shape):
            res = got[world, r]["lm", name, shape]
            rules = AxisRules.for_mesh(_Rank(shape, r))
            w = _piece(wl, (rules.batch, None, rules.tp), shape, r)
            assert _logit_ratio(res["fault_row_sum"], w) >= FAULT_FACTOR, \
                name


def test_planted_sum_of_exponentials_unsummed_fails(runs):
    want, got = runs
    shape = (1, 2)
    for name in LM:
        wloss = want["lm", name, shape][1]
        for world, r in _ranks(shape):
            res = got[world, r]["lm", name, shape]
            assert abs(res["fault_sum_exp"] - wloss) >= \
                FAULT_FACTOR * LOSS_RTOL * abs(wloss), name


@pytest.mark.parametrize("fault", ["fault_combine", "fault_owner"])
def test_planted_decode_faults_fail(runs, fault):
    """The combine without the lse weights, and the new K/V written on
    every shard at its own slot (shards that do not own ``pos``
    overwrite a position they hold), on each of gemma's decode
    layouts."""
    want, got = runs
    for shape in PAIR + (QUAD,):
        rules0 = AxisRules.for_mesh(_Rank(shape, 0))
        for seq_shard in _decodes("gemma", shape):
            lead = None if seq_shard else rules0.batch
            worst = 0.0
            for world, r in _ranks(shape):
                res = got[world, r]["decode", "gemma", shape, seq_shard]
                for g, w in zip(res[fault], want["decode", "gemma", shape,
                                                 seq_shard]):
                    w = _piece(w, (lead, None, rules0.tp), shape, r)
                    worst = max(worst, _logit_ratio(g, w))
            assert worst >= FAULT_FACTOR, (fault, shape, seq_shard)


def test_planted_unmasked_bag_ids_fail(runs):
    want, got = runs
    shape = (1, 2)
    ws = want["recsys", shape][0]
    worst = 0.0
    for world, r in _ranks(shape):
        rules = AxisRules.for_mesh(_Rank(shape, r))
        w = _piece(ws, (rules.batch,), shape, r)
        res = got[world, r]["recsys", shape]
        worst = max(worst, float(np.abs(res["fault_unmasked"] - w).max()
                                 / (RECSYS_RTOL * np.abs(w).max())))
    assert worst >= FAULT_FACTOR


def test_planted_fsdp_gradient_reduced_twice_fails(runs):
    want, got = runs
    shape = (2, 1)
    for name in LM:
        wg = want["lm", name, shape][2]
        cfg = ptf.LMConfig(**LM[name])
        specs = ptf.param_shardings(cfg, AxisRules.for_mesh(_Rank(shape, 0)))
        for world, r in _ranks(shape):
            res = got[world, r]["lm", name, shape]
            wants = _want_grads(res, wg, specs, shape, r)
            assert _grad_ratio(res["fault_fsdp_twice"], wants,
                               GRAD_TOL) >= FAULT_FACTOR, name
    for world, r in _ranks(shape):
        res = got[world, r]["cells", shape]
        paths = [tree.path_key(p) for p, _ in tree.flatten(
            ptf.init_lm_params(ptf.LMConfig(**LM["qwen"]),
                               torch.Generator(), device="meta"))]
        assert _step_ratio(res["lm_fault"], res["lm_one"], res["lm_specs"],
                           shape, r, paths) >= FAULT_FACTOR


@pytest.mark.parametrize("shape", PAIR + (QUAD,))
def test_planted_global_norm_without_psum_fails(runs, shape):
    _, got = runs
    for world, r in _ranks(shape):
        res = got[world, r]["cells", shape]
        assert abs(res["norm_fault"] - res["norm_one"]) >= \
            FAULT_FACTOR * STEP_RTOL * res["norm_one"]


# ---------------------------------------------------------------------------
# without a mesh: the lse and the split
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_decode_reference_lse_matches_cache_attention_logits(softcap):
    """``ref.decode_reference``'s lse against the log-sum-exp of the
    logits the reference's ``cache_attention`` softmaxes (its einsum,
    scale, softcap and mask), with a window and with an empty row."""
    import jax.numpy as jnp
    from repro.models import transformer as jtf
    rng = np.random.default_rng(3)
    B, H, Kh, S, d = 3, 4, 2, 40, 16
    q = rng.normal(size=(B, 1, H, d)).astype(np.float32)
    k = rng.normal(size=(B, S, Kh, d)).astype(np.float32)
    v = rng.normal(size=(B, S, Kh, d)).astype(np.float32)
    pos, window = 29, 9
    qr = jnp.asarray(q).reshape(B, 1, Kh, H // Kh, d)
    logits = jnp.einsum("bqkgd,bskd->bkgqs", qr, jnp.asarray(k),
                        preferred_element_type=jnp.float32) * d ** -0.5
    logits = jtf.softcap(logits, softcap or None)
    s_pos = jnp.arange(S)
    valid = (s_pos <= pos) & (s_pos > pos - window)
    want = np.asarray(jax.nn.logsumexp(
        jnp.where(valid[None, None, None, None, :], logits, -jnp.inf),
        axis=-1)).reshape(B, H)
    lengths = torch.tensor([pos + 1] * (B - 1) + [0], dtype=torch.int32)
    lse = torch.empty(B, H)
    ref.decode_reference(torch.from_numpy(q[:, 0]),
                         torch.from_numpy(k).transpose(1, 2),
                         torch.from_numpy(v).transpose(1, 2), lengths,
                         window, softcap, lse=lse)
    np.testing.assert_allclose(lse[:-1].numpy(), want[:-1], rtol=1e-6,
                               atol=1e-6)
    assert torch.isneginf(lse[-1]).all()


# the attention tolerance: atol, rtol by dtype (chip_smoke.ATTN_TOL)
SPLIT_TOL = {torch.float32: (1e-5, 0.0), torch.bfloat16: (1e-5, 2.0 ** -7)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pos,window", [(29, 0), (29, 7), (3, 0), (39, 12),
                                        (21, 5)])
def test_decode_split_over_slices_equals_whole_call(pos, window, dtype):
    """The cache cut into 4 slices, each attended on its view
    (``attend_shard`` over ``shard_range``, its output float32) and
    combined through the lse (``lse_combine`` over the stacked slices,
    rounded once to q's dtype), equal to the whole ``decode_attention``
    call within the attention tolerance; averaging without the weights
    fails by FAULT_FACTOR times it. In bf16 the slices' outputs are not
    rounded before the combine, so the result is rounded once, as the
    whole call's is."""
    torch.manual_seed(0)
    B, H, Kh, S, d, n = 2, 4, 2, 40, 8, 4
    q = torch.randn(B, H, d).to(dtype)
    kc = torch.randn(B, S, Kh, d).to(dtype)
    vc = torch.randn(B, S, Kh, d).to(dtype)
    lengths = torch.full((B,), pos + 1, dtype=torch.int32)
    whole = ptf.decode_attention(q, kc.transpose(1, 2), vc.transpose(1, 2),
                                 lengths, window, 20.0)
    held = S // n
    outs, lses = zip(*(ptf.attend_shard(
        q, kc[:, r * held:(r + 1) * held], vc[:, r * held:(r + 1) * held],
        *ptf.shard_range(pos, window, r * held, held), 20.0)
        for r in range(n)))
    stacked = torch.stack(outs), torch.stack(lses)
    assert stacked[0].dtype == torch.float32
    reduce = (lambda t: t.amax(0, keepdim=True),
              lambda t: t.sum(0, keepdim=True))
    got = ptf.lse_combine(*stacked, *reduce, dtype)[0]
    assert got.dtype == dtype
    atol, rtol = SPLIT_TOL[dtype]
    bound = atol + rtol * whole.float().abs()
    assert ((got.float() - whole.float()).abs() <= bound).all()
    bad = _combine_unweighted(*stacked, *reduce, dtype)[0]
    assert ((bad.float() - whole.float()).abs() / bound).max() \
        >= FAULT_FACTOR
