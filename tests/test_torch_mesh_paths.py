"""The port's mesh routes against the reference's ``shard_map`` routes on
the CPU.

The port runs in a gloo world of two spawned processes (``FileStore``), on
mesh (2, 1) of ``("data", "model")`` and, for the MoE, also on (1, 2);
each rank gets its pieces of the inputs through ``convert.local_shard``.
The reference runs once in a subprocess with two host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=2``) on the same
meshes. Inputs are made from seeds with numpy, and the reference's
weights (``gnn_init``, ``init_lm_params`` in float32) are made here and
carried to both. Checked, at ``tests/test_distributed_paths.py``'s
configurations:

- ``mp_aggregate``'s sum within 1e-6 relative (integer-valued messages:
  exact in practice); its max exact, and its gradient, with ties inside a
  rank and across the two, exact: each tie gets the whole cotangent;
- ``gnn_loss`` of GCN, PNA, EGNN and NequIP, in one chunk and (PNA, EGNN,
  NequIP) in several, training and serving: the loss within 1e-5
  relative, each gradient leaf (summed over the batch axes, as the train
  step does) within (1e-4 + 4 x the reference's own float32 rounding) *
  max |leaf|, that rounding read against the port's float64 mesh route
  (~1e-7 of a leaf's max, but ~1e-4 for PNA: see ``_gnn_tol``);
- the MoE ``lm_loss`` on the expert-parallel route with every weight
  laid out by ``param_shardings`` (the experts' ``EXPERT_SPECS`` among
  them), the fsdp gathers on (2, 1) and two expert slices on (1, 2): the
  loss, the NLL and the aux loss within 1e-5 relative, every gradient
  piece (reduced as the train step reduces it) within 1e-4 * max |leaf|
  of the rank's piece of the reference's, and each rank's expert choices
  equal to the single-device route's;
- one AdamW step of the gcn-cora ``full_graph_sm`` cell built on the
  (2, 1) mesh equal to the cell without a mesh on the whole batch;
- ``build_cell``'s layouts equal to the reference's ``in_shardings`` on a
  2-device mesh: the GNN cells' and every LM and recsys cell's;
- a world of one through the mesh routes equal to the routes without a
  mesh (PNA's gradient against the mesh tie rule);
- ``axis_size``, ``axis_index`` and ``axis_group`` on a (2, 1, 1)
  ``("pod", "data", "model")`` mesh.

Planted faults, each at least 50 times its tolerance: ``psum_scatter``'s
backward keeping only the rank's own rows (the identity, no gather), the
replicated gradients not summed over the ranks, and the max's node slice
off by one rank.
"""

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
from repro_torch.convert import (gnn_params_from_reference,  # noqa: E402
                                 lm_params_from_reference, local_shard)
from repro_torch.launch import collectives as col  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import gnn as pgnn  # noqa: E402
from repro_torch.models import transformer as ptf  # noqa: E402
from repro_torch.models.common import AxisRules  # noqa: E402
from repro_torch.optim.adamw import adamw_init  # noqa: E402
from repro_torch.runtime.train_loop import (make_train_step,  # noqa: E402
                                            reduce_axes, value_and_grad)

import _mesh_specs  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
WORLD = 2
AXES = ("data", "model")
MODELS = ("gcn", "pna", "egnn", "nequip")
MOE_MESHES = ((2, 1), (1, 2))
SUM_RTOL = 1e-6
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
ROUNDING_FACTOR = 4    # GNN gradients: GRAD_TOL plus this many times the
                       # reference's own float32 rounding (_gnn_tol)
FAULT_FACTOR = 50
MP = dict(E=96, N=32, D=4)
MOE = dict(name="m", n_layers=2, d_model=32, n_heads=4, n_kv_heads=4,
           d_head=8, d_ff=16, vocab=211, n_experts=4, top_k=2,
           capacity_factor=2.0)
MOE_TOKENS = (2, 16)
CELL = ("gcn-cora", "full_graph_sm")
CHUNKED = ("pna", "egnn", "nequip")    # the models that cut edge chunks
CHUNK_CAP = 24         # EDGE_CHUNK in the chunked runs: 2-6 chunks a rank
# the MoE's layouts: ``param_shardings`` (FSDP and TP of every weight);
# the experts' are the reference's EP in_specs (transformer.py:410-411)
# under the stacked layer axis
MOE_SPECS = ptf.param_shardings(ptf.LMConfig(**MOE), AxisRules())
EXPERT_SPECS = {k: MOE_SPECS[k] for k in ("layers/wi_gate", "layers/wi_up",
                                          "layers/wo_ffn")}


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

def _gnn_cfg(model: str, pkg):
    return pkg.GNNConfig(name=model, model=model, n_layers=2, d_hidden=8,
                         n_species=8, n_classes=4, d_feat=16)


def _gnn_data(model: str) -> dict:
    from repro.data.graphs import cora_like, molecule_batch
    if model in ("gcn", "pna"):
        return cora_like(n_nodes=64, n_edges=256, d_feat=16, n_classes=4,
                         seed=2)
    return molecule_batch(batch=4, n_nodes=16, n_edges=32, n_species=8,
                          seed=2)


def _make_inputs() -> dict:
    import jax.numpy as jnp
    from repro.models import gnn as jgnn
    from repro.models import transformer as jtf
    rng = np.random.default_rng(7)
    E, N, D = MP["E"], MP["N"], MP["D"]
    mp = {"msg": rng.integers(-2, 3, (E, D)).astype(np.float32),
          "dst": rng.integers(0, N, E).astype(np.int32),
          "cot": rng.integers(1, 4, (N, D)).astype(np.float32)}
    gnn = {m: {"data": _gnn_data(m),
               "params": jax.tree.map(np.asarray, jgnn.gnn_init(
                   _gnn_cfg(m, jgnn), jax.random.PRNGKey(0)))}
           for m in MODELS}
    mcfg = jtf.LMConfig(**MOE)
    moe = {"params": jax.tree.map(np.asarray, jtf.init_lm_params(
               mcfg, jax.random.PRNGKey(0), dtype=jnp.float32)),
           "tokens": rng.integers(0, MOE["vocab"],
                                  MOE_TOKENS).astype(np.int32)}
    return {"mp": mp, "gnn": gnn, "moe": moe}


_INPUTS = {}


def _inputs() -> dict:
    """The inputs, made once in this process (the tests that read them
    beside the runs' outputs)."""
    if not _INPUTS:
        _INPUTS.update(_make_inputs())
    return _INPUTS


# ---------------------------------------------------------------------------
# the reference, in a subprocess with two host devices
# ---------------------------------------------------------------------------

def _reference(inputs_path: str, out_path: str) -> None:
    import jax.numpy as jnp
    from repro.configs import registry as jreg
    from repro.launch.mesh import make_compat_mesh
    from repro.models import gnn as jgnn
    from repro.models import transformer as jtf
    from repro.models.common import AxisRules as JRules
    with open(inputs_path, "rb") as f:
        inp = pickle.load(f)
    out = {}
    mesh = make_compat_mesh((2, 1), AXES)
    rules = JRules.for_mesh(mesh)
    mp = {k: jnp.asarray(v) for k, v in inp["mp"].items()}
    N = MP["N"]
    with mesh:
        for op in ("sum", "max"):
            def f(m, op=op):
                y = jgnn.mp_aggregate(m, mp["dst"], N, rules, op=op)
                return jnp.sum(y * mp["cot"]), y
            (_, y), g = jax.jit(jax.value_and_grad(f, has_aux=True))(
                mp["msg"])
            out[f"mp_{op}"] = np.asarray(y)
            out[f"mp_{op}_grad"] = np.asarray(g)
        for model in MODELS:
            cfg = _gnn_cfg(model, jgnn)
            data = inp["gnn"][model]["data"]
            batch = {k: jnp.asarray(v) for k, v in data.items()}
            loss, g = jax.jit(jax.value_and_grad(
                lambda p: jgnn.gnn_loss(cfg, p, batch, rules)[0]))(
                    inp["gnn"][model]["params"])
            out[f"gnn_{model}"] = (float(loss), [np.asarray(x) for x in
                                                 jax.tree.leaves(g)])
        out["cells"] = {}
        out["lm_cells"] = _mesh_specs.reference_specs((2, 1))
        for arch in ("gcn-cora", "pna", "egnn", "nequip"):
            spec = jreg.get_spec(arch)
            for shape in spec.shapes:
                cell = jreg.build_cell(spec, shape, mesh)
                out["cells"][arch, shape] = {
                    k: tuple(s.spec) for k, s in cell.in_shardings[2].items()}
    cfg = jtf.LMConfig(**MOE)
    toks = jnp.asarray(inp["moe"]["tokens"])
    for shape in MOE_MESHES:
        mesh = make_compat_mesh(shape, AXES)
        rules = JRules.for_mesh(mesh)
        with mesh:
            (loss, aux), g = jax.jit(jax.value_and_grad(
                lambda p: jtf.lm_loss(cfg, p, toks, rules), has_aux=True))(
                    inp["moe"]["params"])
        out[f"moe_{shape}"] = (float(loss), float(aux["nll"]),
                               float(aux["aux"]),
                               [np.asarray(x) for x in jax.tree.leaves(g)])
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


# ---------------------------------------------------------------------------
# the port, in a gloo world of two
# ---------------------------------------------------------------------------

def _numpy(ts) -> list:
    return [t.detach().numpy().copy() for t in ts]


def _batch_of(data: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in data.items()}


def _gnn_args(model, inp, rules, mesh, dtype=torch.float32):
    """(config, params, this rank's batch) of a GNN case in ``dtype``."""
    params = tree.tree_map(lambda t: t.to(dtype), gnn_params_from_reference(
        inp["gnn"][model]["params"], "cpu"))
    batch = {k: t.to(dtype) if t.is_floating_point() else t
             for k, t in _batch_of(inp["gnn"][model]["data"]).items()}
    specs = {k: (rules.batch,) for k in batch if k != "energy"}
    return _gnn_cfg(model, pgnn), params, local_shard(batch, specs, mesh)


def _gnn_grads(model, inp, rules, mesh, dtype=torch.float32):
    cfg, params, local = _gnn_args(model, inp, rules, mesh, dtype)
    loss, _, g = value_and_grad(
        lambda p, b: pgnn.gnn_loss(cfg, p, b, rules), params, local)
    return float(loss), tree.leaves(g)


def _gnn_loss_only(model, inp, rules, mesh) -> float:
    cfg, params, local = _gnn_args(model, inp, rules, mesh)
    return float(pgnn.gnn_loss(cfg, params, local, rules)[0])


def _summed(grads, mesh, axes) -> list:
    out = [g.clone() for g in grads]
    for g in out:
        dist.all_reduce(g, group=col.axis_group(mesh, axes))
    return out


def _mp_rank(inp, rules, mesh) -> dict:
    """mp_aggregate's sum and max on this rank's block (sorted here, the
    gradient put back in the block's order) and the max's values with the
    node slice off by one rank."""
    rank = col.axis_index(mesh, rules.batch)
    E, N = MP["E"], MP["N"]
    lo, hi = rank * E // WORLD, (rank + 1) * E // WORLD
    msg = torch.from_numpy(inp["mp"]["msg"][lo:hi])
    dst = torch.from_numpy(inp["mp"]["dst"][lo:hi])
    order = torch.sort(dst, stable=True).indices
    cot = torch.from_numpy(inp["mp"]["cot"])
    nl = N // WORLD
    out = {}
    for op in ("sum", "max"):
        m = msg[order].clone().requires_grad_()
        y = pgnn.mp_aggregate(m, dst[order], N, rules, op=op)
        (y * cot[rank * nl:(rank + 1) * nl]).sum().backward()
        g = torch.empty_like(msg)
        g[order] = m.grad
        out[f"mp_{op}"], out[f"mp_{op}_grad"] = _numpy([y, g])
    good = pgnn._my_rows

    def off_by_one(full, rules):
        nl = full.shape[0] // WORLD
        i = (col.axis_index(rules.mesh, rules.batch) + 1) % WORLD
        return full[i * nl:(i + 1) * nl]

    pgnn._my_rows = off_by_one
    try:
        out["fault_slice"] = _numpy([pgnn.mp_aggregate(
            msg[order], dst[order], N, rules, op="max")])[0]
    finally:
        pgnn._my_rows = good
    try:
        pgnn.mp_aggregate(msg, dst, N + 1, rules)
    except ValueError as e:
        out["indivisible"] = str(e)
    return out


def _own_rows_backward(ctx, g):
    """Planted fault: psum_scatter's backward as the identity on the
    rank's own rows (zeros elsewhere, no all_gather)."""
    n, r = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
    full = g.new_zeros((g.shape[0] * n, *g.shape[1:]))
    full[r * g.shape[0]:(r + 1) * g.shape[0]] = g
    return full, None


def _moe_rank(inp, shape) -> dict:
    mesh = tmesh.make_compat_mesh(shape, AXES, "cpu")
    rules = AxisRules.for_mesh(mesh)
    cfg = ptf.LMConfig(**MOE)
    full = lm_params_from_reference(inp["moe"]["params"], "cpu",
                                    torch.float32)
    params = local_shard(full, MOE_SPECS, mesh)
    tokens = torch.from_numpy(inp["moe"]["tokens"])
    local = local_shard({"t": tokens}, {"t": (rules.batch,)}, mesh)["t"]
    routes = []
    old = ptf._moe_route

    def captured(*a):
        routes.append(old(*a))
        return routes[-1]

    ptf._moe_route = captured
    try:
        loss, aux, g = value_and_grad(
            lambda p, b: ptf.lm_loss(cfg, p, b, rules), params, local)
        ep_ids = [r.ids.clone() for r in routes]
        routes.clear()
        with torch.no_grad():
            ptf.lm_forward(cfg, full, local)
        one_ids = [r.ids.clone() for r in routes]
    finally:
        ptf._moe_route = old
    paths = [tree.path_key(p) for p, _ in tree.flatten(g)]
    summed = []
    for p, x in tree.flatten(g):
        axes = reduce_axes(rules, MOE_SPECS.get(tree.path_key(p)))
        summed.append(_summed([x], mesh, axes)[0] if axes else x)
    return {"loss": float(loss), "nll": float(aux["nll"]),
            "aux": float(aux["aux"]), "paths": paths,
            "grads": _numpy(summed),
            # the forward's routes (the backward's recompute repeats them)
            "ids_equal": all(torch.equal(a, b) for a, b in
                             zip(ep_ids[:cfg.n_layers], one_ids)),
            "route_calls": (len(ep_ids), len(one_ids))}


def _cell_batch(cell, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    feat, edges, labels, mask = (cell.abstract_args[2][k] for k in (
        "feat", "edge_index", "labels", "label_mask"))
    n = feat.shape[0]
    return {"feat": torch.from_numpy(rng.normal(size=tuple(feat.shape))
                                     .astype(np.float32)),
            "edge_index": torch.from_numpy(rng.integers(
                0, n, tuple(edges.shape)).astype(np.int32)),
            "labels": torch.from_numpy(rng.integers(
                0, 7, labels.shape[0]).astype(np.int32)),
            "label_mask": torch.from_numpy(
                (rng.random(mask.shape[0]) < 0.2).astype(np.float32))}


def _cell_params(cfg):
    return pgnn.gnn_init(cfg, torch.Generator().manual_seed(0), "cpu")


def _cell_rank(mesh, rules) -> dict:
    """One AdamW step of the gcn-cora full_graph_sm cell on the mesh, and
    the same step with the replicated gradients left unsummed."""
    spec = registry.get_spec(CELL[0])
    cfg, _ = registry.gnn_cell_config(spec.config, CELL[1])
    cell = registry.build_cell(spec, CELL[1], mesh)
    batch = _cell_batch(cell, 11)
    local = local_shard(batch, cell.in_specs[2], mesh)
    params = _cell_params(cfg)
    params, opt, metrics = cell.fn(params, adamw_init(params), local)
    out = {"params": _numpy(tree.leaves(params)),
           "m": _numpy(tree.leaves(opt["m"])),
           "loss": float(metrics["loss"]),
           "grad_norm": float(metrics["grad_norm"])}
    unsummed = make_train_step(
        lambda p, b: pgnn.gnn_loss(cfg, p, b, rules),
        registry._opt_cfg())
    p = _cell_params(cfg)
    _, opt, _ = unsummed(p, adamw_init(p), local)
    out["fault_m"] = _numpy(tree.leaves(opt["m"]))
    return out


def _pod_rank() -> dict:
    mesh = tmesh.make_compat_mesh((2, 1, 1), ("pod", "data", "model"), "cpu")
    batch = AxisRules.for_mesh(mesh).batch
    one = torch.ones(3) * (dist.get_rank() + 1)
    return {"batch": batch, "size": col.axis_size(mesh, batch),
            "index": col.axis_index(mesh, batch),
            "model_index": col.axis_index(mesh, "model"),
            "group_size": dist.get_world_size(col.axis_group(mesh, batch)),
            "psum": col.psum(one, mesh, batch).tolist(),
            "pmax": col.pmax(one, mesh, ("pod", "data")).tolist()}


def _port_rank(rank: int, store: str, inputs_path: str, out: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, WORLD),
                            rank=rank, world_size=WORLD)
    try:
        with open(inputs_path, "rb") as f:
            inp = pickle.load(f)
        mesh = tmesh.make_compat_mesh((WORLD, 1), AXES, "cpu")
        rules = AxisRules.for_mesh(mesh)
        res = _mp_rank(inp, rules, mesh)
        for model in MODELS:
            loss, g = _gnn_grads(model, inp, rules, mesh)
            res[f"gnn_{model}"] = (loss, _numpy(_summed(g, mesh,
                                                        rules.batch)))
            res[f"gnn_{model}_unsummed"] = _numpy(g)
            res[f"gnn_{model}_f64"] = _numpy(_summed(_gnn_grads(
                model, inp, rules, mesh, torch.float64)[1], mesh,
                rules.batch))
        good = pgnn.EDGE_CHUNK
        pgnn.EDGE_CHUNK = CHUNK_CAP       # several chunks a rank's block
        try:
            for model in CHUNKED:
                loss, g = _gnn_grads(model, inp, rules, mesh)
                res[f"gnn_{model}_chunked"] = (loss, _numpy(_summed(
                    g, mesh, rules.batch)))
                with torch.no_grad():     # serving: the in-place writes
                    res[f"gnn_{model}_serving"] = _gnn_loss_only(
                        model, inp, rules, mesh)
        finally:
            pgnn.EDGE_CHUNK = good
        good = col._PsumScatter.backward
        col._PsumScatter.backward = staticmethod(_own_rows_backward)
        try:
            _, g = _gnn_grads("gcn", inp, rules, mesh)
        finally:
            col._PsumScatter.backward = good
        res["fault_scatter_bwd"] = _numpy(_summed(g, mesh, rules.batch))
        res["cell"] = _cell_rank(mesh, rules)
        if rank == 0:    # the cell without a mesh, on the whole batch
            spec = registry.get_spec(CELL[0])
            cfg, _ = registry.gnn_cell_config(spec.config, CELL[1])
            cell = registry.build_cell(spec, CELL[1])
            p = _cell_params(cfg)
            p, opt, metrics = cell.fn(p, adamw_init(p), _cell_batch(cell, 11))
            res["cell_one"] = {"params": _numpy(tree.leaves(p)),
                               "m": _numpy(tree.leaves(opt["m"])),
                               "loss": float(metrics["loss"]),
                               "grad_norm": float(metrics["grad_norm"])}
        for shape in MOE_MESHES:
            res[f"moe_{shape}"] = _moe_rank(inp, shape)
        res["pod"] = _pod_rank()
        with open(f"{out}.{rank}", "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference outputs, [rank 0's, rank 1's]): the reference's
    subprocess and the port's world of two run side by side."""
    tmp = tmp_path_factory.mktemp("mesh_paths")
    inputs = tmp / "inputs.pkl"
    with open(inputs, "wb") as f:
        pickle.dump(_inputs(), f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), str(ROOT / "tests"),
                    os.environ.get("PYTHONPATH", "")]))
    code = ("import sys, test_torch_mesh_paths as t; "
            "t._reference(sys.argv[1], sys.argv[2])")
    ref = subprocess.Popen([sys.executable, "-c", code, str(inputs),
                            str(tmp / "ref.pkl")], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        torch.multiprocessing.spawn(
            _port_rank, args=(str(tmp / "store"), str(inputs),
                              str(tmp / "port")), nprocs=WORLD, join=True)
    finally:
        log = ref.communicate(timeout=600)[0].decode(errors="replace")
    assert ref.returncode == 0, log[-4000:]
    with open(tmp / "ref.pkl", "rb") as f:
        want = pickle.load(f)
    got = []
    for r in range(WORLD):
        with open(tmp / f"port.{r}", "rb") as f:
            got.append(pickle.load(f))
    return want, got


def _rows(a: np.ndarray, rank: int) -> np.ndarray:
    n = a.shape[0] // WORLD
    return a[rank * n:(rank + 1) * n]


def _grad_ratio(got: list, want: list, tol: float = GRAD_TOL) -> float:
    """The largest error of a leaf over tol * max |leaf| (a leaf of zeros
    must be zeros)."""
    worst = 0.0
    for g, w in zip(got, want):
        assert g.shape == w.shape
        if w.size:
            err = float(np.abs(g - w).max())
            limit = tol * float(np.abs(w).max())
            worst = max(worst, err / limit if limit else
                        (0.0 if err == 0 else np.inf))
    return worst


# ---------------------------------------------------------------------------
# mp_aggregate
# ---------------------------------------------------------------------------

def test_mp_aggregate_sum_matches_reference(runs):
    want, got = runs
    for r in range(WORLD):
        np.testing.assert_allclose(got[r]["mp_sum"],
                                   _rows(want["mp_sum"], r), rtol=SUM_RTOL)
        lo = r * MP["E"] // WORLD
        np.testing.assert_allclose(
            got[r]["mp_sum_grad"],
            want["mp_sum_grad"][lo:lo + MP["E"] // WORLD], rtol=SUM_RTOL)


def test_mp_aggregate_max_values_exact(runs):
    want, got = runs
    for r in range(WORLD):
        np.testing.assert_array_equal(got[r]["mp_max"],
                                      _rows(want["mp_max"], r))


def test_mp_aggregate_max_gives_each_tie_the_whole_cotangent(runs):
    """The gradient equals the reference's mesh custom_vjp exactly, and
    the data holds ties: inside a rank's block and across the two."""
    want, got = runs
    E = MP["E"]
    grad = np.concatenate([got[r]["mp_max_grad"] for r in range(WORLD)])
    np.testing.assert_array_equal(grad, want["mp_max_grad"])
    msg, dst = _inputs()["mp"]["msg"], _inputs()["mp"]["dst"]
    y = want["mp_max"]
    tied = msg == y[dst]                          # [E, D] edges at the max
    half = np.arange(E) < E // WORLD
    counts = np.zeros((MP["N"], MP["D"], 2), int)
    np.add.at(counts, (dst, slice(None), 0), tied & half[:, None])
    np.add.at(counts, (dst, slice(None), 1), tied & ~half[:, None])
    assert (counts.sum(-1) >= 2).any()            # ties ...
    assert ((counts[..., 0] > 0) & (counts[..., 1] > 0)).any()  # across
    # every tied element got the row's whole cotangent, not a share
    cot = _inputs()["mp"]["cot"]
    np.testing.assert_array_equal(grad[tied], cot[dst][tied])


def test_mp_aggregate_raises_where_nodes_do_not_divide(runs):
    assert "not divisible by 2" in runs[1][0]["indivisible"]


def test_planted_node_slice_off_by_one_rank_fails(runs):
    want, got = runs
    for r in range(WORLD):
        err = np.abs(got[r]["fault_slice"] - _rows(want["mp_max"], r)).max()
        # exact is the tolerance: the fault reads whole units
        assert err >= 1.0


# ---------------------------------------------------------------------------
# gnn_loss
# ---------------------------------------------------------------------------

def _rounding(runs, model: str) -> float:
    """The reference's own float32 rounding of the gradient: its largest
    distance from the port's float64 mesh route, relative to a leaf's max
    |g|."""
    want, got = runs
    return max(float(np.abs(w - t).max() / np.abs(t).max())
               for w, t in zip(want[f"gnn_{model}"][1],
                               got[0][f"gnn_{model}_f64"])
               if np.abs(t).max())


def _gnn_tol(runs, model: str) -> float:
    """GRAD_TOL plus ROUNDING_FACTOR times the reference's own float32
    rounding (:func:`_rounding`), as ``chip_smoke.gnn_loss_check`` widens
    GRAD_TOL by the CPU's own spread. That rounding is ~1e-7 for GCN,
    EGNN and NequIP; PNA's float32 gradient here carries ~1e-4 (its std,
    sqrt(max(E[m^2] - E[m]^2, 0) + 1e-9), has a slope of 1.6e4 where a
    node's messages agree, and cora_like's binary features leave many
    nodes alike), more than GRAD_TOL itself."""
    return GRAD_TOL + ROUNDING_FACTOR * _rounding(runs, model)


def test_reference_rounding_is_small_but_for_pnas_std(runs):
    for model in MODELS:
        assert _rounding(runs, model) < (1e-3 if model == "pna" else 1e-6)


@pytest.mark.parametrize("model", MODELS)
def test_gnn_loss_and_grads_match_reference(runs, model):
    want, got = runs
    wl, wg = want[f"gnn_{model}"]
    tol = _gnn_tol(runs, model)
    assert model == "pna" or tol < 2 * GRAD_TOL
    for r in range(WORLD):
        gl, gg = got[r][f"gnn_{model}"]
        assert abs(gl - wl) <= LOSS_RTOL * abs(wl), (model, gl, wl)
        assert _grad_ratio(gg, wg, tol) <= 1.0, (model, tol)


@pytest.mark.parametrize("model", CHUNKED)
def test_gnn_loss_in_chunks_matches_reference(runs, model):
    """A rank's block cut into chunks at node boundaries (EDGE_CHUNK
    small), their node rows joined into one partial before the scatter:
    training (each chunk under its checkpoint) and serving (each chunk
    written in place) both equal the reference."""
    want, got = runs
    wl, wg = want[f"gnn_{model}"]
    for r in range(WORLD):
        gl, gg = got[r][f"gnn_{model}_chunked"]
        assert abs(gl - wl) <= LOSS_RTOL * abs(wl), (model, gl, wl)
        assert abs(got[r][f"gnn_{model}_serving"] - wl) <= \
            LOSS_RTOL * abs(wl), model
        assert _grad_ratio(gg, wg, _gnn_tol(runs, model)) <= 1.0, model


def test_planted_psum_scatter_backward_identity_fails(runs):
    want, got = runs
    for r in range(WORLD):
        assert _grad_ratio(got[r]["fault_scatter_bwd"], want["gnn_gcn"][1],
                           _gnn_tol(runs, "gcn")) >= FAULT_FACTOR


@pytest.mark.parametrize("model", MODELS)
def test_planted_grads_not_all_reduced_fails(runs, model):
    want, got = runs
    for r in range(WORLD):
        assert _grad_ratio(got[r][f"gnn_{model}_unsummed"],
                           want[f"gnn_{model}"][1],
                           _gnn_tol(runs, model)) >= FAULT_FACTOR, model


# ---------------------------------------------------------------------------
# the expert-parallel MoE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", MOE_MESHES)
def test_moe_lm_loss_on_the_ep_route_matches_reference(runs, shape):
    want, got = runs
    wl, wnll, waux, wg = want[f"moe_{shape}"]
    mesh_like = _FakeMesh(shape, rank=0)
    for r in range(WORLD):
        res = got[r][f"moe_{shape}"]
        for g, w in ((res["loss"], wl), (res["nll"], wnll),
                     (res["aux"], waux)):
            assert abs(g - w) <= LOSS_RTOL * abs(w), (shape, g, w)
        mesh_like.rank = r
        wants = [local_shard({"w": torch.from_numpy(w)},
                             {"w": MOE_SPECS.get(path)},
                             mesh_like)["w"].numpy()
                 for path, w in zip(res["paths"], wg)]
        assert _grad_ratio(res["grads"], wants) <= 1.0, shape


@pytest.mark.parametrize("shape", MOE_MESHES)
def test_moe_ep_route_keeps_the_single_device_routing(runs, shape):
    _, got = runs
    cfg = ptf.LMConfig(**MOE)
    for r in range(WORLD):
        res = got[r][f"moe_{shape}"]
        # the forward's routes, then the backward's recompute of each layer
        assert res["route_calls"] == (2 * cfg.n_layers, cfg.n_layers)
        assert res["ids_equal"], (shape, r)


class _FakeMesh:
    """The coordinates of one rank of a mesh, for cutting the reference's
    gradients as that rank holds them."""

    def __init__(self, shape, rank, names=AXES):
        self.shape, self.rank, self.mesh_dim_names = shape, rank, names

    def get_local_rank(self, axis):
        coords = np.unravel_index(self.rank, self.shape)
        return int(coords[self.mesh_dim_names.index(axis)])

    def get_group(self, axis):
        return None

    def size(self):
        return int(np.prod(self.shape))


# ---------------------------------------------------------------------------
# cells, the train step and the axes
# ---------------------------------------------------------------------------

def test_gnn_cell_adamw_step_on_a_mesh_equals_no_mesh(runs):
    _, got = runs
    one = got[0]["cell_one"]
    for r in range(WORLD):
        cell = got[r]["cell"]
        assert abs(cell["loss"] - one["loss"]) <= LOSS_RTOL * abs(
            one["loss"])
        assert abs(cell["grad_norm"] - one["grad_norm"]) <= \
            LOSS_RTOL * one["grad_norm"]
        assert _grad_ratio(cell["m"], one["m"]) <= 1.0
        for a, b in zip(cell["params"], one["params"]):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-7)


def test_planted_cell_grads_not_all_reduced_fails(runs):
    _, got = runs
    for r in range(WORLD):
        assert _grad_ratio(got[r]["cell"]["fault_m"],
                           got[0]["cell_one"]["m"]) >= FAULT_FACTOR


def _strip(spec) -> tuple:
    """A layout without its trailing Nones (a PartitionSpec's form)."""
    spec = tuple(s[0] if isinstance(s, tuple) and len(s) == 1 else s
                 for s in spec)
    while spec and spec[-1] is None:
        spec = spec[:-1]
    return spec


def test_gnn_cells_on_a_mesh_take_the_reference_layouts(runs):
    want, _ = runs
    mesh = _FakeMesh((2, 1), rank=0)
    assert len(want["cells"]) == 16
    for (arch, shape), layouts in want["cells"].items():
        cell = registry.build_cell(registry.get_spec(arch), shape, mesh)
        params, opt, specs = cell.in_specs
        assert params == {} and opt == {}
        assert set(layouts) == set(cell.abstract_args[2])
        for key, spec in layouts.items():
            assert _strip(specs.get(key, ())) == _strip(spec), (
                arch, shape, key)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "wide-deep",
                                  "phi3.5-moe-42b-a6.6b",
                                  "granite-moe-1b-a400m", "qwen3-1.7b",
                                  "gemma2-2b"])
def test_lm_and_recsys_cells_refuse_a_larger_mesh(runs, arch):
    """Once a refusal past one device; with the layouts ported, each of
    ``arch``'s cells builds on the (2, 1) mesh and its ``in_specs``
    (params, opt, batch, cache) equal the reference's ``in_shardings``."""
    want, _ = runs
    spec = registry.get_spec(arch)
    mesh = _FakeMesh((2, 1), rank=0)
    for shape in spec.shapes:
        cell = registry.build_cell(spec, shape, mesh)
        assert _mesh_specs.port_specs(cell) == \
            want["lm_cells"][arch, shape], (arch, shape)


def test_axes_on_a_pod_mesh(runs):
    _, got = runs
    for r in range(WORLD):
        pod = got[r]["pod"]
        assert pod["batch"] == ("pod", "data")
        assert (pod["size"], pod["index"], pod["model_index"],
                pod["group_size"]) == (2, r, 0, 2)
        assert pod["psum"] == [3.0] * 3 and pod["pmax"] == [2.0] * 3


# ---------------------------------------------------------------------------
# a world of one
# ---------------------------------------------------------------------------

@pytest.fixture
def world_of_one():
    if dist.is_initialized():
        dist.destroy_process_group()
    mesh = tmesh.make_compat_mesh((1, 1), AXES, "cpu")
    yield AxisRules.for_mesh(mesh)
    dist.destroy_process_group()


def _mesh_tie_max(seg_max):
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke._mesh_tie_max(seg_max)


@pytest.mark.parametrize("model", MODELS)
def test_world_of_one_mesh_route_equals_no_mesh(world_of_one, model):
    """Every collective runs on the world of one; the loss and each
    gradient leaf equal the route without a mesh (PNA's against that
    route with the mesh tie rule, since cora_like repeats edges)."""
    inp = _inputs()["gnn"][model]
    cfg = _gnn_cfg(model, pgnn)
    params = gnn_params_from_reference(inp["params"], "cpu")
    batch = _batch_of(inp["data"])

    def run(rules):
        return value_and_grad(lambda p, b: pgnn.gnn_loss(cfg, p, b, rules),
                              params, batch)

    calls = []
    good = col._PsumScatter.forward

    def counted(ctx, x, group):
        calls.append(x.shape)
        return good(ctx, x, group)

    col._PsumScatter.forward = staticmethod(counted)
    try:
        loss, _, g = run(world_of_one)
    finally:
        col._PsumScatter.forward = staticmethod(good)
    assert calls                                   # not short-circuited
    if model == "pna":
        old = pgnn.seg_max
        pgnn.seg_max = _mesh_tie_max(old)
        try:
            want_loss, _, want = run(None)
        finally:
            pgnn.seg_max = old
    else:
        want_loss, _, want = run(None)
    assert abs(float(loss) - float(want_loss)) <= LOSS_RTOL * abs(
        float(want_loss))
    assert _grad_ratio(_numpy(tree.leaves(g)),
                       _numpy(tree.leaves(want))) <= 1.0
