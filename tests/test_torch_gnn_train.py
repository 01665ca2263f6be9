"""GNN training in the port on the CPU: ``repro_torch.models.gnn.gnn_loss``
and its gradient against ``jax.value_and_grad`` of the reference's
``gnn_loss`` (one device: ``AxisRules(batch=(), fsdp=None, tp=None)``),
the differentiable ``segment_sum_sorted``, the segment helpers under
autograd, AdamW steps through ``make_train_step`` against the reference's,
and a CPU rehearsal of ``chip_smoke.py``'s GNN training checks.

Configs and batches are the launcher's: ``reduce_config`` (2 layers,
hidden 16, d_feat 32, 5 classes) and ``make_batch_iter``'s graph
(``cora_like(256, 1024)`` for GCN and PNA, ``molecule_batch(8, 12, 32)``
for EGNN and NequIP), float32 params carried over with
``convert.gnn_params_from_reference``. cora_like at d_feat 32 leaves most
nodes without features and repeats edges, so PNA's max and min tie often
(the even split of one device is held to JAX; the mesh route's rule fails).

Tolerances (float32, sums in other orders): the loss within 1e-5 of
max(1, |loss|); each gradient leaf within 1e-4 of the leaf's max |g|
(GRAD_TOL, as ``chip_smoke.py`` holds the card to the CPU); three AdamW
steps' params within 1e-6 of the reference's, with AdamW's eps at 1e-2
(ADAM_EPS): Adam moves an element by about lr * g / (|g| + eps), so at the
default 1e-8 an element whose gradient is float32 noise (1e-10, where
PNA's std cancels) moves by up to lr either way on either side, and at
1e-4 a gradient 6e-8 apart (within GRAD_TOL) moves it 2e-6; at 1e-2 the
step is near linear in the gradient for these reduced models (|g| <=
0.13). The update rule at the default eps is held to the reference by
``tests/test_torch_train.py``. ``segment_sum_sorted``'s gradient (a
gather) equals autograd of ``index_add_`` exactly. The reference runs
under ``jax.jit``.
"""

import dataclasses
import functools
import importlib
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from repro.configs.registry import get_spec as j_get_spec  # noqa: E402
from repro.launch.train import (  # noqa: E402
    make_batch_iter as j_make_batch_iter)
from repro.launch.train import reduce_config as j_reduce  # noqa: E402
from repro.models import gnn as jgnn  # noqa: E402
from repro.models.common import AxisRules  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.runtime import train_loop as jtl  # noqa: E402

from repro_torch import tree  # noqa: E402
from repro_torch.configs.registry import get_spec  # noqa: E402
from repro_torch.convert import (adamw_state_from_reference,  # noqa: E402
                                 gnn_params_from_reference)
from repro_torch.kernels import ref, segment_mp  # noqa: E402
from repro_torch.launch import train as ltrain  # noqa: E402
from repro_torch.models import gnn  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.runtime.train_loop import (make_train_step,  # noqa: E402
                                            value_and_grad)

ROOT = Path(__file__).resolve().parent.parent
RULES = AxisRules(batch=(), fsdp=None, tp=None)
ARCHS = ["gcn-cora", "pna", "egnn", "nequip"]
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
ADAM_ATOL = 1e-6
ADAM_EPS = 1e-2


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for these small CPU ops: when the suite's
    workers share the CPU, torch's default thread pool (a thread a core in
    each worker) made single tests 10-60x slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        return importlib.import_module("chip_smoke")
    finally:
        sys.path.remove(str(ROOT))


@functools.cache
def _case(arch: str, seed: int = 0):
    """(port config, JAX config, JAX params, numpy batch) of ``arch`` at
    the launcher's reduced config and batch."""
    jspec = j_get_spec(arch)
    jcfg = j_reduce(jspec)
    cfg = ltrain.reduce_config(get_spec(arch))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jp = jgnn.gnn_init(jcfg, jax.random.PRNGKey(seed))
    batch = {k: np.array(v) for k, v in
             next(j_make_batch_iter(jspec, jcfg, 4, seed=seed)).items()}
    return cfg, jcfg, jp, batch


@functools.cache
def _jax_grads(arch: str):
    """The reference's loss, aux and gradient leaves (numpy)."""
    _, jcfg, jp, batch = _case(arch)
    (loss, aux), g = jax.jit(jax.value_and_grad(
        lambda p, b: jgnn.gnn_loss(jcfg, p, b, RULES), has_aux=True))(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
    return (float(loss), {k: float(v) for k, v in aux.items()},
            [np.asarray(x) for x in jax.tree.leaves(g)])


def _port_grads(arch: str, batch: dict | None = None):
    cfg, _, jp, jbatch = _case(arch)
    params = gnn_params_from_reference(jax.tree.map(np.asarray, jp),
                                       device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in (batch or jbatch).items()}
    loss, aux, g = value_and_grad(lambda p, b: gnn.gnn_loss(cfg, p, b),
                                  params, tb)
    return float(loss), {k: float(v) for k, v in aux.items()}, \
        [x.numpy() for x in tree.leaves(g)]


def _grad_ratio(got: list, want: list) -> float:
    """The largest max |got - want| / (GRAD_TOL * max |want|) over the
    leaves: within tolerance when at most 1."""
    assert [g.shape for g in got] == [w.shape for w in want]
    return max(float(np.abs(g - w).max())
               / (GRAD_TOL * max(float(np.abs(w).max()), 1e-30))
               for g, w in zip(got, want) if w.size)


def _assert_match(got, want):
    loss, aux, grads = got
    jloss, jaux, jgrads = want
    assert abs(loss - jloss) <= LOSS_RTOL * max(1.0, abs(jloss))
    assert set(aux) == set(jaux)
    for k in aux:
        assert abs(aux[k] - jaux[k]) <= LOSS_RTOL * max(1.0, abs(jaux[k]))
    assert _grad_ratio(grads, jgrads) <= 1.0


def _hub_cap(batch: dict) -> tuple[int, int]:
    """A chunk cap one below the largest in-degree, so the hub is a chunk
    of its own, and the number of chunks it gives."""
    edges = gnn.sort_by_dst(torch.from_numpy(batch["edge_index"]))
    dst = edges[:, 1].contiguous()
    n = len(batch["feat"] if "feat" in batch else batch["species"])
    cap = int(torch.bincount(dst, minlength=n).max()) - 1
    plan = gnn.edge_chunks(dst, n, cap)
    assert any(c.hi - c.lo == 1 and c.e1 - c.e0 > cap for c in plan)
    return cap, len(plan)


# -- gnn_loss against the reference -------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_gnn_loss_and_grads_match_jax(arch):
    """One chunk (the whole graph): the loss, its aux and every gradient
    leaf, in the reference's leaf order."""
    got = _port_grads(arch)
    cfg, _, jp, _ = _case(arch)
    params = gnn_params_from_reference(jax.tree.map(np.asarray, jp),
                                       device="cpu")
    assert [tree.path_key(p) for p, _ in tree.flatten(params)] == [
        "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        for path, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert set(got[1]) == ({"nll"} if cfg.model in ("gcn", "pna")
                           else {"mse"})
    _assert_match(got, _jax_grads(arch))


@pytest.mark.parametrize("arch", ["pna", "egnn", "nequip"])
def test_gnn_loss_chunked_matches_jax(arch, monkeypatch):
    """The chunk loops with EDGE_CHUNK one below the hub's in-degree:
    several chunks, the hub's alone, each under its own checkpoint and
    joined; the same loss and gradients as the reference."""
    cap, n_chunks = _hub_cap(_case(arch)[3])
    assert n_chunks > 3
    monkeypatch.setattr(gnn, "EDGE_CHUNK", cap)
    _assert_match(_port_grads(arch), _jax_grads(arch))


def test_pna_ties_split_evenly_as_jax(monkeypatch):
    """PNA's max and min over tied messages (repeated edges; nodes without
    features send equal messages): the even split matches JAX; the mesh
    route's rule (each tie the whole cotangent) and a start value of 0
    counted among the ties (``scatter_reduce(include_self=False)``'s
    backward) both fail it."""
    batch = _case("pna")[3]
    assert len(np.unique(batch["edge_index"], axis=0)) < \
        len(batch["edge_index"])
    want = _jax_grads("pna")
    _assert_match(_port_grads("pna"), want)
    smoke = _chip_smoke()
    with smoke.patched(gnn, "seg_max", smoke._mesh_tie_max):
        assert _grad_ratio(_port_grads("pna")[2], want[2]) > 10

    def zero_start(x, idx, n, out=None):
        if torch.is_grad_enabled() and x.requires_grad:
            return x.new_zeros((n, x.shape[1])).scatter_reduce(
                0, idx.long()[:, None].expand_as(x), x, "amax",
                include_self=False)
        return orig(x, idx, n, out)

    orig = gnn.seg_max
    monkeypatch.setattr(gnn, "seg_max", zero_start)
    assert _grad_ratio(_port_grads("pna")[2], want[2]) > 10


# -- the differentiable segment sum and the helpers ---------------------------

def test_segment_sum_function_matches_index_add_autograd():
    """``segment_sum_sorted`` under autograd (``SegmentSum``) against
    autograd of ``zeros`` + ``index_add_``, dst outside [0, N) at both
    ends included (dropped forward, zero gradient back): the sums equal
    the plain version's and the message gradient equals exactly."""
    rng = np.random.default_rng(2)
    n, E, D = 30, 200, 5
    dst = np.sort(rng.integers(-4, n + 4, E)).astype(np.int32)
    assert (dst < 0).any() and (dst >= n).any()
    msg = rng.standard_normal((E, D)).astype(np.float32)
    cot = torch.from_numpy(rng.standard_normal((n, D)).astype(np.float32))
    tdst = torch.from_numpy(dst)
    m1 = torch.from_numpy(msg).requires_grad_()
    out = segment_mp.segment_sum_sorted(m1, tdst, n)
    assert out.grad_fn is not None and "SegmentSum" in type(
        out.grad_fn).__name__
    assert torch.equal(out.detach(), ref.segment_sum_sorted_reference(
        m1.detach(), tdst, n))
    g1, = torch.autograd.grad(out, m1, cot)
    m2 = torch.from_numpy(msg).requires_grad_()
    keep = (tdst >= 0) & (tdst < n)
    idx = torch.where(keep, tdst, n).long()
    full = torch.zeros((n + 1, D)).index_add(0, idx, m2)
    g2, = torch.autograd.grad(full[:n], m2, cot)
    assert torch.equal(g1, g2)
    assert (g1[~keep] == 0).all()
    assert torch.equal(segment_mp.segment_sum_backward(cot, tdst, n), g2)


def test_out_raises_under_grad():
    """``out=`` writes in place: under autograd ``segment_sum_sorted`` and
    ``seg_max`` raise rather than detach; without grad (or with a message
    that needs none) they still write in place."""
    dst = torch.tensor([0, 0, 1, 3], dtype=torch.int32)
    msg = torch.randn(4, 2, requires_grad=True)
    out = torch.empty(4, 2)
    with pytest.raises(ValueError, match="out="):
        segment_mp.segment_sum_sorted(msg, dst, 4, out=out)
    with pytest.raises(ValueError, match="out="):
        gnn.seg_max(msg, dst, 4, out=out)
    with torch.no_grad():
        got = segment_mp.segment_sum_sorted(msg, dst, 4, out=out)
    assert got is out and torch.equal(out[1], msg[2].detach())
    assert gnn.seg_min(msg.detach(), dst, 4, out=out) is out
    assert gnn.seg_max(msg, dst, 4).requires_grad
    assert gnn.seg_min(msg, dst, 4).requires_grad


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_forward_equals_grad_route(arch, monkeypatch):
    """The serving forward (no tensor requiring grad: in-place chunk
    sums, no checkpoint) and the training route (params requiring grad:
    out-of-place, checkpointed, joined) give bit-equal outputs, with one
    chunk and with many."""
    cfg, _, jp, batch = _case(arch)
    params = gnn_params_from_reference(jax.tree.map(np.asarray, jp),
                                       device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    grad_params = tree.tree_map(lambda p: p.detach().requires_grad_(),
                                params)

    def forward(p):
        if cfg.model in ("gcn", "pna"):
            fwd = gnn.gcn_forward if cfg.model == "gcn" else gnn.pna_forward
            return fwd(cfg, p, tb["feat"], tb["edge_index"])
        fwd = gnn.egnn_energy if cfg.model == "egnn" else gnn.nequip_energy
        return fwd(cfg, p, tb["species"], tb["coords"], tb["edge_index"],
                   tb["graph_ids"], len(batch["energy"]))

    for cap in (None, _hub_cap(batch)[0]):
        if cap is not None:
            monkeypatch.setattr(gnn, "EDGE_CHUNK", cap)
        serve = forward(params)
        train = forward(grad_params)
        assert not serve.requires_grad and train.requires_grad
        assert torch.equal(serve, train.detach()), cap


# -- the train step -----------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_three_adamw_steps_match_reference(arch):
    """Three steps of the port's ``make_train_step`` and the reference's
    from the same params and AdamW state (carried over by the
    converters), clipping on: the losses and the params after each step
    within ADAM_ATOL (AdamW's eps ADAM_EPS: see the module docstring)."""
    cfg, jcfg, jp, batch = _case(arch)
    kw = dict(peak_lr=3e-3, warmup_steps=1, total_steps=10, eps=ADAM_EPS)
    jstep = jax.jit(jtl.make_train_step(
        lambda p, b: jgnn.gnn_loss(jcfg, p, b, RULES),
        jadamw.AdamWConfig(**kw)))
    step = make_train_step(lambda p, b: gnn.gnn_loss(cfg, p, b),
                           AdamWConfig(**kw))
    jst = jadamw.adamw_init(jp)
    params = gnn_params_from_reference(jax.tree.map(np.asarray, jp),
                                       device="cpu")
    st = adamw_state_from_reference(jax.tree.map(np.asarray, jst),
                                    device="cpu")
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    for _ in range(3):
        jp, jst, jm = jstep(jp, jst, jb)
        params, st, m = step(params, st, tb)
        assert abs(float(m["loss"]) - float(jm["loss"])) <= \
            LOSS_RTOL * max(1.0, abs(float(jm["loss"])))
        for got, want in zip(tree.leaves(params), jax.tree.leaves(jp)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=ADAM_ATOL)
    assert int(st["step"]) == int(jst["step"]) == 3


def test_gnn_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    cfg = _case("pna")[0]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gnn.gnn_init(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ltrain.make_batch_iter(get_spec("nequip"), cfg, 4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ltrain.main(["--arch", "egnn", "--steps", "1"])


# -- chip_smoke.py's GNN training checks, rehearsed on the CPU ----------------

def test_chip_smoke_gnn_train_checks_on_cpu(monkeypatch):
    """The train phase's GNN part with the plain versions on both sides, at
    ``reduce_config`` (the card runs it at full width): ``gnn_loss_check``
    on the check's graphs (full_graph_sm, the molecule shape) in several
    chunks, each planted fault far outside its tolerance; then every run of
    GNN_TRAIN on a small power-law graph and molecule batches (the losses
    finite and falling over more than one step), with
    ``segment_sum_sorted``'s calls a step (counted here, as the CPU counts
    no launches) equal to ``gnn_train_launches``."""
    smoke = _chip_smoke()
    for arch in ARCHS:
        cfg = ltrain.reduce_config(get_spec(arch))
        check = smoke.gnn_loss_check(cfg, 0, "cpu")
        assert check["ok"], check
        assert check["chunks"] > 1 and check["repeated_edges"] > 0
        # float32 reorder spread: tiny but for PNA's std (see
        # gnn_loss_check)
        assert check["reorder_spread"] < (1e-2 if cfg.model == "pna"
                                          else 1e-6)
        want = {"gcn": 1, "pna": 3}.get(cfg.model, 2)
        assert len(check["controls"]) == want
        assert min(check["controls"].values()) > 30

    monkeypatch.setattr(gnn, "EDGE_CHUNK", 2000)
    graph = smoke.gnn_graph(1000, 8000, 12, seed=1, device="cpu")
    calls = []
    orig = gnn.segment_sum_sorted

    def counted(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(gnn, "segment_sum_sorted", counted)
    for arch, where, steps in smoke.GNN_TRAIN:
        cfg = dataclasses.replace(ltrain.reduce_config(get_spec(arch)),
                                  d_feat=12)
        batch = smoke.gnn_train_batch(cfg, where, graph, 0, "cpu")
        calls.clear()
        run = smoke.gnn_train(cfg, batch, max(steps, 2), 0, "cpu")
        assert run["ok"], (arch, where, run["losses"])
        assert run["launches"] == {} and run["profile"] is None
        assert run["chunks"] > 1
        assert len(calls) == max(steps, 2) * smoke.gnn_train_launches(
            cfg, run["chunks"])
