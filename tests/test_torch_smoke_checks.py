"""``chip_smoke.same_answer``, the multiset comparison that decides every
SPARQL and system check of ``chip_smoke.py``: its packed-key route (rows
packed into one int64 where their ids fit) agrees with the lexicographic
sort, and both routes reject each kind of wrong answer. Then the script's
``mesh`` phase rehearsed on the CPU: a gloo (1, 1) mesh, the four GNN
cells at published widths on a small ``minibatch_lg`` subgraph and a
tiny granite-moe prefill on the expert-parallel route, each against its
route without a mesh, the planted expert-slice fault failing; and the
weights' layouts' checks (``mesh lm``, ``mesh decode``, ``mesh recsys``)
at reduced configs, each planted fault failing."""

import dataclasses
import importlib
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]


def _smoke():
    sys.path.insert(0, str(ROOT))
    try:
        return importlib.import_module("chip_smoke")
    finally:
        sys.path.remove(str(ROOT))


smoke = _smoke()


def table(names, rows) -> SimpleNamespace:
    """A solution table as ``same_answer`` reads it."""
    return SimpleNamespace(var_names=list(names),
                           bindings=np.asarray(rows, dtype=np.int64)
                           .reshape(-1, len(names)))


def packs(rows: np.ndarray) -> bool:
    """Whether ``same_answer`` takes the packed route for these rows."""
    span = int(rows.max()) - int(rows.min())
    return max(1, span.bit_length()) * rows.shape[1] <= 63


def lexsort_equal(a, b) -> bool:
    """The plain definition: same variables, same sorted rows."""
    if sorted(a.var_names) != sorted(b.var_names):
        return False
    ra, rb = smoke.sorted_rows(a), smoke.sorted_rows(b)
    return ra.shape == rb.shape and np.array_equal(ra, rb)


NAMES = ["?x", "?p", "?y"]
# narrow ids take the packed route; ids near 2^40 over three columns
# (123 bits) take the lexicographic one
WIDTHS = {"packed": 60, "lexsort": 2 ** 40}


def rows_of(rng, width: str, n: int = 300) -> np.ndarray:
    hi = WIDTHS[width]
    rows = rng.integers(0, hi, size=(n, len(NAMES)))
    rows[rng.random(rows.shape) < 0.05] = -1       # OPTIONAL's unbound
    # column 1 never equals column 0, so swapping them changes the answer
    rows[:, 1] = (rows[:, 0] + 1 + rng.integers(0, 5, n)) % hi
    assert packs(rows) == (width == "packed")
    return rows


def shuffled(rng, rows: np.ndarray) -> np.ndarray:
    return rows[rng.permutation(len(rows))].copy()


@pytest.mark.parametrize("seed", range(6))
def test_packed_route_agrees_with_lexsort(seed):
    """Random pairs over a small alphabet, half of them equal multisets
    and half differing in one place: the packed route answers as the
    lexicographic sort does."""
    rng = np.random.default_rng(seed)
    answers = set()
    for _ in range(200):
        a = rng.integers(-1, 4, size=(int(rng.integers(0, 12)), 3))
        b = shuffled(rng, a)
        if len(b) and rng.random() < 0.5:
            i, j = rng.integers(len(b)), rng.integers(3)
            b[i, j] = rng.integers(-1, 4)
        assert packs(np.concatenate([a, b])) if len(a) else True
        ta, tb = table(NAMES, a), table(NAMES, b)
        want = lexsort_equal(ta, tb)
        assert smoke.same_answer(ta, tb) == want
        assert smoke.same_answer(tb, ta) == want
        answers.add(want)
    assert answers == {True, False}


@pytest.mark.parametrize("width", list(WIDTHS))
def test_accepts_the_same_multiset(width):
    """Rows in another order, and columns in another order with their
    names, are the same answer on either route."""
    rng = np.random.default_rng(1)
    a = rows_of(rng, width)
    b = shuffled(rng, a)
    assert smoke.same_answer(table(NAMES, a), table(NAMES, b))
    perm = [2, 0, 1]
    assert smoke.same_answer(table(NAMES, a),
                             table([NAMES[c] for c in perm], b[:, perm]))


def mutate(kind: str, rng, a: np.ndarray) -> np.ndarray:
    b = shuffled(rng, a)
    if kind == "changed_cell":
        b[7, 2] += 1 if b[7, 2] < a.max() else -1
    elif kind == "duplicated_row":
        j = next(j for j in range(1, len(b))
                 if not np.array_equal(b[j], b[0]))
        b[j] = b[0]
    elif kind == "swapped_columns":
        b[:, [0, 1]] = b[:, [1, 0]]
    elif kind == "unbound_id":
        i = int(np.flatnonzero(b[:, 2] >= 0)[0])
        b[i, 2] = -1
    elif kind == "bound_id":
        i = int(np.flatnonzero(b[:, 2] < 0)[0])
        b[i, 2] = 0
    elif kind == "dropped_row":
        b = b[1:]
    return b


KINDS = ["changed_cell", "duplicated_row", "swapped_columns", "unbound_id",
         "bound_id", "dropped_row"]


@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("kind", KINDS)
def test_rejects_a_wrong_answer(width, kind):
    """One changed cell, a duplicated row in place of another, two columns
    swapped under the same names, a -1 (unbound) in place of an id and an
    id in place of a -1, or a row less: each is a different answer, on
    the packed route and on the lexicographic one."""
    rng = np.random.default_rng(2)
    a = rows_of(rng, width)
    b = mutate(kind, rng, a)
    ta, tb = table(NAMES, a), table(NAMES, b)
    assert not lexsort_equal(ta, tb)
    assert not smoke.same_answer(ta, tb)
    assert not smoke.same_answer(tb, ta)


@pytest.mark.parametrize("a,b", [
    # a field one bit too narrow would pack both rows to 8
    ([[0, 8]], [[1, 0]]),
    # ids offset from -1: an unbound id must not borrow the next field
    ([[-1, 5]], [[0, -1]]),
    ([[2 ** 30, 0]], [[0, 2 ** 30]]),
    # 31 bits a column: 62 bits, still packed, at the edge
    ([[2 ** 31 - 1, 0], [0, 1]], [[0, 2 ** 31 - 1], [1, 0]]),
])
def test_rejects_rows_that_a_narrow_field_would_merge(a, b):
    ta, tb = table(["?a", "?b"], a), table(["?a", "?b"], b)
    assert packs(np.concatenate([ta.bindings, tb.bindings]))
    assert not smoke.same_answer(ta, tb)


def test_variables_and_ask_tables():
    """Different variables differ; zero-column (ASK) tables compare by
    their row count."""
    rows = [[1, 2, 3]]
    assert not smoke.same_answer(table(NAMES, rows),
                                 table(["?x", "?p", "?z"], rows))
    ask = [SimpleNamespace(var_names=[], bindings=np.zeros((n, 0), np.int64))
           for n in (0, 1, 1)]
    assert smoke.same_answer(ask[1], ask[2])
    assert not smoke.same_answer(ask[0], ask[1])


@pytest.mark.parametrize("first", [0, 2 ** 40 - 5])
def test_wide_rows_differing_in_the_first_column(first):
    """Three columns of 41 bits do not fit one int64: rows that differ only
    in the first column (in variable-name order), whose field a packed key
    would shift out, still differ."""
    names = ["?a", "?b", "?c"]
    a = table(names, [[first, 0, 2 ** 40], [first + 1, 1, 2 ** 40]])
    b = table(names, [[first + 2, 0, 2 ** 40], [first + 1, 1, 2 ** 40]])
    assert not packs(np.concatenate([a.bindings, b.bindings]))
    assert not smoke.same_answer(a, b)


def test_mesh_phase_rehearsed_on_cpu(monkeypatch):
    """``chip_smoke.mesh_phase`` on a gloo world of one: every GNN cell's
    loss and gradients on the mesh route equal the route without a mesh
    (PNA's against the mesh tie rule), the shuffled edges sorted again by
    the rank, the MoE prefill's logits and expert choices on the EP route
    bit for bit those of the single-device route, the planted expert
    slice off by one changing them; the layouts' checks at reduced
    configs (``mesh lm``, ``mesh decode`` with its splits, ``mesh
    recsys``), each planted fault failing; no kernel launch on the CPU,
    and the process group gone after."""
    import json

    import torch.distributed as dist
    from repro_torch.configs import registry
    from repro_torch.launch.train import reduce_config
    if dist.is_initialized():
        dist.destroy_process_group()
    monkeypatch.setitem(registry.GNN_SHAPES, "minibatch_lg", dict(
        kind="sampled", n_nodes=1000, n_edges=900, d_feat=24,
        batch_nodes=16, fanout=(5, 4)))
    monkeypatch.setattr(smoke, "REDDIT_NODES", 3000)
    monkeypatch.setattr(smoke, "REDDIT_DEGREE", 20)
    sub = smoke.minibatch(smoke.reddit_like(0), 0)
    lines = []
    monkeypatch.setattr(smoke, "log", lines.append)
    cfg = reduce_config(registry.get_spec(smoke.MOE_ARCH))
    recsys = dataclasses.replace(registry.get_spec(smoke.RECSYS_ARCH).config,
                                 vocab_per_field=1000, n_candidates=4096)
    small = {"lm": dict(cfg=reduce_config(registry.get_spec(smoke.LM_ARCH)),
                        batch=2, seq=32),
             "decode": dict(cfg=reduce_config(registry.get_spec(
                 "gemma2-2b")), seq=512, splits=(4, 16), pos=100,
                 local_back=20),
             "recsys": dict(cfg=recsys, bulk=256, train=256, shards=4)}
    launches = smoke.mesh_phase(SimpleNamespace(seed=0, prefill_seq=64),
                                sub, "cpu", moe_cfg=cfg, prompt=64,
                                small=small)
    assert launches == {} and not dist.is_initialized()
    runs = {line.split()[2]: json.loads(line.split(": ", 1)[1].rsplit(
        " in ", 1)[0]) for line in lines if line.startswith("mesh gnn")}
    assert set(runs) == {smoke.GNN_ARCH, *smoke.GNN_ZOO}
    for arch, run in runs.items():
        assert run["ok"] and run["grad_ratio"] <= 1.0, (arch, run)
        assert len(run["mesh_losses"]) == smoke.MESH_STEPS
    assert runs["gcn-cora"]["shuffled_loss_diff"] <= smoke.MESH_LOSS_RTOL
    moe = [json.loads(line.split(": ", 1)[1].rsplit(" in ", 1)[0])
           for line in lines if line.startswith("mesh moe")]
    assert len(moe) == 1 and moe[0]["ok"]
    assert moe[0]["logits_equal"] and moe[0]["routing_equal"]
    assert moe[0]["planted_max_abs_diff"] > 0
    layouts = {line.split()[1]: json.loads(line.split(": ", 1)[1].rsplit(
        " in ", 1)[0]) for line in lines
        if line.split()[:2] in (["mesh", "lm"], ["mesh", "decode"],
                                ["mesh", "recsys"])}
    assert set(layouts) == {"lm", "decode", "recsys"}
    assert all(run["ok"] for run in layouts.values()), layouts
    assert layouts["lm"]["planted_loss_diff"] > smoke.MESH_LOSS_RTOL
    assert layouts["decode"]["logits_equal"]
    last = layouts["decode"]["last"]
    assert last["logits_equal"] and last["max_abs_diff"] == 0.0
    assert last["planted_max_abs_diff"] > last["limit"]
    assert all(len(t) == smoke.MESH_DECODE_ROUNDS
               for t in last["step_s"].values())
    assert all(s["ok"] and s["planted_ratio"] > 1.0
               for s in layouts["decode"]["splits"].values())
    assert layouts["recsys"]["planted_bag_ratio"] > 1.0


def test_gemma2_float32_checks_on_cpu():
    """gemma2-2b's float32 path of ``chip_smoke.py`` at a tiny width with
    its head dim of 256 (the d that takes the three-piece routes on the
    card), on the CPU through the plain versions on both sides: the model
    check at GEMMA_CHECK_LAYERS layers (two local with a window that bites
    inside the prompt, two global; softcaps 50 and 30) and the loss check
    at GRAD_CHECK_LAYERS, each ok with no difference and no launch."""
    from repro_torch.configs import registry
    from repro_torch.launch.train import reduce_config
    tiny = dataclasses.replace(
        reduce_config(registry.get_spec(smoke.GEMMA_ARCH)), d_head=256)
    assert tiny.attn_pattern == "local_global" and tiny.window < 16
    check = smoke.lm_model_check(
        dataclasses.replace(tiny, n_layers=smoke.GEMMA_CHECK_LAYERS),
        seed=0, device="cpu", prompt=16, steps=4)
    assert check["ok"] and check["max_abs_diff"] == 0.0
    assert check["launches"] == {} and check["tf32_control_diff"] is None
    loss = smoke.lm_loss_check(
        dataclasses.replace(tiny, n_layers=smoke.GRAD_CHECK_LAYERS), 0,
        "cpu")
    assert loss["ok"] and loss["loss_diff"] == 0.0
    assert loss["grad_ratio"] == 0.0 and loss["launches"] == {}
    assert loss["layers"] == smoke.GRAD_CHECK_LAYERS
