"""The port's ``SparqlEndpoint`` against the JAX package's endpoint on the
same data, the port's import boundary, its refusal to run on the CPU unless
asked, and a CPU rehearsal of ``chip_smoke.py``'s serving phase."""

import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.rdf.generator import generate_watdiv_like  # noqa: E402
from repro.rdf.generator import workload_sparql  # noqa: E402
from repro.rdf.sharding import ShardedTripleStore as RSharded  # noqa: E402
from repro.sparql.endpoint import SparqlEndpoint as RSparqlEndpoint  # noqa: E402
from repro.sparql.engine import JaxBackend  # noqa: E402
from repro.sparql.engine import QueryEngine as RQueryEngine  # noqa: E402

from repro_torch.convert import from_reference  # noqa: E402
from repro_torch.sparql.endpoint import SparqlEndpoint  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
ALGEBRA_QUERIES = [
    "SELECT ?x ?c WHERE { ?x <likes> ?p . OPTIONAL { ?x <country> ?c } }",
    "SELECT ?x WHERE { { ?x <likes> ?p } UNION { ?x <follows> ?u } }",
    "SELECT DISTINCT ?g WHERE { ?p <hasGenre> ?g } ORDER BY ?g LIMIT 5",
    "SELECT ?r ?u WHERE { ?r <reviewer> ?u . FILTER (?u != <User0>) }",
    "SELECT ?x ?pp ?y WHERE { ?x ?pp ?y . FILTER (?pp = <subgenreOf>) }",
    "ASK { ?x <subgenreOf> ?y }",
]
COUNTERS = ["queries", "bgp_leaves", "filters_applied", "optional_joins",
            "union_branches", "device_queries", "device_fallbacks",
            "host_transfers", "host_transfer_bytes", "scalar_syncs",
            "scans_executed"]


def _sorted_rows(tbl):
    order = sorted(tbl.var_names)
    rows = tbl.bindings[:, [tbl.var_names.index(v) for v in order]]
    return sorted(map(tuple, rows.tolist()))


def _endpoints(sharded, scale=0.3, seed=3):
    g = generate_watdiv_like(scale=scale, seed=seed)
    ref_store = RSharded.from_store(g.store, 4) if sharded else g.store
    store, d = from_reference(ref_store.to_arrays(), g.dictionary.to_arrays())
    ref = RSparqlEndpoint(ref_store, g.dictionary,
                          engine=RQueryEngine(backend=JaxBackend(bt=512)))
    return g, ref, SparqlEndpoint(store, d, device="cpu")


@pytest.mark.parametrize("sharded", [False, True])
def test_endpoint_matches_jax_endpoint_on_workload(sharded):
    g, ref, port = _endpoints(sharded)
    texts = workload_sparql(g, 6, seed=1)
    for a, b in zip(ref.query_many(texts), port.query_many(texts)):
        assert a.var_names == b.var_names
        assert _sorted_rows(a) == _sorted_rows(b)
    for name in COUNTERS:
        assert getattr(port.stats, name) == getattr(ref.stats, name), name
    assert port.stats.device_queries > 0
    assert port.stats.backend_mode == "torch-cpu"
    # the warm batch is served from the endpoint memo: no transfer at all
    before = port.stats.host_transfers
    port.query_many(texts)
    assert port.stats.host_transfers == before
    assert port.memo_hits == len(set(texts))


def test_endpoint_algebra_matches_jax_endpoint():
    _, ref, port = _endpoints(False)
    for text in ALGEBRA_QUERIES:
        if text.startswith("ASK"):
            assert port.ask(text) == ref.ask(text)
            continue
        a, b = ref.query(text), port.query(text)
        assert a.var_names == b.var_names
        if "ORDER BY" in text:
            assert a.bindings.tolist() == b.bindings.tolist()
        else:
            assert _sorted_rows(a) == _sorted_rows(b)
    assert port.explain(ALGEBRA_QUERIES[0]) == ref.explain(ALGEBRA_QUERIES[0])
    port.clear_cache()
    assert port.query(ALGEBRA_QUERIES[3]).num_matches == \
        ref.query(ALGEBRA_QUERIES[3]).num_matches


def test_default_endpoint_needs_cuda(monkeypatch):
    g, _, port = _endpoints(False, scale=0.2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        SparqlEndpoint(port.store, port.dictionary)
    with pytest.raises(RuntimeError, match="CUDA"):
        SparqlEndpoint(port.store, port.dictionary, device="cuda")
    numpy_ep = SparqlEndpoint(port.store, port.dictionary, backend="numpy")
    assert numpy_ep.stats.backend_mode == "numpy"


def test_port_imports_neither_jax_nor_repro():
    """Every module of the package, and chip_smoke.py and chip_variants.py
    as modules, import without pulling in jax or any module of the JAX
    package."""
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke, chip_variants\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(json.dumps({'modules': names, 'bad': bad}))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["bad"] == []
    want = {"repro_torch.convert", "repro_torch.kernels.ref",
            "repro_torch.kernels.triple_scan",
            "repro_torch.kernels.join_probe", "repro_torch.rdf.generator",
            "repro_torch.sparql.engine", "repro_torch.sparql.device_join",
            "repro_torch.sparql.endpoint", "repro_torch.sparql.algebra",
            "repro_torch.device", "repro_torch.kernels.flash_attention",
            "repro_torch.kernels.decode_attention",
            "repro_torch.models.common", "repro_torch.models.transformer",
            "repro_torch.configs.registry", "repro_torch.configs.qwen3_0_6b",
            "repro_torch.configs.qwen3_1_7b", "repro_torch.configs.gemma2_2b",
            "repro_torch.kernels.segment_mp",
            "repro_torch.kernels.embedding_bag",
            "repro_torch.models.recsys", "repro_torch.models.gnn",
            "repro_torch.data.recsys", "repro_torch.data.graphs",
            "repro_torch.configs.wide_deep", "repro_torch.configs.gcn_cora",
            "repro_torch.core.pattern", "repro_torch.core.induced",
            "repro_torch.core.placement", "repro_torch.core.cost",
            "repro_torch.core.cra", "repro_torch.core.bnb",
            "repro_torch.core.baselines", "repro_torch.core.scheduler",
            "repro_torch.core.parallel", "repro_torch.edge.server",
            "repro_torch.edge.rebalance", "repro_torch.edge.system",
            "repro_torch.sparql.update", "repro_torch.sparql.partial_eval",
            "repro_torch.core.qad", "repro_torch.kernels.qad_solve",
            "repro_torch.runtime.serving", "repro_torch.runtime.admission",
            "repro_torch.runtime.http", "repro_torch.workload.sampler",
            "repro_torch.workload.traffic", "repro_torch.workload.driver",
            "repro_torch.tree", "repro_torch.optim.adamw",
            "repro_torch.optim.compression",
            "repro_torch.runtime.checkpoint",
            "repro_torch.runtime.fault_tolerance",
            "repro_torch.runtime.train_loop", "repro_torch.launch.train"}
    assert want <= set(got["modules"])


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        return importlib.import_module("chip_smoke")
    finally:
        sys.path.remove(str(ROOT))


def test_chip_smoke_refuses_without_cuda(monkeypatch, capsys):
    smoke = _chip_smoke()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert smoke.main([]) != 0
    assert capsys.readouterr().out == ""


def test_chip_variants_refuses_without_cuda_and_matches_the_sources(
        monkeypatch, capsys):
    """The pricing script prints nothing and fails without a card, and
    every variant's text substitution finds its text in the shipped
    kernel sources exactly once."""
    sys.path.insert(0, str(ROOT))
    try:
        variants = importlib.import_module("chip_variants")
    finally:
        sys.path.remove(str(ROOT))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert variants.main() != 0
    assert capsys.readouterr().out == ""
    sources = variants.variant_sources()
    assert set(sources) == set(variants.VARIANTS)
    assert "st.global.cs" not in sources["bag_nohint"].split(
        "__nv_bfloat16, 8")[0]
    assert sources["bag_evictlast"].count("L2::evict_last") == 2
    assert "break;" not in sources["qad_noexit"].split(
        "void project(")[1].split("template")[0]
    assert sources["qad_exact"].count("void project(") == 1
    assert sources["qad_exact"].count("void project_bisect(") == 1


@pytest.mark.parametrize("sharded", [False, True])
def test_chip_smoke_serving_phase_on_cpu(sharded):
    """The serving phase's checks (answers vs the numpy backend, 2 cold and
    0 warm transfers, capacity errors on both backends) at a small scale,
    with the plain torch versions on the CPU."""
    smoke = _chip_smoke()
    from repro_torch.rdf.generator import generate_watdiv_like as tgen
    from repro_torch.rdf.sharding import ShardedTripleStore
    gen = tgen(scale=0.5, seed=0)
    store = ShardedTripleStore.from_store(gen.store, 4) if sharded \
        else gen.store
    res = smoke.run_phase("cpu", gen, store, 12, 2000, "cpu")
    assert res["host_transfers_cold"] == 2
    assert res["host_transfers_warm"] == 0
    assert res["launches"] == {}           # the CPU never launches a kernel
    assert res["backend_mode"] == "torch-cpu"
