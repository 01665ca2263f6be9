"""BENCHMARK.json and the files it names: the contract's keys, names and
units, each metric's cells, and a metric added from files alone."""

import json
import re
import shutil

import pytest

import _tiny
from portbench import spec

BENCH = json.loads((_tiny.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
HERE = _tiny.ROOT / "portbench"


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}


def test_names_units_and_entry_keys():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = ([c["name"] for c in BENCH["configs"]]
             + [w["name"] for w in BENCH["workloads"]]
             + [m["name"] for m in metrics]
             + [w["traffic"] for w in BENCH["workloads"]])
    assert all(NAME.match(n) for n in names), names
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_each_metric_moves_what_its_cells_report():
    for m in BENCH["per_layer"]:
        moved = [e for e in BENCH["end_to_end"] if e["name"] == m["moves"]]
        assert moved, m["name"]
        for cell in m["workloads"]:
            assert spec.reports(moved[0], cell, set()), (m["name"], cell)
    for w in BENCH["workloads"]:
        cell = spec.load_cell(w["name"])
        assert "setup_s" in {m["name"] for m in cell.end_to_end}
        assert len(cell.end_to_end) >= 2 and cell.per_layer


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_file_is_found_by_name(w):
    cell = spec.load_cell(w["name"])
    assert cell.traffic["kind"] == "prefill"
    assert cell.limits
    for m in cell.end_to_end + cell.per_layer:
        assert callable(spec.reader(m["name"]))
    conf = [c for c in BENCH["configs"] if c["name"] == w["config"]][0]
    assert (_tiny.ROOT / conf["file"]).exists()
    assert cell.config["source"] == conf["source"]
    assert cell.config["reduced"] == conf["reduced"]


def test_a_metric_is_added_from_files_alone(tmp_path):
    """A copy of the benchmark gains another per-layer metric of the
    4k cell by a new reader file and a new entry; no existing file of
    the folder changes."""
    root = tmp_path / "checkout"
    shutil.copytree(HERE, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    cells = ["qwen3-0.6b.prefill-4k"]
    bench["per_layer"].append({
        "name": "steps_per_s.prefill", "unit": "1/s", "better": "higher",
        "source": "host_clock", "layer": "serving loop",
        "moves": "prefill_tokens_per_s", "workloads": cells})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*")
              if p.is_file()}
    (root / "portbench" / "metrics" / "steps_per_s.prefill.py").write_text(
        "def read(run):\n    return len(run.window.steps) / "
        "run.window.seconds\n")
    for p, data in before.items():
        assert p.read_bytes() == data
    here = root / "portbench"
    cell = spec.load_cell(cells[0], root, here)
    assert "steps_per_s.prefill" in {m["name"] for m in cell.per_layer}
    read = spec.reader("steps_per_s.prefill", here)

    class W:
        steps, seconds = [0] * 30, 2.0

    class R:
        window = W()

    assert read(R()) == 15.0
    other = spec.load_cell("qwen3-0.6b.prefill-32k", root, here)
    assert "steps_per_s.prefill" not in {m["name"] for m in other.per_layer}
