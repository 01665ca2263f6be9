"""On the card: every cell's control (the reference in float8 in the
program's place) fails the cell's limits on three seeds, where the program
passes them. Skips itself without a card.

    python -m pytest -q portbench/tests/test_portbench_control.py
"""

import json

import pytest
import torch

import _tiny
from portbench import calibrate, spec

CELLS = [w["name"] for w in json.loads(
    (_tiny.ROOT / "BENCHMARK.json").read_text())["workloads"]]
SEEDS = (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_where_the_program_passes(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    cell = spec.load_cell(name)
    for seed in SEEDS:
        r = calibrate.readings(cell, seed, 2.0, True, "cuda")
        for key, limit in cell.limits.items():
            assert r["program"][key] <= limit, (seed, r)
        assert any(r["control"][k] > v for k, v in cell.limits.items()), \
            (seed, r)
