"""The harness loads neither JAX nor the JAX package, its reference
nothing of the program, and nothing of it reads the JAX package's
benchmarks; without a card it prints no result."""

import shutil
import subprocess
import sys

import pytest

import _tiny

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
PROBE = """
import sys, runpy
sys.path[:0] = [{root!r}, {src!r}]
{body}
bad = sorted(n for n in sys.modules if n.split(".")[0] in {forbidden!r})
print("BAD", bad)
print("PORT", sorted(n for n in sys.modules
                     if n.split(".")[0] == "repro_torch")[:3])
"""


def probe(body):
    code = PROBE.format(root=str(_tiny.ROOT), src=str(_tiny.ROOT / "src"),
                        body=body, forbidden=FORBIDDEN)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=_tiny.ROOT)
    assert out.returncode == 0, out.stderr
    return out.stdout


def test_run_and_every_module_it_loads_leave_jax_out():
    out = probe("runpy.run_path({!r})\n"
                "import portbench.bench, portbench.calibrate\n"
                "import repro_torch.models.transformer".format(
                    str(_tiny.ROOT / "portbench" / "run.py")))
    assert "BAD []" in out
    assert "PORT []" not in out


def test_reference_imports_nothing_of_the_program():
    out = probe("import portbench.reference, portbench.counts, "
                "portbench.inputs, portbench.check")
    assert "BAD []" in out and "PORT []" in out


def test_nothing_reads_the_jax_benchmarks():
    for path in (_tiny.ROOT / "portbench").rglob("*.py"):
        if path.name == "test_portbench_imports.py":
            continue
        text = path.read_text()
        assert "BENCH_" not in text and "benchmarks" not in text, path


@pytest.mark.parametrize("alone", [False, True],
                         ids=["checkout", "benchmark-files-alone"])
def test_no_result_without_a_card_or_the_program(alone, tmp_path):
    root = _tiny.ROOT
    if alone:       # BENCHMARK.json and the files under paths, no program
        root = tmp_path
        shutil.copy(_tiny.ROOT / "BENCHMARK.json", root)
        shutil.copytree(_tiny.ROOT / "portbench", root / "portbench",
                        ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, str(root / "portbench" / "run.py"),
         "--workload", "qwen3-0.6b.prefill-32k", "--seed", str(2 ** 32 + 1),
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=root,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout == ""
