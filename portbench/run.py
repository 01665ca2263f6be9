"""Run one cell of the port's benchmark once and print its result.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout on a machine with the cell's cards. The
last line of standard output is the result's JSON object; the numbers the
check compared, each beside its limit, are the last lines of standard
error. See ``portbench/README.md``.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name for name in sys.modules
                   if name.split(".")[0] in FORBIDDEN})


def power_limit() -> str:
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"unknown ({e})"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    here = str(ROOT / "portbench")
    sys.path[:] = [str(ROOT / "src"), str(ROOT)] + [
        d for d in sys.path if str(Path(d or ".").resolve()) != here]
    from portbench import caches
    caches(ROOT)
    from portbench import bench, spec

    cell = spec.load_cell(args.workload, ROOT)
    import torch
    print(f"imports {time.perf_counter() - STARTED:.3f}s", file=sys.stderr)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    out, read = bench.run_cell(cell, args.seed, args.seconds,
                               bool(args.trace), "cuda", STARTED)
    print(f"device {power_limit()}", file=sys.stderr)
    found = forbidden_modules()
    if found:
        print(f"the run loaded {', '.join(found)}", file=sys.stderr)
        return 4
    print("read " + " ".join(f"{k} {v}" for k, v in read.items()),
          file=sys.stderr)
    for name, c in out["check"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
