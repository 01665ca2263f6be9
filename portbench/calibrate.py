"""The readings a cell's limits are set from, many seeds in one process.

    python3 portbench/calibrate.py --workload <name> --seconds <s> \\
        --seeds <n> [<n> ...] [--control]

For each seed: set-up, a window of ``--seconds`` through the timed path,
and the check's numbers of the program; with ``--control`` also those of
the control, the reference in float8 in the program's place, on the same
sample. One JSON line a seed on standard output. The benchmark's own runs
never run this.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def readings(cell, seed: int, seconds: float, control: bool, device,
             program=None) -> dict:
    """The program's numbers on ``seed`` (and the control's)."""
    import torch
    from portbench import check, inputs, serve
    from portbench.reference import Model
    m = Model.from_config(cell.config)
    cfg = serve.lm_config(m, cell.config)
    loop = serve.Loop(cfg, m, cell.traffic, inputs.weights(m, seed, device),
                      seed, device, program)
    loop.warm()
    win = loop.run(seconds, serve.Spans())
    kept = loop.kept_cache(win)
    loop.free()
    del loop
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    out = {"seed": seed, "steps": len(win.steps)}
    out["program"] = check.compare(m, cell.traffic, win, kept, seed, device,
                                   cell.limits)[2]
    if control:
        out["control"] = check.compare(m, cell.traffic, win, kept, seed,
                                       device, cell.limits, control=True)[2]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", action="store_true")
    args = p.parse_args(argv)
    here = str(ROOT / "portbench")
    sys.path[:] = [str(ROOT / "src"), str(ROOT)] + [
        d for d in sys.path if str(Path(d or ".").resolve()) != here]
    from portbench import caches, spec
    caches(ROOT)
    cell = spec.load_cell(args.workload, ROOT)
    for seed in args.seeds:
        t = time.perf_counter()
        out = readings(cell, seed, args.seconds, args.control, "cuda")
        out["seconds"] = time.perf_counter() - t
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
