#!/usr/bin/env python3
"""The control on the card, at a cell's own size, and the program's own
readings beside it, seed by seed:

    python3 benchmark/tests/control.py --workload <cell> --seeds 1,2,3
        [--seconds 1]

For each seed, one run of the cell (set-up, a window of ``--seconds``,
which holds one plan at least), judged twice by the benchmark's own
comparison (``report.finish``): once as the run made it, and once with
the control in the program's place (``check.control_plan``: the
reference with its barycenters formed from TF32-rounded operands, the
nearest precision below the float32, TF32 off, that the configuration
states). One JSON line a seed: each side's ``correct`` and numbers, and
the limits; the control has to come out not correct. The benchmark's own
runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.harness import cell as run_cell  # noqa: E402
from benchmark.harness import report, spec  # noqa: E402
from benchmark.reference import check, models  # noqa: E402


def judged(cell, seed: int, out: dict, device) -> tuple:
    """A run's output ``out`` judged by the benchmark's comparison as it
    ran, and with the control in the program's place: (the result line,
    the control's result line)."""
    line, _ = report.finish(cell, seed, out, device, False)
    c = cell.config
    p, t = run_cell.drawn(seed, len(out["results"]), c["Ndiffuse"] - 1)
    results = list(out["results"])
    results[p] = check.control_plan(
        models.load(c["env"], device), c,
        run_cell.plan_seeds(cell.traffic, seed, p), results[p], t, device)
    control, _ = report.finish(cell, seed, dict(out, results=results),
                               device, False)
    return line, control


def readings(cell, seed: int, seconds: float) -> dict:
    """One run of ``cell`` at ``seed`` on the card: each side's
    ``correct`` and numbers, and the limits."""
    started = run_cell.Started()
    if cell.chips > 1:
        out = run_cell.run_mesh(cell, seed, seconds, False, started)
    else:
        out = run_cell.run_single(cell, seed, seconds, False, "cuda:0",
                                  started)
    line, control = judged(cell, seed, out, "cuda:0")

    def numbers(x):
        return {k: v["value"] for k, v in x["checks"].items()}

    return dict(cell=cell.name, seed=seed, correct=line["correct"],
                program=numbers(line), control_correct=control["correct"],
                control=numbers(control), limits=cell.limits,
                plan_s=line["metrics"].get("plan_s", {}).get("value"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 benchmark/tests/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    cell = spec.load(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(cell, seed, args.seconds)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
