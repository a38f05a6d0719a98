#!/usr/bin/env python3
"""One run of one cell of the benchmark, on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

Set-up, then whole plans of the cell's entry back to back for
``--seconds`` (the first always runs, another only while the last one's
wall fits in what is left), then the reference's check of one plan. The
last line of standard output is the result (``harness/report.py``); the
last lines of standard error are the numbers compared, each with its
limit. With ``--trace 1`` the window runs under ``torch.profiler`` and
the result gives the cell's per-layer metrics and a breakdown instead of
its end-to-end ones.

No card, or fewer than the cell asks for, is exit 2 with no result; a
failure on the way (a build, a launch, a missing file, a module of JAX or
of the JAX package loaded) is exit 1 with no result.
"""

from __future__ import annotations

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]
sys.path.insert(0, ROOT)

import argparse  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402
import traceback  # noqa: E402

from benchmark.harness.cell import Started  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="python3 benchmark/run.py",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    started = Started()
    args = parse(argv)
    import torch

    from benchmark.harness import cell as run_cell
    from benchmark.harness import report, spec

    try:
        cell = spec.load(args.workload)
    except spec.SpecError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 1
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell.chips:
        print(f"benchmark: cell {cell.name} needs {cell.chips} CUDA "
              f"card(s); found {cards}", file=sys.stderr)
        return 2
    trace = bool(args.trace)
    try:
        if cell.chips > 1:
            out = run_cell.run_mesh(cell, args.seed, args.seconds, trace,
                                    started)
        else:
            out = run_cell.run_single(cell, args.seed, args.seconds, trace,
                                      "cuda:0", started)
        t0 = time.perf_counter()
        line, lines = report.finish(cell, args.seed, out, "cuda:0", trace)
    except Exception:  # noqa: BLE001 - the run's boundary: no result
        traceback.print_exc()
        return 1
    print(f"benchmark: {cell.name} seed {args.seed}: set-up "
          f"{out['setup_s']:.3f} s, window {out['span_s']:.3f} s "
          f"({len(out['walls'])} plans), reference "
          f"{time.perf_counter() - t0:.3f} s", file=sys.stderr)
    sys.stderr.write("".join(f"{x}\n" for x in lines))
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
