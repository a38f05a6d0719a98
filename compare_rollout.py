#!/usr/bin/env python3
"""The rollout kernel of this checkout against another version of it, on
one CUDA card, at the shapes of the four planning paths.

    python3 compare_rollout.py [--other DIR] [--groups 8,16] [--samples N]
                               [--reps 3]

DIR holds the other version's ``ops/rollout_cuda.py`` and
``csrc/rollout.cu`` (for example a parent commit's, unpacked under
``build/``, which git ignores). For humanoidrun 8192 × 50, humanoidtrack
2048 × 50 with the demo, hopper 2048 × 50 and pushT 2048 × 40, from the
env's reset (seed 0) with uniform random controls (seed 1), or at
``--samples`` N samples on every path, it times by
CUDA events, in turns, the other kernel, this one built for each G of
``--groups`` (default the env's own, ``kernel_group``), this
one again and the other again (each the mean of ``--reps`` launches after
one warm-up), and checks that every output of this kernel, at every G,
equals the first's and the other's bit for bit. It prints the card's name
and power limit, each build's nvcc seconds and layout, the times, and one
JSON line. Without ``--other`` it times this kernel alone.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
# model: (N, H, demo)
PATHS = {"humanoidrun": (8192, 50, False), "humanoidtrack": (2048, 50, True),
         "hopper": (2048, 50, False), "pushT": (2048, 40, False)}


def load_other(path):
    """The other version's wrapper module, as a module of this package so
    that its relative imports resolve here."""
    spec = importlib.util.spec_from_file_location(
        "mbd_tpu_torch.ops.rollout_cuda_other",
        os.path.join(path, "ops", "rollout_cuda.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", default=None)
    ap.add_argument("--groups", default="",
                    help="comma-separated G to build this kernel for")
    ap.add_argument("--samples", type=int, default=0,
                    help="N on every path (default each path's own)")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compare_rollout: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from mbd_tpu_torch import envs
    from mbd_tpu_torch.ops import rollout_cuda as rc

    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(gpu, flush=True)
    other = load_other(os.path.abspath(args.other)) if args.other else None
    # own env objects per version: each wrapper caches its build on the
    # model
    mine = {n: envs.get_env(n, device="cuda") for n in PATHS}
    theirs = {n: envs.get_env(n, device="cuda") for n in PATHS}
    pool = ThreadPoolExecutor(2 * len(PATHS))
    with open(os.path.join(rc.CSRC, "rollout.cu")) as f:
        src = f.read()
    groups = {n: [int(g) for g in args.groups.split(",") if g]
              or [e.kernel_group] for n, e in mine.items()}
    built = {n: {G: pool.submit(rc.compile_library, src,
                                rc.model_header(e, G)) for G in groups[n]}
             for n, e in mine.items()}
    built_other = {n: pool.submit(other.build, e)
                   for n, e in theirs.items()} if other else {}

    def time_ms(fn):
        fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(args.reps):
            out = fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / args.reps, out

    gen = torch.Generator("cuda").manual_seed(1)
    results = []
    for name, (N, H, demo) in PATHS.items():
        N = args.samples or N
        b = {G: f.result() for G, f in built[name].items()}
        env = mine[name]
        layout = {G: lib.attrs(N) for G, lib in b.items()}
        for G, a in layout.items():
            print(f"build {name} G={G}: nvcc {b[G].seconds:.1f} s; layout "
                  f"at N={N}: {a}", flush=True)
        state0 = env.reset(torch.Generator("cuda").manual_seed(0))
        Y0s = 2 * torch.rand((N, H, env.action_size), generator=gen,
                             device="cuda") - 1
        row = dict(name=name, N=N, H=H, demo=demo,
                   picked=env.kernel_group,
                   nvcc_s={str(G): lib.seconds for G, lib in b.items()},
                   layout={str(G): a for G, a in layout.items()})

        def run_other():
            return other.rollout_rewards_cuda(theirs[name], state0, Y0s,
                                              demo=demo)

        ref = None
        if other:
            ob = built_other[name].result()
            row["other_nvcc_s"] = ob.seconds
            row["other_layout"] = ob.attrs()
            ms, ref = time_ms(run_other)
            row["other_ms"] = [ms]
        row["ms"] = {str(G): [] for G in b}
        equal = True
        for _ in range(2):
            for G, lib in b.items():
                ms, out = time_ms(lambda: lib.run(env, state0, Y0s,
                                                  demo=demo))
                row["ms"][str(G)].append(ms)
                if ref is None:
                    ref = out
                equal &= all(torch.equal(x, y) for x, y in zip(out, ref))
        row["equal"] = equal
        if other:
            row["other_ms"].append(time_ms(run_other)[0])
        shown = "; ".join(f"G={G} " + " / ".join(f"{m:.3f}" for m in v)
                          for G, v in row["ms"].items())
        print(f"time {name} {N}x{H} demo={demo}: {shown} ms (the wrapper "
              f"picks G={row['picked']})"
              + (f"; other {row['other_ms'][0]:.3f} / "
                 f"{row['other_ms'][1]:.3f} ms" if other else "")
              + f"; bit for bit equal: {equal} on {gpu}", flush=True)
        results.append(row)
    pool.shutdown()
    print(json.dumps({"card": gpu, "rollouts": results}))
    if not all(r["equal"] for r in results):
        print("compare_rollout: the kernels differ", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
