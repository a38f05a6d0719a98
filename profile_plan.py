#!/usr/bin/env python3
"""Where one plan's device time goes, by ``torch.profiler``.

    python3 profile_plan.py [--env hopper] [--seed 0]

Runs ``mbd.plan`` on the env at its ``recommended_config`` (hopper:
2048 / 50 / 100; humanoidrun: 8192 / 50 / 300; humanoidtrack: 2048 / 50 /
100 with its demo; pushT: 2048 / 40 / 200) twice on the first CUDA
card: once to build the kernel and warm up, once under
``torch.profiler``. Prints the card's name and
power limit, the traced plan's wall time, the union of the device's
kernel intervals over that wall time (its busy share) and the device time
of the busiest kernels.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from collections import defaultdict

ROOT = os.path.dirname(os.path.abspath(__file__))


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--env", default="hopper")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--top", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_plan: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from mbd_tpu_torch import envs
    from mbd_tpu_torch.planners import mbd

    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    env = envs.get_env(args.env, device="cuda")
    # an env with a demo (humanoidtrack) plans with it
    cfg = mbd.recommended_config(args.env, mbd.MBDConfig(
        enable_demo=getattr(env, "xref", None) is not None))

    def run():
        gen = torch.Generator("cuda").manual_seed(args.seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = mbd.plan(env, cfg, gen)
        final = float(res.final_reward)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, final

    wall, final = run()
    print(f"plan (warm-up, kernel build included): {wall:.3f} s, "
          f"final_reward {final:.6f}", flush=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall, final = run()

    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("the trace holds no device time")
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_lo, cur_hi = 0.0, *spans[0]
    for lo, hi in spans[1:]:
        if lo > cur_hi:
            busy += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    busy += cur_hi - cur_lo
    per_name = defaultdict(lambda: [0, 0.0])
    for e in kernels:
        per_name[e.name][0] += 1
        per_name[e.name][1] += e.time_range.elapsed_us()

    print(f"traced {args.env} plan on {gpu}: wall {wall:.6f} s, final_reward "
          f"{final:.6f}, device busy {busy / 1e6:.6f} s, busy share "
          f"{busy / 1e6 / wall:.6f}")
    for name, (count, us) in sorted(per_name.items(),
                                    key=lambda kv: -kv[1][1])[:args.top]:
        print(f"  {us / 1e3:12.3f} ms  {count:5d}×  {name[:100]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
