#!/usr/bin/env python3
"""Where one plan's device time goes, by ``torch.profiler``.

    python3 profile_plan.py [--env hopper] [--seed 0]
    python3 profile_plan.py --rl [--env pushT]

Runs ``mbd.plan`` on the env at its ``recommended_config`` (hopper:
2048 / 50 / 100; humanoidrun: 8192 / 50 / 300; humanoidtrack: 2048 / 50 /
100 with its demo; pushT: 2048 / 40 / 200) twice on the first CUDA
card: once to build the kernel and warm up, once under
``torch.profiler``. Prints the card's name and
power limit, the traced plan's wall time, the union of the device's
kernel intervals over that wall time (its busy share) and the device time
of the busiest kernels.

With ``--rl`` it traces a short RL training run instead, at the env's
reference config (``mbd_tpu_torch/rl/train.py``): PPO (pushT, ...) for 2
iterations and one eval, SAC (hopper) for its prefill and 4 iterations
and one eval; besides the busy
share it prints the wall per iteration and the state-out kernel's
launches and device time, whose difference is the RL layer's host time.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


def rl_run(torch, env, name):
    """A function that trains ``name`` briefly at its reference config
    (PPO: 2 iterations and one eval; SAC: the prefill and 4 iterations and
    one eval) and returns (wall, the trainer's last eval); the run's
    history is kept on it."""
    from mbd_tpu_torch.rl import ppo, sac, train

    if name in train.SAC_CONFIGS:
        # the prefill and 4 iterations of 64 updates: a trace of all 64
        # iterations holds millions of events
        module, hp = sac, dict(train.SAC_CONFIGS[name])
        hp.update(num_timesteps=hp["min_replay_size"] + 4 * hp["num_envs"],
                  num_evals=1)
        cfg = sac.SACConfig(**hp)
    else:
        module, hp = ppo, dict(train.PPO_CONFIGS[name])
        hp.update(num_timesteps=2 * hp["num_envs"] * hp["unroll_length"],
                  num_evals=1)
        cfg = ppo.PPOConfig(**hp)

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, history = module.train(env, cfg)
        torch.cuda.synchronize()
        run.history = history
        return time.perf_counter() - t0, history[-1]["eval/episode_reward"]
    return run


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--env", default="hopper")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--top", type=int, default=8)
    ap.add_argument("--rl", action="store_true",
                    help="trace RL training at the env's reference config")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_plan: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from mbd_tpu_torch import envs
    from mbd_tpu_torch.planners import mbd
    from mbd_tpu_torch.utils import profiling

    gpu = profiling.card()
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

    what = "plan"
    if args.rl:
        run, what = rl_run(torch, env, args.env), "RL training"
    wall, final = run()
    print(f"{what} (warm-up, kernel build included): {wall:.3f} s, "
          f"final {final:.6f}", flush=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall, final = run()

    kernels = profiling.device_events(prof)
    if not kernels:
        raise RuntimeError("the trace holds no device time")
    busy = profiling.busy_us((e.time_range.start, e.time_range.end)
                             for e in kernels)
    per_name = profiling.kernel_totals(kernels)

    print(f"traced {args.env} {what} on {gpu}: wall {wall:.6f} s, final "
          f"{final:.6f}, device busy {busy / 1e6:.6f} s, busy share "
          f"{busy / 1e6 / wall:.6f}")
    if args.rl:
        count, us = profiling.named(per_name, "rollout_kernel")
        it = run.history
        per_iter = sum(h["train/wall_s"] for h in it) / sum(
            h["train/iterations"] for h in it)
        print(f"  {count} state-out launches, {us / 1e3:.3f} ms of device "
              f"time ({us / max(count, 1):.2f} µs each); wall per "
              f"iteration {per_iter:.6f} s")
    for name, (count, us) in sorted(per_name.items(),
                                    key=lambda kv: -kv[1][1])[:args.top]:
        print(f"  {us / 1e3:12.3f} ms  {count:5d}×  {name[:100]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
