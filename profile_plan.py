#!/usr/bin/env python3
"""Where one plan's device time goes, by ``torch.profiler``.

    python3 profile_plan.py [--env hopper] [--seed 0] [--seeds S]
                            [--cards K] [--out DIR]
    python3 profile_plan.py --rl [--env pushT]

Runs ``mbd.plan`` on the env at its ``recommended_config`` (hopper:
2048 / 50 / 100; humanoidrun: 8192 / 50 / 300; humanoidtrack: 2048 / 50 /
100 with its demo; pushT: 2048 / 40 / 200) twice on the first CUDA
card: once to build the kernel and warm up, once under
``torch.profiler`` (``utils/profiling.py``'s ``trace``, exported as a
Chrome trace to ``DIR/trace.json``, by default
``results/profile_plan``). ``--seeds S``:
``mbd.plan_batch`` of S seeds instead; ``--cards K``: the plan over K
NCCL ranks, one a card, each traced (``DIR/rank<r>/trace.json``) and
reported. Prints the card's name and
power limit, the traced plan's wall time, the union of the device's
kernel intervals over that wall time (its busy share), the device time
of the busiest kernels, the card's idle time by program span (each idle
gap named as the benchmark's breakdown names it,
``benchmark/harness/trace.py``'s ``host_op``, among the program's spans:
the innermost one open over it) and the host seconds of each program
span (``mbd.prologue``, ``mbd.step``, ...).

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


def idle_by_span(prof) -> dict:
    """The card's idle µs in a finished ``torch.profiler`` trace, from the
    first program span's start to the last one's end, by the program span
    that the benchmark's ``host_op`` names each idle gap by."""
    import numpy as np
    import torch

    from benchmark.harness import trace as tr
    from mbd_tpu_torch.utils import profiling

    spans = [e for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CPU
             and e.name.startswith(profiling.SPAN_PREFIXES)]
    if not spans:
        return {}
    lo = np.array([e.time_range.start for e in spans])
    hi = np.array([e.time_range.end for e in spans])
    busy = tr.merged((e.time_range.start, e.time_range.end)
                     for e in profiling.device_events(prof))
    out = {}
    for gap in tr.gaps(busy, float(lo.min()), float(hi.max())):
        near = np.flatnonzero((lo < gap[1]) & (hi > gap[0]))
        name = tr.host_op([spans[i] for i in near], gap)
        out[name] = out.get(name, 0.0) + gap[1] - gap[0]
    return out


def traced(args, device, mesh=None) -> str:
    """The warm-up and the traced run on ``device`` (over ``mesh``), as
    the lines to print."""
    import torch

    from mbd_tpu_torch import envs
    from mbd_tpu_torch.planners import mbd
    from mbd_tpu_torch.utils import profiling

    env = envs.get_env(args.env, device=device)
    # an env with a demo (humanoidtrack) plans with it
    cfg = mbd.recommended_config(args.env, mbd.MBDConfig(
        enable_demo=getattr(env, "xref", None) is not None))

    def run():
        gens = [torch.Generator(device).manual_seed(args.seed + s)
                for s in range(args.seeds)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if args.seeds > 1:
            res = mbd.plan_batch(env, cfg, gens, mesh=mesh)
        else:
            res = mbd.plan(env, cfg, gens[0], mesh=mesh)
        final = float(torch.as_tensor(res.final_reward).mean())
        torch.cuda.synchronize()
        return time.perf_counter() - t0, final

    what = "plan" if args.seeds == 1 else f"plan_batch of {args.seeds}"
    if args.rl:
        run, what = rl_run(torch, env, args.env), "RL training"
    wall, final = run()
    lines = [f"{what} (warm-up, kernel build included): {wall:.3f} s, "
             f"final {final:.6f}"]
    out = args.out or os.path.join(ROOT, "results", "profile_plan")
    if mesh is not None:
        out = os.path.join(out, f"rank{mesh.rank}")
    profiling.clear()
    with profiling.trace(out) as prof:
        wall, final = run()
    rec = profiling.recorded()
    profiling.clear()

    kernels = profiling.device_events(prof)
    if not kernels:
        raise RuntimeError("the trace holds no device time")
    busy = profiling.busy_us((e.time_range.start, e.time_range.end)
                             for e in kernels)
    per_name = profiling.kernel_totals(kernels)

    lines.append(
        f"traced {args.env} {what} on {profiling.card()}: wall {wall:.6f} "
        f"s, final {final:.6f}, device busy {busy / 1e6:.6f} s, busy share "
        f"{busy / 1e6 / wall:.6f}; trace {out}/{profiling.TRACE_FILE}")
    if args.rl:
        count, us = profiling.named(per_name, "rollout_kernel")
        it = run.history
        per_iter = sum(h["train/wall_s"] for h in it) / sum(
            h["train/iterations"] for h in it)
        lines.append(f"  {count} state-out launches, {us / 1e3:.3f} ms of "
                     f"device time ({us / max(count, 1):.2f} µs each); wall "
                     f"per iteration {per_iter:.6f} s")
    for name, (count, us) in sorted(per_name.items(),
                                    key=lambda kv: -kv[1][1])[:args.top]:
        lines.append(f"  {us / 1e3:12.3f} ms  {count:5d}×  {name[:100]}")
    idle = sorted(idle_by_span(prof).items(), key=lambda kv: -kv[1])
    lines.append(f"  idle by program span, ms (of "
                 f"{sum(v for _, v in idle) / 1e3:.3f}): " + ", ".join(
                     f"{k} {v / 1e3:.3f}" for k, v in idle))
    host, calls = {}, {}
    for s in rec.spans:
        host[s.name] = host.get(s.name, 0.0) + s.host_s
        calls[s.name] = calls.get(s.name, 0) + 1
    lines.append("  host s by program span: " + ", ".join(
        f"{k} {v:.6f} (x{calls[k]})" for k, v in host.items()))
    gathers = [s.device_ms for s in rec.spans if s.name == "mesh.gather"]
    if gathers:
        lines.append(f"  mesh.gather: {len(gathers)} calls, device ms "
                     f"{sum(gathers):.3f}")
    return "\n".join(lines)


def _rank(mesh, args):
    return traced(args, mesh.device, mesh)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--env", default="hopper")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seeds", type=int, default=1)
    ap.add_argument("--cards", type=int, default=1)
    ap.add_argument("--out", default=None)
    ap.add_argument("--top", type=int, default=8)
    ap.add_argument("--rl", action="store_true",
                    help="trace RL training at the env's reference config")
    args = ap.parse_args()
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < args.cards:
        print(f"profile_plan: needs {args.cards} CUDA device(s)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    if args.cards == 1:
        print(traced(args, "cuda"))
        return 0
    from mbd_tpu_torch.parallel import start_ranks

    for r, text in enumerate(start_ranks(_rank, args.cards, args,
                                         backend="nccl",
                                         device=None).wait()):
        print(f"rank {r}:\n{text}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
