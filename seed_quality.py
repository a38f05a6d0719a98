#!/usr/bin/env python3
"""The 8-seed quality check of the PyTorch/CUDA port on one CUDA card.

    python3 seed_quality.py [--only hopper,pushT] [--out DIR]

For each row below it runs the port's CLI as a user would,
``python -m mbd_tpu_torch.cli.run_mbd --env_name <env> --mode seed
--batch_seeds`` at the env's recommended config (in this process, through
``run_mbd.main``), and then seed 0 alone (``--mode single --not_render``).
Each 8-seed mean is held against the JAX package's (``docs/RESULTS.json``,
``docs/RESULTS_BASELINES.json``) by the two-sample bound

    |mean_port − mean_JAX| ≤ 3·√((σ_JAX² + σ_port²)/8),

the seeds of the two being unpaired (other random streams). For the demo
rows the final plans' demo log-densities (the kernel's demo mode) are
held against JAX's the same way (car2d's from its analytic rollout,
the others' from the kernel's demo mode). JAX's pushT baselines failed (their rows
in ``docs/RESULTS_BASELINES.json`` hold ``"failed": true``), so those rows
report the port's numbers with no bound. The kernels are built before any
clock starts. It prints one line per row and writes them all to
``<out>/seed_quality.json``; it exits 1 if a row misses its bound.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
# (row, env, extra CLI flags, the reference's file and key)
ROWS = [("hopper", "hopper", [], "hopper"),
        ("walker2d", "walker2d", [], "walker2d"),
        ("halfcheetah", "halfcheetah", [], "halfcheetah"),
        ("ant", "ant", [], "ant"),
        ("cartpole", "cartpole", [], "cartpole"),
        ("pushT", "pushT", [], "pushT"),
        ("humanoidstandup", "humanoidstandup", [], "humanoidstandup"),
        ("humanoidtrack", "humanoidtrack", [], "humanoidtrack"),
        ("humanoidtrack+demo", "humanoidtrack", ["--enable_demo"],
         "humanoidtrack+demo"),
        ("humanoidtrack_walk+demo", "humanoidtrack_walk", ["--enable_demo"],
         "humanoidtrack_walk+demo"),
        ("humanoidrun", "humanoidrun", [], "humanoidrun"),
        ("car2d+demo", "car2d", ["--enable_demo"], "car2d+demo"),
        ("car2d", "car2d", [], "car2d")]
ROWS += [(f"{env} {m}", env, ["--algo", "path_integral",
                              "--update_method", m], f"{env}/{m}")
         for env in ("hopper", "pushT", "car2d")
         for m in ("mppi", "cem", "cma-es")]


def reference(key):
    """JAX's 8-seed row: mean, std, and the demo log-density's if any
    (``chip_smoke.py`` reads its rows here too)."""
    if "/" in key:
        env, method = key.split("/")
        with open(os.path.join(ROOT, "docs", "RESULTS_BASELINES.json")) as f:
            return json.load(f)[env]["baselines"][method]
    with open(os.path.join(ROOT, "docs", "RESULTS.json")) as f:
        return json.load(f)[key]


def bound(ref_mean, ref_std, values):
    """The values' mean and std, and the bound against JAX's (None where
    JAX's run of the row failed: ``ok`` is then None)."""
    mean = sum(values) / len(values)
    std = math.sqrt(sum((v - mean) ** 2 for v in values) / len(values))
    if ref_mean is None:
        return dict(mean=mean, std=std, ref_mean=None, ok=None)
    b = 3.0 * math.sqrt((ref_std ** 2 + std ** 2) / len(values))
    return dict(mean=mean, std=std, ref_mean=ref_mean, ref_std=ref_std,
                bound=b, ok=abs(mean - ref_mean) <= b)


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--only", default="", help="comma-separated rows")
    p.add_argument("--out", default=os.path.join(ROOT, "chiprun_out"))
    args = p.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("seed_quality: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from mbd_tpu_torch import envs
    from mbd_tpu_torch.cli import run_mbd
    from mbd_tpu_torch.ops import rollout_cuda as rc
    from mbd_tpu_torch.rollout.rollout import rollout_us

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    rows = [r for r in ROWS
            if not args.only or r[0] in args.only.split(",")]
    # the kernel of every physics env (car2d, analytic, has none)
    names = sorted({env for _, env, _, _ in rows if env != "car2d"})
    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        list(pool.map(lambda n: rc.build(envs.get_env(n)), names))

    out, failed = [], []
    tmp = os.path.join(args.out, "seed_quality_cli")
    for row, env_name, flags, key in rows:
        argv = ["--env_name", env_name, "--chunk_size", "0",
                "--results_dir", tmp] + flags
        rc.LAUNCHES = 0
        res = run_mbd.main(argv + ["--mode", "seed", "--batch_seeds"])
        launches = rc.LAUNCHES
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_mbd.main(argv + ["--mode", "single", "--not_render"])
        torch.cuda.synchronize()
        serial_s = time.perf_counter() - t0
        ref = reference(key)
        rec = dict(row=row, rewards=res["rewards"],
                   diverged=res["diverged"], wall_s=res["wall_s"],
                   serial_seed0_s=serial_s, launches=launches,
                   reward=bound(ref.get("rew_mean"), ref.get("rew_std"),
                                res["rewards"]))
        if "--enable_demo" in flags:
            env = envs.get_env(env_name)
            logpd = []
            for s, plan in enumerate(res["plans"]):
                state = env.reset(torch.Generator("cuda").manual_seed(s))
                plan = torch.tensor(plan, device="cuda")
                if env_name == "car2d":
                    xs = rollout_us(env, state, plan)[1]
                    logpd.append(float(env.eval_xref_logpd(xs)))
                    continue
                logpd.append(float(rc.rollout_rewards_cuda(
                    env, state, plan[None], demo=True)[2][0]))
            rec["logpd"] = bound(ref["xref_logpd_mean"],
                                 ref["xref_logpd_std"], logpd)
            rec["logpd"]["values"] = logpd
        for k in ("reward", "logpd"):
            if k in rec and rec[k]["ok"] is False:
                failed.append(f"{row} {k}")
        out.append(rec)
        print("ROW " + json.dumps(rec), flush=True)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "seed_quality.json"), "w") as f:
        json.dump(dict(card=card, rows=out), f, indent=1)
    print(f"rows outside the bound: {failed or 'none'}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
