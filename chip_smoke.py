#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mbd_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code 1):

1. the card's name and power limit; the rollout kernel
   (``csrc/rollout.cu``) starts to build for every model it serves, one
   nvcc each, all at once in the background (the humanoids' builds took
   216–333 s each on an H100 host's 8 cores, the others' under 60 s);
2. while they build, the plain version (the torch engine) runs the inputs
   of every comparison on the card: all seven models at N = 2048, H = 4;
   hopper at a ragged N = 2047, walker2d with per-sample initial states;
   humanoidrun at a ragged N = 8191 and with per-sample initial states;
   hopper and humanoidrun at their paths' own shapes, N = 2048, H = 50
   and N = 8192, H = 50, both timed;
3. as each build ends, the kernel against those plain runs (rewards to
   atol 1e-5, validity flags equal) and its own time by CUDA events;
4. the hopper path: ``envs.get_env("hopper", device="cuda")`` →
   ``mbd.plan`` at ``recommended_config("hopper")`` (2048 / 50 / 100),
   seed 0, through the kernel only, to a clean final reward of at least
   1.8, the final plan rolled out again by the plain version;
5. a short plan (Nsample 256, H 10, Ndiffuse 5) on each other served
   model but humanoidrun, through the kernel only, with finite outputs;
6. the humanoidrun path: ``mbd.plan`` at
   ``recommended_config("humanoidrun")`` (8192 / 50 / 300), seed 0: at
   least 299 kernel launches, no plain-engine call on the card, a clean
   final reward of at least 1.0, and the final plan confirmed by the plain
   version;
7. one JSON line with the kernels' numbers, then the device line.

Each path is driven with the launch counts set to 0 just before it and
read just after; comparison launches are not counted. It needs one CUDA
card and the repository beside it; without either it exits with a
non-zero code and prints no result.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.abspath(__file__))
# every model the kernel serves; the humanoids' builds are the longest
ENVS = ("humanoidrun", "humanoidstandup", "ant", "walker2d", "halfcheetah",
        "hopper", "cartpole")
N_CHECK, H_CHECK = 2048, 4
# Kernel against plain version: the CPU tests' tolerance for rollout
# rewards (tests/test_torch_rollout.py); the validity flags must be equal.
ATOL = 1e-5
# The hopper path must reach the JAX 8-seed hopper mean minus 3σ
# (docs/RESULTS.json: 2.41 ± 0.19, so 2.41 − 3·0.19 ≈ 1.8).
MIN_HOPPER_REWARD = 1.8
# The humanoidrun path must stay clear of a fallen humanoid: the JAX
# 8-seed per-seed rewards span 2.55–13.42 (docs/RESULTS.json), while
# zero controls score −0.598 at seed 0 (the torch engine, 50 steps on the
# CPU) and the rollout is flagged: the humanoid falls.
MIN_HUMANOIDRUN_REWARD = 1.0
SHORT_PLAN = dict(Nsample=256, Hsample=10, Ndiffuse=5)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(report: str) -> str:
    lines = [ln.strip() for ln in report.splitlines()
             if re.search(r"registers|spill", ln)]
    return " | ".join(lines)


def time_ms(torch, fn, reps):
    """Mean ms of ``reps`` calls of ``fn`` by CUDA events, and the last
    call's result."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


class Case:
    """One comparison: inputs, and the plain version's output and time."""

    def __init__(self, torch, envs, name, N, H, gen, per_sample=False):
        from mbd_tpu_torch.rollout.fused import rollout_rewards

        self.name, self.N, self.H, self.per_sample = name, N, H, per_sample
        self.env = env = envs.get_env(name, device="cuda")
        state0 = env.reset(gen)
        if per_sample:
            ps = state0.pipeline_state
            noise = 0.01 * torch.randn((env.sys.nq, N), generator=gen,
                                       device="cuda")
            state0 = SimpleNamespace(pipeline_state=SimpleNamespace(
                q=(ps.q[:, None] + noise).contiguous(),
                qd=ps.qd[:, None].expand(env.sys.nv, N).contiguous()))
        self.state0 = state0
        self.Y0s = 2.0 * torch.rand((N, H, env.action_size), generator=gen,
                                    device="cuda") - 1.0
        self.plain_ms, (self.r_p, _, self.b_p) = time_ms(
            torch, lambda: rollout_rewards(env, state0, self.Y0s), 1)

    def label(self):
        return (f"{self.name} N={self.N} H={self.H} "
                f"per_sample={self.per_sample}")

    def check(self, torch, rc, reps=3):
        """The kernel on the same inputs: max |Δrews| and its ms."""
        r_k, b_k = rc.rollout_rewards_cuda(self.env, self.state0, self.Y0s)
        torch.cuda.synchronize()
        if r_k.shape != (self.N, self.H) or b_k.shape != (self.N,):
            raise AssertionError(f"{self.label()}: kernel output shapes "
                                 f"{tuple(r_k.shape)}, {tuple(b_k.shape)}")
        if not bool(torch.isfinite(r_k).all()):
            raise AssertionError(f"{self.label()}: kernel rewards are not "
                                 "finite")
        err = float((r_k - self.r_p).abs().max())
        flags = bool(torch.equal(b_k, self.b_p))
        if not err <= ATOL or not flags:
            raise AssertionError(f"{self.label()}: kernel and plain version "
                                 f"differ (max|Δrews| {err} > {ATOL} or "
                                 f"flags equal {flags})")
        ms, _ = time_ms(torch, lambda: rc.rollout_rewards_cuda(
            self.env, self.state0, self.Y0s), reps)
        print(f"check {self.label()}: max|Δrews| {err:.3g} (atol {ATOL:g}), "
              f"flags equal, {int(b_k.sum())} flagged; kernel {ms:.3f} ms, "
              f"plain {self.plain_ms:.1f} ms", flush=True)
        return err, ms


def drive_plan(torch, envs, rc, fused, mbd, name, cfg, gpu):
    """Plan ``name`` at ``cfg`` from seed 0 with the counts set to 0 just
    before and read just after; returns (result, state_init, launches,
    plain calls, wall seconds)."""
    env = envs.get_env(name, device="cuda")
    torch.cuda.synchronize()
    gen = torch.Generator("cuda").manual_seed(0)
    rc.LAUNCHES = 0
    fused.CUDA_CALLS = 0
    t0 = time.perf_counter()
    state_init = env.reset(gen)       # what plan() itself draws first
    res = mbd.plan(env, cfg, gen, state_init=state_init)
    final_reward = float(res.final_reward)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain_calls = rc.LAUNCHES, fused.CUDA_CALLS
    steps = (cfg.Ndiffuse - 1) * cfg.Nsample * cfg.Hsample
    print(f"plan {name} {cfg.Nsample}/{cfg.Hsample}/{cfg.Ndiffuse} seed 0: "
          f"final_reward {final_reward:.4f}, final_diverged "
          f"{res.final_diverged}, {launches} kernel launches, "
          f"{plain_calls} plain-engine calls on CUDA; wall {wall:.2f} s, "
          f"{steps / wall:.4g} env-steps/s on {gpu}", flush=True)
    T = cfg.Ndiffuse - 1
    if tuple(res.Ybars.shape) != (T, cfg.Hsample, env.action_size) or \
            tuple(res.rews_trace.shape) != (T,):
        raise AssertionError(f"{name}: plan output shapes")
    if not (bool(torch.isfinite(res.Ybars).all())
            and bool(torch.isfinite(res.rews_trace).all())):
        raise AssertionError(f"{name}: plan outputs are not finite")
    if launches < T:
        raise AssertionError(f"{name}: {launches} kernel launches < {T}")
    if plain_calls != 0:
        raise AssertionError(f"{name}: plain engine ran {plain_calls}× on "
                             "CUDA")
    return env, res, state_init, launches, wall


def confirm_final_plan(torch, fused, env, res, state_init, min_reward):
    """A clean final plan of at least ``min_reward``, rolled out again by
    the plain version to the same reward."""
    final_reward = float(res.final_reward)
    if res.final_diverged:
        raise AssertionError("final plan diverged")
    if not final_reward >= min_reward:
        raise AssertionError(f"final_reward {final_reward} < {min_reward}")
    t0 = time.perf_counter()
    plain_rews, _, plain_bad = fused.rollout_rewards(env, state_init,
                                                     res.Ybars[-1:])
    plain_final = float(plain_rews[0].mean())
    print(f"final plan through the plain version: {plain_final:.6f} "
          f"(kernel {final_reward:.6f}; {time.perf_counter() - t0:.1f} s)",
          flush=True)
    if bool(plain_bad[0]) or not abs(plain_final - final_reward) <= ATOL:
        raise AssertionError("the plain version disagrees on the final plan")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "mbd_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from mbd_tpu_torch import envs
    from mbd_tpu_torch.ops import rollout_cuda as rc
    from mbd_tpu_torch.planners import mbd
    from mbd_tpu_torch.rollout import fused

    t_start = time.perf_counter()
    gpu = card()
    print(gpu)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)

    # 1. every build at once, in the background (own env objects)
    pool = ThreadPoolExecutor(max_workers=len(ENVS))
    builds = {name: pool.submit(rc.build, envs.get_env(name, device="cuda"))
              for name in ENVS}

    # 2. the plain version of every comparison, while they build
    gen = torch.Generator("cuda").manual_seed(1)
    shapes = [(name, N_CHECK, H_CHECK, False) for name in ENVS]
    shapes += [("hopper", N_CHECK - 1, H_CHECK, False),
               ("walker2d", N_CHECK, H_CHECK, True),
               ("humanoidrun", 8191, H_CHECK, False),
               ("humanoidrun", N_CHECK, H_CHECK, True),
               ("hopper", 2048, 50, False),          # hopper's path
               ("humanoidrun", 8192, 50, False)]     # humanoidrun's path
    cases = []
    for name, N, H, per_sample in shapes:
        cases.append(Case(torch, envs, name, N, H, gen, per_sample))
        print(f"plain {cases[-1].label()}: {cases[-1].plain_ms:.1f} ms "
              f"(t = {time.perf_counter() - t_start:.0f} s)", flush=True)

    # 3.–5. as each build ends: its checks, then its path
    stats = {name: dict(max_abs_err=0.0, launches=0) for name in ENVS}
    timed = {name: (N_CHECK, H_CHECK) for name in ENVS}
    timed.update(hopper=(2048, 50), humanoidrun=(8192, 50))
    for name in reversed(ENVS):               # shortest builds first
        built = builds[name].result()
        a = built.attrs()
        stats[name].update(nvcc_s=built.seconds, **a)
        print(f"build {name}: nvcc {built.seconds:.1f} s; {a['regs']} "
              f"registers, {a['local_bytes']} B local per thread, "
              f"{a['blocks_per_sm']} blocks of {a['threads_per_block']} per "
              f"SM; ptxas: {ptxas_summary(built.ptxas)} "
              f"(t = {time.perf_counter() - t_start:.0f} s)", flush=True)
        for case in cases:
            if case.name != name:
                continue
            err, ms = case.check(torch, rc)
            st = stats[name]
            st["max_abs_err"] = max(st["max_abs_err"], err)
            if (case.N, case.H) == timed[name] and not case.per_sample:
                st.update(ms=ms, plain_ms=case.plain_ms)
        if name == "hopper":
            env, res, state_init, launches, _ = drive_plan(
                torch, envs, rc, fused, mbd, name,
                mbd.recommended_config(name), gpu)
            confirm_final_plan(torch, fused, env, res, state_init,
                               MIN_HOPPER_REWARD)
            stats[name]["launches"] = launches
        elif name != "humanoidrun":
            cfg = mbd.recommended_config(name, mbd.MBDConfig(**SHORT_PLAN))
            _, _, _, launches, _ = drive_plan(torch, envs, rc, fused, mbd,
                                              name, cfg, gpu)
            stats[name]["launches"] = launches
    pool.shutdown()

    # 6. the humanoidrun path
    env, res, state_init, launches, _ = drive_plan(
        torch, envs, rc, fused, mbd, "humanoidrun",
        mbd.recommended_config("humanoidrun"), gpu)
    confirm_final_plan(torch, fused, env, res, state_init,
                       MIN_HUMANOIDRUN_REWARD)
    stats["humanoidrun"]["launches"] = launches
    print(f"smoke: {time.perf_counter() - t_start:.0f} s", flush=True)

    # 7. results
    print(json.dumps({"kernels": [{
        "name": f"rollout[{name}]", "route": "cuda",
        "source": "mbd_tpu_torch/csrc/rollout.cu",
        "replaces": "mbd_tpu/ops/rollout_pallas.py:151",
        "launches": stats[name]["launches"],
        "max_abs_err": stats[name]["max_abs_err"],
        "ms": stats[name]["ms"], "plain_ms": stats[name]["plain_ms"]}
        for name in ENVS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
