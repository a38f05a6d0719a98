#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mbd_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code 1):

1. the card's name and power limit, and the build of the rollout kernel
   (``csrc/rollout.cu``) for every model it serves, with the compiler's
   register and spill report;
2. the kernel against its plain version (the torch engine) on the card, on
   hopper, walker2d, halfcheetah and cartpole at N = 2048 and a short
   horizon, once on a ragged N = 2047 and once with per-sample initial
   states; then both timed and compared on one hopper rollout at the main
   path's shape, N = 2048, H = 50;
3. the slice: ``envs.get_env("hopper", device="cuda")`` →
   ``mbd.plan`` at ``recommended_config("hopper")`` (2048 / 50 / 100),
   seed 0, which must run through the kernel only and reach a clean
   final reward of at least 1.8;
4. one JSON line with the kernels' numbers, then the device line.

It needs one CUDA card and the repository beside it; without either it
exits with a non-zero code and prints no result.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
ENVS = ("hopper", "walker2d", "halfcheetah", "cartpole")
N_CHECK, H_CHECK = 2048, 4
# Kernel against plain version: the CPU tests' tolerance for rollout
# rewards (tests/test_torch_rollout.py); the validity flags must be equal.
ATOL = 1e-5
# The slice must reach the JAX 8-seed hopper mean minus 3σ
# (docs/RESULTS.json: 2.41 ± 0.19, so 2.41 − 3·0.19 ≈ 1.8).
MIN_FINAL_REWARD = 1.8


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(report: str) -> str:
    lines = [ln.strip() for ln in report.splitlines()
             if re.search(r"registers|spill", ln)]
    return " | ".join(lines)


def build_all(rc, envs):
    built = {}
    for name in ENVS:
        t0 = time.perf_counter()
        b = rc.build(envs.get_env(name, device="cuda"))
        built[name] = b
        print(f"build {name}: {time.perf_counter() - t0:.1f} s "
              f"(nvcc {b.seconds:.1f} s); attrs {b.attrs()}; "
              f"ptxas: {ptxas_summary(b.ptxas)}", flush=True)
    return built


def compare(torch, rc, env, N, H, gen, per_sample=False):
    """Kernel and plain version on the same inputs; returns max |Δrews|."""
    from types import SimpleNamespace

    from mbd_tpu_torch.rollout.fused import rollout_rewards

    state0 = env.reset(gen)
    if per_sample:
        ps = state0.pipeline_state
        noise = 0.01 * torch.randn((env.sys.nq, N), generator=gen,
                                   device="cuda")
        state0 = SimpleNamespace(pipeline_state=SimpleNamespace(
            q=(ps.q[:, None] + noise).contiguous(),
            qd=ps.qd[:, None].expand(env.sys.nv, N).contiguous()))
    Y0s = 2.0 * torch.rand((N, H, env.action_size), generator=gen,
                           device="cuda") - 1.0
    r_k, b_k = rc.rollout_rewards_cuda(env, state0, Y0s)
    torch.cuda.synchronize()
    r_p, _, b_p = rollout_rewards(env, state0, Y0s)
    torch.cuda.synchronize()
    if r_k.shape != (N, H) or b_k.shape != (N,):
        raise AssertionError(f"kernel output shapes {tuple(r_k.shape)}, "
                             f"{tuple(b_k.shape)}")
    if not bool(torch.isfinite(r_k).all()):
        raise AssertionError("kernel rewards are not finite")
    err = float((r_k - r_p).abs().max())
    if not bool(torch.equal(b_k, b_p)):
        raise AssertionError(f"validity flags differ on {env.__class__}")
    return err


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

    gpu = card()
    print(gpu)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)

    # 1. build
    t0 = time.perf_counter()
    built = build_all(rc, envs)
    print(f"builds: {time.perf_counter() - t0:.1f} s", flush=True)

    # 2. kernel against plain version, then timing at the main path's shape
    gen = torch.Generator("cuda").manual_seed(1)
    max_err = 0.0
    cases = [(name, N_CHECK, False) for name in ENVS]
    cases += [("hopper", N_CHECK - 1, False), ("walker2d", N_CHECK, True)]
    for name, N, per_sample in cases:
        env = envs.get_env(name, device="cuda")
        err = compare(torch, rc, env, N, H_CHECK, gen, per_sample)
        print(f"check {name} N={N} H={H_CHECK} per_sample={per_sample}: "
              f"max|Δrews| {err:.3g} (atol {ATOL:g})", flush=True)
        if not err <= ATOL:
            raise AssertionError(f"{name}: kernel and plain version differ "
                                 f"by {err} > {ATOL}")
        max_err = max(max_err, err)

    env = envs.get_env("hopper", device="cuda")
    state0 = env.reset(torch.Generator("cuda").manual_seed(2))
    N, H = 2048, 50
    Y0s = 2.0 * torch.rand((N, H, env.action_size), device="cuda") - 1.0
    rc.rollout_rewards_cuda(env, state0, Y0s)                  # warm-up
    ms, (r_k, b_k) = time_ms(
        torch, lambda: rc.rollout_rewards_cuda(env, state0, Y0s), 5)
    # the plain version is host-bound (thousands of small launches per
    # substep) and takes tens of seconds: timed once, without a warm-up
    # (the comparisons above have already run it on the card)
    plain_ms, (r_p, _, b_p) = time_ms(
        torch, lambda: fused.rollout_rewards(env, state0, Y0s), 1)
    # the main path's shape, checked like the short ones above
    if r_k.shape != (N, H) or not bool(torch.isfinite(r_k).all()):
        raise AssertionError("kernel rewards at N=2048, H=50")
    err = float((r_k - r_p).abs().max())
    print(f"check hopper N={N} H={H}: max|Δrews| {err:.3g} "
          f"(atol {ATOL:g})", flush=True)
    if not err <= ATOL or not bool(torch.equal(b_k, b_p)):
        raise AssertionError(f"hopper N={N} H={H}: kernel and plain version "
                             f"differ (max|Δrews| {err}, flags equal "
                             f"{bool(torch.equal(b_k, b_p))})")
    max_err = max(max_err, err)
    attrs = built["hopper"].attrs()
    print(f"hopper rollout N={N} H={H} on {gpu}: kernel {ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms; {attrs['regs']} registers, "
          f"{attrs['local_bytes']} B local per thread, "
          f"{attrs['blocks_per_sm']} blocks of "
          f"{attrs['threads_per_block']} per SM", flush=True)

    # 3. the slice, counted from zero
    env = envs.get_env("hopper", device="cuda")
    cfg = mbd.recommended_config("hopper")
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
    print(f"plan hopper {cfg.Nsample}/{cfg.Hsample}/{cfg.Ndiffuse} seed 0: "
          f"final_reward {final_reward:.4f}, final_diverged "
          f"{res.final_diverged}, {launches} kernel launches, "
          f"{plain_calls} plain-engine calls on CUDA; wall {wall:.2f} s, "
          f"{steps / wall:.4g} env-steps/s on {gpu}", flush=True)
    T = cfg.Ndiffuse - 1
    if tuple(res.Ybars.shape) != (T, cfg.Hsample, env.action_size) or \
            tuple(res.rews_trace.shape) != (T,):
        raise AssertionError("plan output shapes")
    if not (bool(torch.isfinite(res.Ybars).all())
            and bool(torch.isfinite(res.rews_trace).all())):
        raise AssertionError("plan outputs are not finite")
    if launches < T:
        raise AssertionError(f"{launches} kernel launches < {T}")
    if plain_calls != 0:
        raise AssertionError(f"plain engine ran {plain_calls}× on CUDA")
    if res.final_diverged:
        raise AssertionError("final plan diverged")
    if not final_reward >= MIN_FINAL_REWARD:
        raise AssertionError(f"final_reward {final_reward} < "
                             f"{MIN_FINAL_REWARD}")
    # the returned plan, rolled out again by the plain version
    plain_rews, _, plain_bad = fused.rollout_rewards(env, state_init,
                                                     res.Ybars[-1:])
    plain_final = float(plain_rews[0].mean())
    print(f"final plan through the plain version: {plain_final:.6f} "
          f"(kernel {final_reward:.6f})", flush=True)
    if bool(plain_bad[0]) or not abs(plain_final - final_reward) <= ATOL:
        raise AssertionError("the plain version disagrees on the final plan")

    # 4. results
    print(json.dumps({"kernels": [{
        "name": "rollout", "route": "cuda",
        "source": "mbd_tpu_torch/csrc/rollout.cu",
        "replaces": "mbd_tpu/ops/rollout_pallas.py:151",
        "launches": launches, "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
