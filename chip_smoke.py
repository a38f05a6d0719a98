#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mbd_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code 1):

1. the card's name and power limit; the rollout kernel
   (``csrc/rollout.cu``) starts to build for every model it serves, one
   nvcc each, all at once in the background; as each build ends, its
   layout (lanes per sample G, shared bytes per block,
   registers and local bytes per thread, resident warps per SM, SMs in
   use);
2. while they build, the operations per sample and env step of the plain
   version (the torch engine), counted on the CPU for each kernel's bound,
   then the plain version on the card on the inputs of every comparison
   but the paths' own: all nine models at N = 2048, H = 4; hopper at a
   ragged N = 2047 and with the position trace (``need_qs``); walker2d
   with per-sample initial states; humanoidrun at a ragged N = 8191 and
   with per-sample initial states; humanoidtrack at a ragged N = 2047 with
   the trace and the demo log-density (``demo``), and with per-sample
   initial states and the demo; pushT with per-sample initial states whose
   pushers lie inside a bar of the slider, within the pusher's radius
   outside one, or clear of both (the sphere–box pair's two branches), and
   with the trace;
3. as each build ends, the kernel against those plain runs (rewards,
   traces and log-densities to atol 1e-5, validity flags equal), its own
   time by CUDA events and its bound, then that model's path. After a
   path's plan, the kernel is held against the plain version at the
   path's own shape, timed, from the plan's initial state, with the final
   plan as sample 0: so the plain version also rolls the final plan out
   again, to the plan's reward (and demo log-density) within 1e-5:
   - hopper: ``envs.get_env("hopper", device="cuda")`` → ``mbd.plan`` at
     ``recommended_config("hopper")`` (2048 / 50 / 100), seed 0, to a
     clean final reward of at least 1.8, compared at N = 2048, H = 50;
     then the baselines: ``path_integral.plan`` with MPPI, CEM and CMA-ES
     at ``path_integral.recommended_config("hopper")`` (2048 / 50 /
     Nrefine 100), seed 0, each to a clean final reward of at least JAX's
     8-seed mean minus 3σ and at least 99 launches;
   - pushT: ``recommended_config("pushT")`` (2048 / 40 / 200), seed 0: at
     least 199 launches, a clean final reward of at least 0.57, compared
     at N = 2048, H = 40; then the three baselines at
     ``path_integral.recommended_config("pushT")`` (2048 / 40 / Nrefine
     200), each clean, with at least 199 launches, above the reward of
     zero controls from its own reset;
   - humanoidrun: ``recommended_config("humanoidrun")`` (8192 / 50 / 300),
     seed 0: at least 299 kernel launches, a clean final reward of at
     least 1.0, compared at N = 8192, H = 50;
   - humanoidtrack: ``recommended_config("humanoidtrack",
     MBDConfig(enable_demo=True))`` (2048 / 50 / 100), seed 0: at least 99
     launches with the demo, a clean final plan whose demo log-density,
     from the kernel's demo mode, is at least −0.70 and beats by 0.05 or
     more that of the same seed's plan without the demo, compared at
     N = 2048, H = 50 with the demo; before it, a short demo plan on
     humanoidtrack_walk and the plan without the demo;
   - every other model: a short plan (Nsample 256, H 10, Ndiffuse 5);
   no path calls the plain engine on the card, and each ends with finite
   outputs of the expected shapes;
4. one JSON line with the kernels' numbers (with each baseline's
   launches, final reward and wall), then the device line.

Each path is driven with the launch counts set to 0 just before it and
read just after; comparison launches are not counted. It needs one CUDA
card and the repository beside it; without either it exits with a
non-zero code and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor, as_completed
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.abspath(__file__))
# every model the kernel serves, the longest builds first
ENVS = ("humanoidtrack", "humanoidrun", "humanoidstandup", "ant", "walker2d",
        "halfcheetah", "pushT", "hopper", "cartpole")
N_CHECK, H_CHECK = 2048, 4
# Kernel against plain version: the CPU tests' tolerance for rollout
# rewards (tests/test_torch_rollout.py), also for the position trace and
# the demo log-density; the validity flags must be equal.
ATOL = 1e-5
# The hopper path must reach the JAX 8-seed hopper mean minus 3σ
# (docs/RESULTS.json: 2.41 ± 0.19, so 2.41 − 3·0.19 ≈ 1.8).
MIN_HOPPER_REWARD = 1.8
# The humanoidrun path must stay clear of a fallen humanoid: the JAX
# 8-seed per-seed rewards span 2.55–13.42 (docs/RESULTS.json), while
# zero controls score −0.598 at seed 0 (the torch engine, 50 steps on the
# CPU) and the rollout is flagged: the humanoid falls.
MIN_HUMANOIDRUN_REWARD = 1.0
# The humanoidtrack path must show that the demo steers: every JAX seed
# with the demo tracked at −0.661 or above, 5 of the 8 seeds without it
# below −0.70 (docs/RESULTS.json); zero controls track at −0.768, with a
# reward of −2.279 and a flagged rollout (tests/test_torch_demo.py).
MIN_HUMANOIDTRACK_LOGPD = -0.70
# ... and track better than the same seed's plan without the demo, by half
# the spread of JAX's 8 seeds without it (σ 0.10; docs/RESULTS.json).
MIN_DEMO_GAIN = 0.05
# The pushT path must reach JAX's 8-seed pushT mean minus 3σ
# (docs/RESULTS.json: 0.7246 ± 0.0524); zero controls score −0.36 from
# seed 0's reset (printed with the baselines below).
MIN_PUSHT_REWARD = 0.57
# The hopper baselines must reach JAX's 8-seed means minus 3σ
# (docs/RESULTS_BASELINES.json: MPPI 1.297 ± 0.103, CEM 1.257 ± 0.110,
# CMA-ES 1.519 ± 0.143). JAX has no pushT baseline rows; there each must
# beat zero controls from its own reset.
MIN_HOPPER_BASELINE = {"mppi": 0.99, "cem": 0.93, "cma-es": 1.09}
BASELINES = ("mppi", "cem", "cma-es")
SHORT_PLAN = dict(Nsample=256, Hsample=10, Ndiffuse=5)
# H100 SXM peaks (NVIDIA's data sheet): FP32 outside the tensor cores, and
# device memory
PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12
# aten ops that move or make data and compute nothing; every other op is
# counted at one operation per output element (per input element for a
# reduction)
MOVES = {
    "view", "_unsafe_view", "_reshape_alias", "reshape", "expand", "permute",
    "transpose", "t", "select", "slice", "unsqueeze", "squeeze", "cat",
    "stack", "clone", "copy_", "_to_copy", "contiguous", "empty",
    "empty_like", "empty_strided", "zeros", "zeros_like", "ones",
    "ones_like", "full", "full_like", "new_zeros", "new_ones", "new_full",
    "new_empty", "lift_fresh", "lift_fresh_copy", "detach", "alias",
    "as_strided", "split", "split_with_sizes", "unbind", "index",
    "index_select", "_local_scalar_dense", "scalar_tensor", "fill_", "zero_",
    "arange", "repeat"}
REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "argmin",
              "argmax", "linalg_vector_norm", "prod"}


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


def ops_per_sample_step(torch, envs, name, demo) -> int:
    """Operations of the plain version for one sample and one env step
    (n_frames substeps, the reward and, with ``demo``, the demo score),
    counted by a dispatch mode over a rollout at N = 1, H = 1 on the CPU:
    one per output element of each computing aten op, one per input
    element of a reduction, a sine or a square root as one. The position
    trace adds no operation, only bytes."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from mbd_tpu_torch.rollout.fused import rollout_outputs

    class Count(TorchDispatchMode):
        ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            op = func.overloadpacket.__name__
            if op in REDUCTIONS:
                self.ops += args[0].numel()
            elif op not in MOVES:
                outs = out if isinstance(out, (tuple, list)) else (out,)
                self.ops += sum(o.numel() for o in outs
                                if isinstance(o, torch.Tensor))
            return out

    env = envs.get_env(name, device="cpu")
    state0 = env.reset(torch.Generator().manual_seed(0))
    with Count() as count:
        rollout_outputs(env, state0, torch.zeros((1, 1, env.action_size)),
                        demo=demo)
    return count.ops


class Case:
    """One comparison: inputs, and the plain version's outputs and time."""

    def __init__(self, torch, envs, name, N, H, gen, per_sample=False,
                 need_qs=False, demo=False, timed=False, path=None):
        """``path``: (env, initial state, final plan [H, nu]) of a plan
        just driven; the comparison then starts from the plan's initial
        state, with the final plan as sample 0."""
        from mbd_tpu_torch.rollout.fused import rollout_outputs

        self.name, self.N, self.H, self.per_sample = name, N, H, per_sample
        self.need_qs, self.demo, self.timed = need_qs, demo, timed
        if path is not None:
            env, state0, plan = path
        else:
            env = envs.get_env(name, device="cuda")
            state0 = env.reset(gen)
        self.env = env
        self.census = None
        if per_sample:
            ps = state0.pipeline_state
            q = ps.q[:, None] + 0.01 * torch.randn(
                (env.sys.nq, N), generator=gen, device="cuda")
            if name == "pushT":
                # the pusher within 0.25 of the slider's centre: inside a
                # bar, beside one, or clear of both
                q[0:2] = q[2:4] + 0.5 * torch.rand(
                    (2, N), generator=gen, device="cuda") - 0.25
            state0 = SimpleNamespace(pipeline_state=SimpleNamespace(
                q=q.contiguous(),
                qd=ps.qd[:, None].expand(env.sys.nv, N).contiguous()))
            if name == "pushT":
                self.census = sphere_box_census(env, state0)
        self.state0 = state0
        self.Y0s = 2.0 * torch.rand((N, H, env.action_size), generator=gen,
                                    device="cuda") - 1.0
        if path is not None:
            self.Y0s[0] = plan
        self.plain_ms, self.plain = time_ms(
            torch, lambda: rollout_outputs(env, state0, self.Y0s, need_qs,
                                           demo), 1)

    def modes(self):
        return ["base"] + ["need_qs"] * self.need_qs + ["demo"] * self.demo

    def label(self):
        census = "" if self.census is None else (
            " pusher (inside a bar, touching one, clear) per pair "
            f"{self.census}")
        return (f"{self.name} N={self.N} H={self.H} per_sample="
                f"{self.per_sample} modes={'+'.join(self.modes())}{census}")

    def bytes(self):
        """What the kernel must move: U, the initial state and the demo
        frames read once, every output written once."""
        sys, N, H = self.env.sys, self.N, self.H
        floats = N * H * sys.nu + (sys.nq + sys.nv) * (N if self.per_sample
                                                       else 1)
        floats += N * H + N                                # rews, bad
        floats += H * sys.nq * N if self.need_qs else 0
        floats += H * self.env.xref.shape[0] * 3 + N if self.demo else 0
        return 4 * floats

    def bound(self, ops_per_step):
        """The least time the card could take: the larger of the plain
        version's operations (``ops_per_step`` per sample and env step)
        over the FP32 peak and the bytes over the memory rate; (ms, which
        of the two)."""
        t_ops = ops_per_step * self.N * self.H / PEAK_FLOPS * 1e3
        t_bytes = self.bytes() / PEAK_BYTES * 1e3
        return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                     else "bytes")

    def check(self, torch, rc, ops_per_step, reps=3):
        """The kernel on the same inputs: max |Δ| over its outputs, its
        ms, and its bound."""
        out = rc.rollout_rewards_cuda(self.env, self.state0, self.Y0s,
                                      self.need_qs, self.demo)
        torch.cuda.synchronize()
        shapes = [tuple(t.shape) for t in out]
        if shapes != [tuple(t.shape) for t in self.plain]:
            raise AssertionError(f"{self.label()}: kernel output shapes "
                                 f"{shapes}")
        if not all(bool(torch.isfinite(t).all()) for t in out):
            raise AssertionError(f"{self.label()}: kernel outputs are not "
                                 "finite")
        flags = bool(torch.equal(out[1], self.plain[1]))
        names = ["rews"] + ["qs"] * self.need_qs + ["logpd"] * self.demo
        errs = {k: float((a - b).abs().max()) for k, a, b in zip(
            names, out[:1] + out[2:], self.plain[:1] + self.plain[2:])}
        err = max(errs.values())
        if not err <= ATOL or not flags:
            raise AssertionError(f"{self.label()}: kernel and plain version "
                                 f"differ (max|Δ| {errs} > {ATOL} or flags "
                                 f"equal {flags})")
        ms, _ = time_ms(torch, lambda: rc.rollout_rewards_cuda(
            self.env, self.state0, self.Y0s, self.need_qs, self.demo), reps)
        bound_ms, bound_by = self.bound(ops_per_step)
        shown = ", ".join(f"max|Δ{k}| {v:.3g}" for k, v in errs.items())
        print(f"check {self.label()}: {shown} (atol {ATOL:g}), flags equal, "
              f"{int(out[1].sum())} flagged; kernel {ms:.3f} ms, plain "
              f"{self.plain_ms:.1f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by})", flush=True)
        return err, ms, bound_ms, bound_by


def sphere_box_census(env, state0):
    """Per sphere–box pair, the samples whose sphere centre lies inside the
    box (depth ≥ the radius), outside it within the radius (0 < depth <
    radius) and clear of it, at the initial state; raises unless the
    inside and the outside branch are each taken by some sample."""
    from mbd_tpu_torch.sim import batched as BT

    sys = env.sys
    q = state0.pipeline_state.q
    cons = BT.collide_b(sys, BT.fk_b(sys, q))
    radius = sys.host("geom_size")[:, 0]
    out = []
    for (_, ga, _), con in zip(sys.contact_pairs, cons):
        r = float(radius[ga])
        inside = int((con.depth >= r).sum())
        touching = int(((con.depth > 0) & (con.depth < r)).sum())
        out.append((inside, touching, q.shape[1] - inside - touching))
    if not (sum(c[0] for c in out) and sum(c[1] for c in out)):
        raise AssertionError(f"sphere–box inputs miss a branch: {out}")
    return out


def drive_plan(torch, envs, rc, fused, mbd, name, cfg, gpu):
    """Plan ``name`` at ``cfg`` from seed 0 with the counts set to 0 just
    before and read just after; returns (env, result, state_init,
    launches, demo launches)."""
    env = envs.get_env(name, device="cuda")
    torch.cuda.synchronize()
    gen = torch.Generator("cuda").manual_seed(0)
    rc.LAUNCHES = rc.DEMO_LAUNCHES = 0
    fused.CUDA_CALLS = 0
    t0 = time.perf_counter()
    state_init = env.reset(gen)       # what plan() itself draws first
    res = mbd.plan(env, cfg, gen, state_init=state_init)
    final_reward = float(res.final_reward)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, demos = rc.LAUNCHES, rc.DEMO_LAUNCHES
    plain_calls = fused.CUDA_CALLS
    steps = (cfg.Ndiffuse - 1) * cfg.Nsample * cfg.Hsample
    print(f"plan {name} {cfg.Nsample}/{cfg.Hsample}/{cfg.Ndiffuse} "
          f"demo={cfg.enable_demo} seed 0: final_reward {final_reward:.4f}, "
          f"final_diverged {res.final_diverged}, {launches} kernel launches "
          f"({demos} with the demo), {plain_calls} plain-engine calls on "
          f"CUDA; wall {wall:.2f} s, {steps / wall:.4g} env-steps/s on "
          f"{gpu}", flush=True)
    T = cfg.Ndiffuse - 1
    if tuple(res.Ybars.shape) != (T, cfg.Hsample, env.action_size) or \
            tuple(res.rews_trace.shape) != (T,):
        raise AssertionError(f"{name}: plan output shapes")
    if not (bool(torch.isfinite(res.Ybars).all())
            and bool(torch.isfinite(res.rews_trace).all())):
        raise AssertionError(f"{name}: plan outputs are not finite")
    if launches < T:
        raise AssertionError(f"{name}: {launches} kernel launches < {T}")
    if cfg.enable_demo and demos < T:
        raise AssertionError(f"{name}: {demos} demo launches < {T}")
    if plain_calls != 0:
        raise AssertionError(f"{name}: plain engine ran {plain_calls}× on "
                             "CUDA")
    return env, res, state_init, launches


def drive_baseline(torch, envs, rc, fused, pi, name, method, floor, gpu):
    """``path_integral.plan`` on ``name`` with ``method`` at its
    recommended config, seed 0, counts set to 0 just before and read just
    after: finite outputs of the expected shapes, at least Nrefine − 1
    kernel launches, no plain-engine call, a clean final plan of at least
    ``floor`` (None: above zero controls from the same reset). Returns the
    launches and the result's numbers."""
    cfg = pi.recommended_config(name, pi.PathIntegralConfig(
        update_method=method))
    env = envs.get_env(name, device="cuda")
    torch.cuda.synchronize()
    gen = torch.Generator("cuda").manual_seed(0)
    rc.LAUNCHES = 0
    fused.CUDA_CALLS = 0
    t0 = time.perf_counter()
    state_init = env.reset(gen)
    res = pi.plan(env, cfg, gen, state_init=state_init)
    final_reward = float(res.final_reward)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain_calls = rc.LAUNCHES, fused.CUDA_CALLS
    zero = torch.zeros((1, cfg.Hsample, env.action_size), device="cuda")
    zero_reward = float(rc.rollout_rewards_cuda(env, state_init, zero)[0]
                        .mean())
    # no floor: strictly above zero controls
    above = final_reward >= floor if floor is not None else \
        final_reward > zero_reward
    print(f"baseline {name} {method} {cfg.Nsample}/{cfg.Hsample}/"
          f"{cfg.Nrefine} seed 0: final_reward {final_reward:.4f} (floor "
          f"{floor}; zero controls {zero_reward:.4f}), final_diverged "
          f"{res.final_diverged}, {launches} kernel launches, {plain_calls} "
          f"plain-engine calls on CUDA; wall {wall:.2f} s on {gpu}",
          flush=True)
    T = cfg.Nrefine - 1
    if tuple(res.mu_0ts.shape) != (T, cfg.Hsample, env.action_size) or \
            tuple(res.rews_trace.shape) != (T,):
        raise AssertionError(f"{name} {method}: plan output shapes")
    if not (bool(torch.isfinite(res.mu_0ts).all())
            and bool(torch.isfinite(res.rews_trace).all())):
        raise AssertionError(f"{name} {method}: outputs are not finite")
    if launches < T:
        raise AssertionError(f"{name} {method}: {launches} launches < {T}")
    if plain_calls != 0:
        raise AssertionError(f"{name} {method}: plain engine ran "
                             f"{plain_calls}× on CUDA")
    if res.final_diverged:
        raise AssertionError(f"{name} {method}: final plan diverged")
    if not above:
        raise AssertionError(f"{name} {method}: final_reward {final_reward} "
                             f"below its floor {floor} or zero controls "
                             f"{zero_reward}")
    return launches, dict(final_reward=final_reward, wall_s=wall,
                          zero_controls=zero_reward)


def final_logpd(rc, env, res, state_init) -> float:
    """The demo log-density of a plan's final plan, from the kernel's demo
    mode."""
    _, _, logpd = rc.rollout_rewards_cuda(env, state_init, res.Ybars[-1:],
                                          demo=True)
    return float(logpd[0])


def confirm_final_plan(torch, rc, env, res, state_init, case,
                       min_reward=None, min_logpd=None, no_demo_logpd=None):
    """A clean final plan of at least ``min_reward`` (and, for a demo, a
    demo log-density of at least ``min_logpd`` from the kernel's demo
    mode, and ``MIN_DEMO_GAIN`` above ``no_demo_logpd``, that of the plan
    without the demo), rolled out again by the plain version to the same
    numbers: it is sample 0 of ``case``, the path's own comparison."""
    final_reward = float(res.final_reward)
    if res.final_diverged:
        raise AssertionError("final plan diverged")
    if min_reward is not None and not final_reward >= min_reward:
        raise AssertionError(f"final_reward {final_reward} < {min_reward}")
    demo = min_logpd is not None
    kernel = {"reward": final_reward}
    if demo:
        kernel["logpd"] = final_logpd(rc, env, res, state_init)
        print(f"final plan's demo log-density {kernel['logpd']:.6f}, "
              f"without the demo {no_demo_logpd:.6f}: a gain of "
              f"{kernel['logpd'] - no_demo_logpd:.6f} (at least "
              f"{MIN_DEMO_GAIN} required)", flush=True)
        if not kernel["logpd"] >= min_logpd:
            raise AssertionError(f"final plan's demo log-density "
                                 f"{kernel['logpd']} < {min_logpd}")
        if not kernel["logpd"] >= no_demo_logpd + MIN_DEMO_GAIN:
            raise AssertionError("the demo does not steer: the plan without "
                                 f"it tracks at {no_demo_logpd}")
    out = case.plain
    plain = {"reward": float(out[0][0].mean())}
    if demo:
        plain["logpd"] = float(out[-1][0])
    shown = ", ".join(f"{k} {plain[k]:.6f} (kernel {kernel[k]:.6f})"
                      for k in kernel)
    print(f"final plan through the plain version (sample 0 of "
          f"{case.label()}): {shown}", flush=True)
    if bool(out[1][0]) or not all(abs(plain[k] - kernel[k]) <= ATOL
                                  for k in kernel):
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
    from mbd_tpu_torch.planners import path_integral as pi
    from mbd_tpu_torch.rollout import fused

    t_start = time.perf_counter()

    def elapsed():
        return f"t = {time.perf_counter() - t_start:.0f} s"

    gpu = card()
    print(gpu)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)

    # 1. every build at once, in the background (own env objects)
    pool = ThreadPoolExecutor(max_workers=len(ENVS))
    builds = {pool.submit(rc.build, envs.get_env(name, device="cuda")): name
              for name in ENVS}

    # each path: its config, its floor, and its own shape, at which the
    # kernel is held against the plain version after the plan
    paths = {
        "hopper": (mbd.recommended_config("hopper"),
                   dict(min_reward=MIN_HOPPER_REWARD), dict(N=2048, H=50)),
        "humanoidrun": (mbd.recommended_config("humanoidrun"),
                        dict(min_reward=MIN_HUMANOIDRUN_REWARD),
                        dict(N=8192, H=50)),
        "humanoidtrack": (mbd.recommended_config(
            "humanoidtrack", mbd.MBDConfig(enable_demo=True)),
            dict(min_logpd=MIN_HUMANOIDTRACK_LOGPD),
            dict(N=2048, H=50, demo=True)),
        "pushT": (mbd.recommended_config("pushT"),
                  dict(min_reward=MIN_PUSHT_REWARD), dict(N=2048, H=40))}
    # the baselines after each of these paths, with their floors
    baselines = {"hopper": MIN_HOPPER_BASELINE,
                 "pushT": dict.fromkeys(BASELINES)}

    # 2. the plain version of every other comparison, after the operation
    # counts
    gen = torch.Generator("cuda").manual_seed(1)
    shapes = [dict(name=name, N=N_CHECK, H=H_CHECK, timed=name not in paths)
              for name in ENVS]
    shapes += [
        dict(name="hopper", N=N_CHECK - 1, H=H_CHECK),
        dict(name="hopper", N=N_CHECK, H=H_CHECK, need_qs=True),
        dict(name="walker2d", N=N_CHECK, H=H_CHECK, per_sample=True),
        dict(name="humanoidrun", N=8191, H=H_CHECK),
        dict(name="humanoidrun", N=N_CHECK, H=H_CHECK, per_sample=True),
        dict(name="humanoidtrack", N=N_CHECK - 1, H=H_CHECK, need_qs=True,
             demo=True),
        dict(name="humanoidtrack", N=N_CHECK, H=H_CHECK, per_sample=True,
             demo=True),
        dict(name="pushT", N=N_CHECK, H=H_CHECK, per_sample=True,
             need_qs=True)]
    keys = {(spec["name"], spec.get("demo", False)) for spec in shapes}
    keys |= {(name, shape.get("demo", False))
             for name, (_, _, shape) in paths.items()}
    ops = {}
    for key in sorted(keys):
        ops[key] = ops_per_sample_step(torch, envs, *key)
        print(f"plain version {key[0]}: {ops[key]} operations per sample "
              f"and env step{' with the demo' if key[1] else ''} "
              f"({elapsed()})", flush=True)

    def plain(**spec):
        case = Case(torch, envs, gen=gen, **spec)
        print(f"plain {case.label()}: {case.plain_ms:.1f} ms ({elapsed()})",
              flush=True)
        return case

    cases = [plain(**spec) for spec in shapes]

    # 3. as each build ends: its checks, then its path
    stats = {name: dict(max_abs_err=0.0, launches=0, modes=set(),
                        baselines={}) for name in ENVS}

    def check(case):
        st = stats[case.name]
        err, ms, bound_ms, bound_by = case.check(
            torch, rc, ops[case.name, case.demo])
        st["max_abs_err"] = max(st["max_abs_err"], err)
        st["modes"].update(case.modes())
        if case.timed:
            st.update(ms=ms, plain_ms=case.plain_ms, bound_ms=bound_ms,
                      bound_by=bound_by, shape=f"{case.N}x{case.H}",
                      operations=ops[case.name, case.demo] * case.N * case.H,
                      bytes=case.bytes())

    for future in as_completed(builds):
        name = builds[future]
        built = future.result()
        st = stats[name]
        # the layout at the shape the model is timed at
        N_timed = paths[name][2]["N"] if name in paths else N_CHECK
        st.update(nvcc_s=built.seconds, **built.attrs(N_timed))
        print(f"build {name}: nvcc {built.seconds:.1f} s; ptxas: "
              f"{ptxas_summary(built.ptxas)} ({elapsed()})", flush=True)
        print(f"  layout {name} G={st['G']}: {st['threads_per_block']} "
              f"threads and {st['shared_bytes']} B of shared memory per "
              f"block, {st['regs']} registers and {st['local_bytes']} B "
              f"local per thread, {st['blocks_per_sm']} blocks "
              f"({st['warps_per_sm']} warps) per SM, {st['sms_used']} SMs "
              f"at N={N_timed}", flush=True)
        for case in cases:
            if case.name == name:
                check(case)
        if name in paths:
            cfg, floor, shape = paths[name]
            if name == "humanoidtrack":
                drive_plan(torch, envs, rc, fused, mbd, "humanoidtrack_walk",
                           mbd.recommended_config(name, mbd.MBDConfig(
                               enable_demo=True, **SHORT_PLAN)), gpu)
                # the same seed without the demo, for the demo's gain
                floor = dict(floor, no_demo_logpd=final_logpd(
                    rc, *drive_plan(torch, envs, rc, fused, mbd, name,
                                    dataclasses.replace(cfg,
                                                        enable_demo=False),
                                    gpu)[:3]))
            env, res, state_init, st["launches"] = drive_plan(
                torch, envs, rc, fused, mbd, name, cfg, gpu)
            case = plain(name=name, timed=True,
                         path=(env, state_init, res.Ybars[-1]), **shape)
            check(case)
            confirm_final_plan(torch, rc, env, res, state_init, case, **floor)
            for method, floor in baselines.get(name, {}).items():
                st["baselines"][method] = drive_baseline(
                    torch, envs, rc, fused, pi, name, method, floor, gpu)
        else:
            cfg = mbd.recommended_config(name, mbd.MBDConfig(**SHORT_PLAN))
            _, _, _, st["launches"] = drive_plan(torch, envs, rc, fused, mbd,
                                                 name, cfg, gpu)
    pool.shutdown()
    print(f"smoke: {time.perf_counter() - t_start:.0f} s on {gpu}",
          flush=True)

    # 4. results
    for name in ENVS:
        st = stats[name]
        print(f"bound {name} {st['shape']}: {st['operations']} operations, "
              f"{st['bytes']} bytes → {st['bound_ms']:.4f} ms "
              f"({st['bound_by']}); kernel {st['ms']:.3f} ms", flush=True)
    order = ("base", "need_qs", "demo")
    print(json.dumps({"kernels": [{
        "name": f"rollout[{name}]", "route": "cuda",
        "source": "mbd_tpu_torch/csrc/rollout.cu",
        "replaces": "mbd_tpu/ops/rollout_pallas.py:151",
        "modes": [m for m in order if m in stats[name]["modes"]],
        "launches": stats[name]["launches"],
        # launches, final reward and wall of each path_integral.plan
        "baselines": {m: dict(launches=n, **res) for m, (n, res)
                      in stats[name]["baselines"].items()},
        # lanes per sample, shared bytes per block and resident warps per
        # SM of the launch at the timed shape
        "G": stats[name]["G"], "shared_bytes": stats[name]["shared_bytes"],
        "warps_per_sm": stats[name]["warps_per_sm"],
        "max_abs_err": stats[name]["max_abs_err"],
        "ms": stats[name]["ms"], "plain_ms": stats[name]["plain_ms"],
        "bound_ms": stats[name]["bound_ms"],
        "bound_by": stats[name]["bound_by"],
        # no single PyTorch call computes a rollout
        "library_ms": None}
        for name in ENVS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
