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
2. while they build, the plain version (the torch engine) on the card on
   the inputs of every comparison but the paths' own (each kernel's bound
   counts ``benchmark/work/count.py``'s ``WORK`` per sample and env step,
   every constraint row as the plain version solves them all, and a
   launch's bytes, ``launch_bytes``, over the card's peaks, ``least_s``):
   all nine models at N = 2048, H = 4; hopper at a ragged N = 2047 and
   with the position trace (``need_qs``); walker2d with per-sample
   initial states; humanoidrun at a ragged N = 8191 and
   with per-sample initial states; humanoidtrack at a ragged N = 2047 with
   the trace and the demo log-density (``demo``), and with per-sample
   initial states and the demo; pushT with per-sample initial states whose
   pushers lie inside a bar of the slider, within the pusher's radius
   outside one, or clear of both (the sphere–box pair's two branches), and
   with the trace; the plain version's ``retire`` output of humanoidrun at
   2048 × 50 (the retiring form's exit alone, as on a mesh shard) and of
   hopper at 16 384 × 50 (its refill alone, as in hopper's 8-seed batch);
3. as each build ends, the kernel against those plain runs (rewards,
   traces and log-densities to atol 1e-5, validity flags equal), its own
   time by CUDA events and its bound, then that model's path. After a
   path's plan, the kernel is held against the plain version at the
   path's own shape, timed, from the plan's initial state, with the final
   plan as sample 0: so the plain version also rolls the final plan out
   again, to the plan's reward (and demo log-density) within 1e-5; at
   humanoidrun's the plain version runs through ``replay.first_flags``,
   whose flags must equal the kernel's, and its line prints the flagged
   count by check and the tail share (the sample-substeps after each
   sample's first flag). The retiring form (``retire=True``, the planner's
   reverse step without the demo) is held against the plain version's
   ``retire`` output at each path's shape without the demo and at the two
   shapes above: flags and first flags equal, the NaN of fixed bits after
   each first flag, the other rewards to atol 1e-5, the queue's counts;
   timed beside the whole form, its bound the ``WORK`` of the
   sample-steps it runs:
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
   - the seed-batched paths, after the serial ones: ``mbd.plan_batch`` on
     hopper, 8 seeds at 2048 / 50 / 100, with no seed flagged, its mean
     within the two-sample bound of JAX's 8-seed mean
     (``docs/RESULTS.json``) and seed 0 within 5e-3 of its serial plan;
     then ``path_integral.plan_batch`` with MPPI, CEM and CMA-ES, each
     mean within the bound of ``docs/RESULTS_BASELINES.json``'s;
     humanoidrun, 8 × 8192 samples a step for 3 steps; humanoidtrack with
     the demo, 2 seeds for 3 steps. Each takes one launch a step and one
     for the final selection; its first step's samples are launched again
     at S·N and each seed's alone, which must agree bit for bit, and the
     plain version rolls out a strided set of the S·N samples (the first
     and last of every seed among them) from their own initial states,
     to the batch's outputs within 1e-5; the launches at S·N and of seed
     0 are timed;
   no path calls the plain engine on the card, and each ends with finite
   outputs of the expected shapes;
4. the CLI, ``python -m mbd_tpu_torch.cli.run_mbd --env_name hopper
   --mode single`` into a temporary directory (in this process): its
   mu_0ts.npy and rollout.html, 101 launches of which one with the trace;
   then ``python -m mbd_tpu_torch.cli.vis_diffusion --env_name hopper``
   on that mu_0ts.npy: render_diffusion.html with 6 ghosts, from 7
   ``need_qs`` launches; then the replay of the reference's committed
   8-seed plans of every harness directory under ``results/``, one launch
   each from JAX's resets (``mbd_tpu_torch/rollout/replay.py``; car2d,
   analytic, none), each seed within its env's tolerance but for the
   seeds logged as faults and the envelope-edge seeds, whose flags are
   accepted and their margins printed; then each directory's plans from
   32 one-ulp perturbations of the resets, one launch, whose spread is the
   humanoids' tolerance and must stay within it;
5. checkpoint and resume on hopper at 2048 / 50 / 100 with chunks of 10:
   the plan stopped after chunk 3 and resumed in 99 − 30 + 1 launches,
   equal bit for bit to the plan without a checkpoint;
6. car2d on the analytic path, which launches no kernel: one 2048 × 50
   rollout timed; the demo plan at 2048 / 50 / 100, seed 0, to within 0.2
   of the goal and a final reward above 0.05; the plan without the demo
   and MPPI, CEM and CMA-ES, finite; ``plan_batch`` of 8 seeds with the
   demo, its mean reward and demo log-density within the two-sample bound
   of ``docs/RESULTS.json``'s, seed 0 its serial plan bit for bit;
7. ``blackbox.bbo.optimize`` on Ackley, Rastrigin and Levy at dim 800,
   6 seeds each, each mean within the two-sample bound of
   ``docs/RESULTS_BLACKBOX.json``'s;
8. RL (``mbd_tpu_torch/rl``), every env step through the kernel's
   state-out mode (``env_step_cuda``): first that mode against the plain
   engine, bit for bit in q', qd', rewards and flags, on hopper, pushT
   and humanoidrun at B = 1, 8, 128 and 2048 from per-sample states with
   flagged samples, timed at pushT 2048 and hopper 128; then ``python -m
   mbd_tpu_torch.rl.train --env_name pushT`` (PPO at its reference
   config, 2048 envs, unroll 20, 16 minibatches × 8 epochs, for 2
   iterations and one eval: 20 + 20 + 100 + 40 launches) and
   ``--env_name hopper --scale 0`` (SAC: 64 prefill steps, 64 iterations
   of 64 updates, the eval of 128 envs × 1000 steps, 50 for the 8-seed
   eval: 1178 launches), each with no other launch and no call of the
   plain engine, finite losses, evals and params; then JAX's trained
   hopper SAC policy (``mbd_tpu_torch/assets/hopper_sac.npz``) by
   train.py's 8-seed eval from JAX's resets, its mean within the
   two-sample bound of ``docs/RESULTS_RL.json``'s;
9. the sample mesh (``mbd_tpu_torch/parallel``): hopper MBD and MPPI at
   2048 / 50 / 100, humanoidtrack with the demo at 2048 / 50 / 100,
   ``plan_batch`` of 2 hopper seeds and PPO on pushT (2048 envs, 2
   iterations and one eval), each first in this process and then on 2
   ranks spawned on the one card, joined by gloo over CUDA tensors: every
   plan equal to this process's bit for bit on both ranks, PPO's
   parameters equal on both and within 1e-4 of this process's, each rank
   launching the kernel on its half of the samples only (hopper: 99
   launches of 1024 and the final selection's 50 or 49); then hopper's
   plan with NCCL at world size 1, bit for bit; then, only on a machine
   with 2 cards or more, ``parallel.multichip``'s exact gather and its
   cases ``dryrun`` and ``hopper_seeds8`` over up to 4 cards, one NCCL
   rank a card, with its checks (on one card, a line saying so);
10. MNIST weight diffusion (``blackbox/mnist.py``) at the published config
   (Nsample 256, Ndiffuse 500), seeds 0–5: the mean final test accuracy
   within the two-sample bound of JAX's over the same seeds
   (``mbd_tpu_torch/assets/mnist_jax.json``), no kernel launched; then the
   explainer's and the 1-D demo's numerics on the card against the CPU,
   to 1e-6 (nothing drawn);
11. one JSON line with the analytic path's numbers and each phase's wall
   (``utils/profiling.py``'s ``Timer``), one with RL's, one with the
   mesh's, MNIST's and the explainer's, one with the kernels' numbers
   (with each baseline's launches, final reward and wall, each batched
   path's, the viewer's, the resume's and the mesh's launches, the
   state-out mode's, and the retiring form's at each of its shapes), then
   the device line.

Each path is driven with the launch counts set to 0 just before it and
read just after; comparison launches are not counted. It times no plan
for the record: the benchmark (``python3 benchmark/run.py``) does. It
needs one CUDA card and the repository beside it; without either it exits
with a non-zero code and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
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
# Seed 0 of plan_batch against its serial plan: the same noise, the same
# per-sample bits, each seed's statistics at the serial shapes; only the
# final selection's mean over H may round otherwise.
BATCH_SERIAL_ATOL = 5e-3
SHORT_PLAN = dict(Nsample=256, Hsample=10, Ndiffuse=5)


def ptxas_summary(report: str) -> str:
    lines = [ln.strip() for ln in report.splitlines()
             if re.search(r"registers|spill", ln)]
    return " | ".join(lines)


def bound_ms(ops, nbytes):
    """The least time the card could take for ``ops`` operations that
    move ``nbytes`` (``benchmark/work/count.py::least_s``): (ms,
    "operations" or "bytes", whichever bounds it)."""
    from benchmark.work import count

    by = "operations" if ops / count.PEAK_FLOPS >= \
        nbytes / count.PEAK_BYTES else "bytes"
    return count.least_s(ops, nbytes) * 1e3, by


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
    """One comparison: inputs, and the plain version's outputs and time."""

    def __init__(self, torch, envs, name, N, H, gen, per_sample=False,
                 need_qs=False, demo=False, timed=False, path=None,
                 flags=False, retire=False):
        """``path``: (env, initial state, final plan [H, nu]) of a plan
        just driven; the comparison then starts from the plan's initial
        state, with the final plan as sample 0. ``flags``: the plain
        version runs through ``replay.first_flags``, whose record
        (``self.flags``) also gives each sample's first flagged substep.
        ``retire``: the plain version's output is its ``retire`` one, for
        the retiring form alone (``check_retire``). Each sample's first
        flagged env step (−1: none) is kept in ``self.first``."""
        from mbd_tpu_torch.rollout import replay
        from mbd_tpu_torch.rollout.fused import rollout_outputs

        self.name, self.N, self.H, self.per_sample = name, N, H, per_sample
        self.need_qs, self.demo, self.timed = need_qs, demo, timed
        self.retire, self.path = retire, path is not None
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
        # the plain version's outputs
        self.flags = None
        if flags:
            self.plain_ms, self.flags = time_ms(
                torch, lambda: replay.first_flags(env, state0, self.Y0s,
                                                  trace=True), 1)
            self.plain = (self.flags.rews, self.flags.bad)
            first = self.flags.first
            self.first = torch.where(first >= 0, first // env.n_frames, -1)
        else:
            self.plain_ms, out = time_ms(
                torch, lambda: rollout_outputs(env, state0, self.Y0s,
                                               need_qs, demo, first=True,
                                               retire=retire), 1)
            self.plain, self.first = out[:-1], out[-1]

    def modes(self):
        return ["base"] + ["need_qs"] * self.need_qs + ["demo"] * self.demo

    def label(self):
        census = "" if self.census is None else (
            " pusher (inside a bar, touching one, clear) per pair "
            f"{self.census}")
        modes = "retire" if self.retire else "+".join(self.modes())
        return (f"{self.name} N={self.N} H={self.H} per_sample="
                f"{self.per_sample} modes={modes}{census}")

    def bytes(self):
        """What a launch must move (``benchmark/work/count.py``'s
        ``launch_bytes``)."""
        from benchmark.work import count

        sys_ = self.env.sys
        return count.launch_bytes(sys_.nq, sys_.nv, sys_.nu, self.N, self.H)

    def ops_per_sample_step(self):
        """``benchmark/work/count.py``'s ``WORK``: every constraint row,
        as the plain version solves them all."""
        from benchmark.work import count

        return count.WORK[self.name, self.demo]

    def bound(self):
        """The least time the card could take for these inputs
        (``bound_ms``); (ms, which of operations or bytes bounds it)."""
        return bound_ms(self.ops_per_sample_step() * self.N * self.H,
                        self.bytes())

    def check(self, torch, rc, reps=3):
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
        bound_ms, bound_by = self.bound()
        shown = ", ".join(f"max|Δ{k}| {v:.3g}" for k, v in errs.items())
        tail = ""
        if self.flags is not None:
            from mbd_tpu_torch.rollout.replay import summary

            s = summary(self.flags)
            tail = (f" ({s['by_check']['qd']} by |qd|, "
                    f"{s['by_check']['root']} by the root; tail share "
                    f"{s['tail_share']:.4f})")
        print(f"check {self.label()}: {shown} (atol {ATOL:g}), flags equal, "
              f"{int(out[1].sum())} flagged{tail}; kernel {ms:.3f} ms, plain "
              f"{self.plain_ms:.1f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by})", flush=True)
        return err, ms, bound_ms, bound_by

    def check_retire(self, torch, rc, reps=3):
        """The retiring form on the same inputs, against the plain
        version's ``retire`` output: flags and first flags equal, every
        reward after a sample's first flagged env step the NaN of bits
        ``RETIRED_BITS``, the others to ATOL, every sample taken from the
        queue once and the env steps the kernel counts those up to each
        first flag. Its ms, the whole form's on the same inputs, and its
        bound: the operations of the sample-steps it runs
        (``ops_per_sample_step`` each) and the bytes of a launch."""
        from mbd_tpu_torch.rollout.fused import RETIRED_BITS

        env, N, H = self.env, self.N, self.H
        first = self.first.to(torch.int32)
        rews, bad, first_k, queue = rc.library(env).run(
            env, self.state0, self.Y0s, first=True, retire=True)
        torch.cuda.synchronize()
        after = (torch.arange(H, device="cuda")[None] > first[:, None]) & \
            (first >= 0)[:, None]
        ran = int(torch.where(first >= 0, first + 1, H).sum())
        nan = bool((rews.contiguous().view(torch.int32)[after]
                    == RETIRED_BITS).all())
        flags = bool(torch.equal(bad, self.plain[1])) and bool(
            torch.equal(first_k, first))
        err = float((rews[~after] - self.plain[0][~after]).abs().max())
        if not (err <= ATOL and flags and nan
                and queue.tolist() == [N, ran]):
            raise AssertionError(
                f"{self.label()}: retiring form and plain version differ "
                f"(max|Δrews| {err:.3g} > {ATOL}, flags and first flags "
                f"equal {flags}, NaN after each first flag {nan}, queue "
                f"{queue.tolist()} against {[N, ran]})")
        ms, _ = time_ms(torch, lambda: rc.rollout_rewards_cuda(
            env, self.state0, self.Y0s, retire=True), reps)
        whole_ms, _ = time_ms(torch, lambda: rc.rollout_rewards_cuda(
            env, self.state0, self.Y0s), reps)
        bound, bound_by = bound_ms(self.ops_per_sample_step() * ran,
                                   self.bytes())
        a = rc.library(env).attrs(N, retire=True)
        resident = a["blocks_per_sm"] * a["threads_per_block"] // a["G"] \
            * torch.cuda.get_device_properties(0).multi_processor_count
        out = dict(shape=f"{N}x{H}", refill=N > resident,
                   flagged=int(bad.sum()), ran_share=ran / (N * H),
                   max_abs_err=err, ms=ms, whole_ms=whole_ms,
                   plain_ms=self.plain_ms, bound_ms=bound, bound_by=bound_by)
        print(f"check {self.label()} retiring: max|Δrews| {err:.3g} (atol "
              f"{ATOL:g}), flags and first flags equal, NaN after each "
              f"first flag, {out['flagged']} flagged, {ran} of {N * H} "
              f"sample-steps run, refill {out['refill']}; kernel {ms:.3f} "
              f"ms (whole form {whole_ms:.3f} ms), bound {bound:.4f} ms "
              f"({bound_by})", flush=True)
        return out


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


def check_bound(sq, label, rewards, key):
    """The two-sample bound on the 8-seed mean against JAX's row ``key``
    (``seed_quality.reference`` and ``seed_quality.bound``); JAX's numbers
    and the bound are printed here and kept out of the kernels line."""
    ref = sq.reference(key)
    b = sq.bound(ref["rew_mean"], ref["rew_std"], rewards)
    print(f"  {label}: {len(rewards)}-seed mean {b['mean']:.4f} ± "
          f"{b['std']:.4f} against JAX's {b['ref_mean']:.4f} ± "
          f"{b['ref_std']:.4f}: |Δ| {abs(b['mean'] - b['ref_mean']):.4f}, "
          f"bound {b['bound']:.4f}", flush=True)
    if not b["ok"]:
        raise AssertionError(f"{label}: the mean is outside the bound")
    return dict(mean=b["mean"], std=b["std"], in_bound=True)


def drive_batch(torch, envs, rc, fused, planner, name, cfg, S, gpu):
    """``planner.plan_batch`` on ``name`` at ``cfg`` for seeds 0 … S − 1,
    counts set to 0 just before and read just after: finite outputs of
    the expected shapes, one launch per step and one for the final
    selection (each step with the demo when ``cfg`` has it), no
    plain-engine call. Returns (env, result, launches, wall)."""
    env = envs.get_env(name, device="cuda")
    demo = getattr(cfg, "enable_demo", False)
    T = (cfg.Ndiffuse if hasattr(cfg, "Ndiffuse") else cfg.Nrefine) - 1
    torch.cuda.synchronize()
    gens = [torch.Generator("cuda").manual_seed(s) for s in range(S)]
    rc.LAUNCHES = rc.DEMO_LAUNCHES = rc.QS_LAUNCHES = 0
    fused.CUDA_CALLS = 0
    t0 = time.perf_counter()
    res = planner.plan_batch(env, cfg, gens)
    rewards = res.final_reward.tolist()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, demos, plain_calls = rc.LAUNCHES, rc.DEMO_LAUNCHES, \
        fused.CUDA_CALLS
    plans = res.Ybars if hasattr(res, "Ybars") else res.mu_0ts
    label = (f"plan_batch {name} "
             f"{getattr(cfg, 'update_method', 'mbd')} {S}×{cfg.Nsample}/"
             f"{cfg.Hsample}/{T + 1} demo={demo}")
    print(f"{label}: final rewards {[round(r, 4) for r in rewards]}, "
          f"{int(res.final_diverged.sum())} flagged, {launches} kernel "
          f"launches ({demos} with the demo), {plain_calls} plain-engine "
          f"calls on CUDA; wall {wall:.2f} s on {gpu}", flush=True)
    if tuple(plans.shape) != (S, T, cfg.Hsample, env.action_size) or \
            tuple(res.rews_trace.shape) != (S, T) or \
            tuple(res.final_diverged.shape) != (S,):
        raise AssertionError(f"{label}: output shapes")
    if not (bool(torch.isfinite(plans).all())
            and bool(torch.isfinite(res.rews_trace).all())
            and bool(torch.isfinite(res.final_reward).all())):
        raise AssertionError(f"{label}: outputs are not finite")
    if launches != T + 1 or demos != (T if demo else 0):
        raise AssertionError(f"{label}: {launches} launches ({demos} with "
                             f"the demo), not {T} + 1")
    if plain_calls != 0:
        raise AssertionError(f"{label}: plain engine ran {plain_calls}× on "
                             "CUDA")
    return env, res, launches, wall


def batch_checks(torch, rc, mbd, env, cfg, S, n_strided=64):
    """The first step's samples of S seeds, as ``plan_batch`` draws them,
    launched at S·N with per-sample initial states, then each seed's
    alone: every seed's rewards, flags (and demo log-densities) in the
    batch must equal its own launch's bit for bit. Then the plain version
    on a strided set of the S·N samples (``n_strided`` spread over the
    batch, and the first and last of every seed), from their own initial
    states: the batch's outputs there within ATOL, the flags equal.
    Returns (ms at S·N, ms of seed 0's launch, layout at S·N, max |Δ|
    against the plain version); these launches are comparisons, not a
    path's."""
    from mbd_tpu_torch.core.schedule import make_schedule
    from mbd_tpu_torch.rollout.fused import rollout_outputs

    N, H, nu = cfg.Nsample, cfg.Hsample, env.action_size
    gens = [torch.Generator("cuda").manual_seed(s) for s in range(S)]
    states = [env.reset(g) for g in gens]
    sigma = make_schedule(cfg.Ndiffuse, cfg.beta0, cfg.betaT,
                          device="cuda").sigmas[cfg.Ndiffuse - 1]
    Y0s = torch.clamp(mbd.draw_eps(gens, (N, H, nu), "cuda") * sigma + 0.0,
                      -1.0, 1.0).reshape(S * N, H, nu)
    batch_state = mbd.seed_major(states, N)
    ms_b, out_b = time_ms(torch, lambda: rc.rollout_rewards_cuda(
        env, batch_state, Y0s, demo=cfg.enable_demo), 3)
    ms_1, _ = time_ms(torch, lambda: rc.rollout_rewards_cuda(
        env, states[0], Y0s[:N], demo=cfg.enable_demo), 3)
    unequal = []
    for s in range(S):
        own = rc.rollout_rewards_cuda(env, states[s], Y0s[s * N:(s + 1) * N],
                                      demo=cfg.enable_demo)
        if not all(bool(torch.equal(a[s * N:(s + 1) * N], b))
                   for a, b in zip(out_b, own)):
            unequal.append(s)
    idx = torch.cat([torch.linspace(0, S * N - 1, n_strided,
                                    device="cuda").round().long(),
                     torch.arange(S, device="cuda") * N,
                     torch.arange(1, S + 1, device="cuda") * N - 1]).unique()
    ps = batch_state.pipeline_state
    sub = SimpleNamespace(pipeline_state=SimpleNamespace(
        q=ps.q[:, idx].contiguous(), qd=ps.qd[:, idx].contiguous()))
    plain = rollout_outputs(env, sub, Y0s[idx], False, cfg.enable_demo)
    names = ["rews", "bad"] + ["logpd"] * cfg.enable_demo
    errs = {k: float((a[idx] - b).abs().max()) for k, a, b
            in zip(names, out_b, plain) if k != "bad"}
    flags = bool(torch.equal(out_b[1][idx], plain[1]))
    err = max(errs.values())
    layout = rc.build(env).attrs(S * N)
    print(f"  {env.sys.nq}-dof batch of {S}×{N}: kernel {ms_b:.3f} ms per "
          f"launch at S·N = {S * N} ({layout['G']} lanes per sample, "
          f"{layout['sms_used']} SMs, {layout['warps_per_sm']} warps per "
          f"SM), {ms_1:.3f} ms for one seed's {N}; each seed's outputs in "
          f"the batch equal its own launch's bit for bit, seeds that do "
          f"not: {unequal}; plain version on {idx.numel()} samples up to "
          f"the last, {idx.max().item()}: "
          + ", ".join(f"max|Δ{k}| {v:.3g}" for k, v in errs.items())
          + f" (atol {ATOL:g}), flags equal {flags}", flush=True)
    if unequal:
        raise AssertionError(f"seeds {unequal}' samples differ inside the "
                             "batch")
    if not err <= ATOL or not flags:
        raise AssertionError("the batch launch and the plain version differ")
    return ms_b, ms_1, layout, err


def drive_cli(torch, rc, fused, envs, gpu, out):
    """``python -m mbd_tpu_torch.cli.run_mbd --env_name hopper --mode
    single`` into the directory ``out``, run in this process so that the
    counts can be read: mu_0ts.npy [99, 50, 3], a rollout.html of 50
    frames with the model's geoms, 99 + 1 plan launches and the viewer's
    trace from one ``need_qs`` launch, no plain-engine call."""
    import runpy

    import numpy as np

    from mbd_tpu_torch.viz import html

    argv = sys.argv
    sys.argv = ["run_mbd", "--env_name", "hopper", "--mode", "single",
                "--results_dir", out]
    rc.LAUNCHES = rc.DEMO_LAUNCHES = rc.QS_LAUNCHES = 0
    fused.CUDA_CALLS = 0
    t0 = time.perf_counter()
    try:
        runpy.run_module("mbd_tpu_torch.cli.run_mbd", run_name="__main__",
                         alter_sys=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(launches=rc.LAUNCHES, need_qs=rc.QS_LAUNCHES,
                      plain_calls=fused.CUDA_CALLS)
        mu = np.load(os.path.join(out, "hopper", "mu_0ts.npy"))
        with open(os.path.join(out, "hopper", "rollout.html")) as f:
            page = f.read()
    finally:
        sys.argv = argv
    data = json.loads(re.search(r"const DATA = (.*);\n", page).group(1))
    geoms = html._system_dict(envs.get_env("hopper", device="cuda").sys)
    print(f"cli hopper single: mu_0ts {list(mu.shape)}, rollout.html "
          f"{len(page)} bytes with {len(data['frames'])} frames and "
          f"{len(data['system']['geoms'])} geoms, {counts}; wall "
          f"{wall:.2f} s on {gpu}", flush=True)
    if mu.shape != (99, 50, 3) or not np.isfinite(mu).all():
        raise AssertionError("cli: mu_0ts.npy")
    if len(data["frames"]) != 50 or data["system"] != geoms:
        raise AssertionError("cli: rollout.html")
    if counts != dict(launches=101, need_qs=1, plain_calls=0):
        raise AssertionError(f"cli: launches {counts}")
    return counts


def drive_replay(torch, envs, rc, gpu):
    """The reference's committed 8-seed plans of every harness directory,
    one launch each from JAX's resets (``rollout/replay.py``): each seed's
    flag as committed and its mean reward within the env's tolerance of
    the committed one, but for the seeds logged as faults (printed). Then,
    in one more launch each, the plans from 32 one-ulp perturbations of the
    resets (``replay.spread``): the humanoids' tolerance is that spread,
    which must not pass it; the other envs' spread is printed beside
    their tolerance, JAX's own drift from the TPU to a CPU. Returns the
    largest gap and the spread per directory."""
    from mbd_tpu_torch.envs.physics import PhysicsEnv
    from mbd_tpu_torch.rollout import replay

    gaps, missed, wide = {}, [], []
    for directory, name in replay.HARNESS.items():
        env = envs.get_env(name, device="cuda")
        rc.LAUNCHES = 0
        (rews, bad), ref = replay.replay(env, directory)
        launches = rc.LAUNCHES
        gap = rews - ref["rewards"]
        faults = sorted(replay.misses(directory, rews, bad, ref))
        logged = replay.faults(directory, "cuda")
        edge = replay.edge(directory, "cuda", rews, bad, ref)
        spread, flips = replay.spread(env, directory)
        tol = replay.tolerance(directory)
        print(f"replay {directory}: {launches} launch, kernel − "
              f"committed per seed {[f'{g:.3g}' for g in gap]} (atol "
              f"{tol:.3g}), flags {bad.tolist()} (committed "
              f"{ref['diverged'].tolist()}); missed: {faults} (logged "
              f"faults {sorted(logged)}; on the envelope's edge, flagged "
              f"by the margin first measured: {edge}); one-ulp spread "
              f"{spread:.4g} with {flips} flag flips of 256", flush=True)
        # car2d, an analytic env, rolls out without the kernel
        if launches != int(isinstance(env, PhysicsEnv)):
            raise AssertionError(f"replay {directory}: {launches} launches")
        missed += [(directory, s) for s in faults
                   if s not in logged and s not in edge]
        if name in replay.SPREAD_SET and not spread <= tol:
            wide.append((directory, spread))
        gaps[directory] = dict(max_gap=float(abs(gap).max()), spread=spread)
    if missed:
        raise AssertionError(f"replay: {missed} beyond the tolerance")
    if wide:
        raise AssertionError(f"replay: spreads {wide} pass the tolerance")
    return gaps


def drive_vis_diffusion(torch, rc, fused, gpu, out):
    """``python -m mbd_tpu_torch.cli.vis_diffusion --env_name hopper`` on
    the mu_0ts.npy the CLI phase wrote into ``out``, in this process:
    render_diffusion.html with the last iterate's 50 frames and 6 ghosts of
    50, from 7 ``need_qs`` launches and no other, no plain-engine call."""
    import runpy

    argv = sys.argv
    sys.argv = ["vis_diffusion", "--env_name", "hopper", "--results_dir",
                out]
    rc.LAUNCHES = rc.DEMO_LAUNCHES = rc.QS_LAUNCHES = 0
    fused.CUDA_CALLS = 0
    t0 = time.perf_counter()
    try:
        runpy.run_module("mbd_tpu_torch.cli.vis_diffusion",
                         run_name="__main__", alter_sys=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(launches=rc.LAUNCHES, need_qs=rc.QS_LAUNCHES,
                      plain_calls=fused.CUDA_CALLS)
        with open(os.path.join(out, "hopper", "render_diffusion.html")) as f:
            page = f.read()
    finally:
        sys.argv = argv
    data = json.loads(re.search(r"const DATA = (.*);\n", page).group(1))
    ghosts = [len(g) for g in data["ghosts"]]
    print(f"vis_diffusion hopper: render_diffusion.html {len(page)} bytes, "
          f"{len(data['frames'])} frames and ghosts of {ghosts} frames, "
          f"{counts}; wall {wall:.2f} s on {gpu}", flush=True)
    if len(data["frames"]) != 50 or ghosts != [50] * 6:
        raise AssertionError("vis_diffusion: render_diffusion.html")
    if counts != dict(launches=7, need_qs=7, plain_calls=0):
        raise AssertionError(f"vis_diffusion: launches {counts}")
    return dict(counts, wall_s=wall)


class Interrupt(Exception):
    """Raised from ``progress_fn`` to stop a plan after a chunk."""


def drive_checkpoint(torch, envs, rc, fused, mbd, gpu):
    """Checkpoint and resume on hopper at its recommended config (2048 /
    50 / 100) with ``chunk_size`` 10, seed 0: the plan without a
    checkpoint, then with one; then a plan stopped by raising from
    ``progress_fn`` after chunk 3 and resumed, with the counts set to 0
    just before the resume and read just after. The checkpointed plan and
    the resumed one equal the plan without a checkpoint bit for bit, and
    the resume takes 99 − 30 + 1 launches. Returns the launches, walls and
    the checkpoint's cost per chunk."""
    import shutil
    import tempfile

    cfg, chunk, stop = mbd.recommended_config("hopper"), 10, 30
    env = envs.get_env("hopper", device="cuda")
    out = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")

    def run(**kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = mbd.plan(env, cfg, torch.Generator("cuda").manual_seed(0),
                       chunk_size=chunk, **kw)
        float(res.final_reward)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    def stop_after(t, rew):
        if t == stop:
            raise Interrupt

    try:
        full, wall_full = run()
        kept, wall_kept = run(checkpoint_path=os.path.join(out, "full"))
        path = os.path.join(out, "stopped")
        try:
            run(checkpoint_path=path, progress_fn=stop_after)
            raise AssertionError("checkpoint: the plan was not stopped")
        except Interrupt:
            pass
        rc.LAUNCHES = rc.DEMO_LAUNCHES = rc.QS_LAUNCHES = 0
        fused.CUDA_CALLS = 0
        resumed, wall_resume = run(checkpoint_path=path)
        launches, plain_calls = rc.LAUNCHES, fused.CUDA_CALLS
    finally:
        shutil.rmtree(out)
    T = cfg.Ndiffuse - 1
    same = {name: all(torch.equal(getattr(r, k), getattr(full, k))
                      for k in ("Ybars", "rews_trace", "final_reward"))
            for name, r in (("checkpointed", kept), ("resumed", resumed))}
    per_chunk = (wall_kept - wall_full) / -(-T // chunk)
    print(f"checkpoint hopper {cfg.Nsample}/{cfg.Hsample}/{cfg.Ndiffuse} "
          f"chunk {chunk}: final_reward {float(full.final_reward):.6f}; "
          f"equal to the plan without a checkpoint bit for bit: {same}; "
          f"resumed after step {stop} with {launches} kernel launches, "
          f"{plain_calls} plain-engine calls on CUDA; wall {wall_full:.2f} s "
          f"without a checkpoint, {wall_kept:.2f} s with one "
          f"({per_chunk * 1e3:.1f} ms a chunk), {wall_resume:.2f} s to "
          f"resume, on {gpu}", flush=True)
    if not all(same.values()):
        raise AssertionError("checkpoint: the plans differ")
    if launches != T - stop + 1 or plain_calls != 0:
        raise AssertionError(f"checkpoint: {launches} launches on resume, "
                             f"not {T - stop + 1}")
    return dict(launches=launches, wall_s=wall_full, wall_ckpt_s=wall_kept,
                wall_resume_s=wall_resume, ckpt_ms_per_chunk=per_chunk * 1e3)


def drive_car2d(torch, envs, rc, fused, mbd, pi, sq, gpu):
    """car2d on the analytic path, which launches no rollout kernel (the
    counts set to 0 before each plan and read after must stay 0): one
    2048 × 50 rollout of the demo path timed; ``mbd.plan`` at
    ``recommended_config("car2d", MBDConfig(enable_demo=True))`` (2048 /
    50 / 100), seed 0, whose final plan passes within 0.2 of the goal with
    a final reward above 0.05 (the reference's own test,
    tests/test_car2d_planner.py:49-65); the plan without the demo and the
    three baselines at ``path_integral.recommended_config("car2d")``, each
    finite; ``plan_batch`` of seeds 0–7 with the demo, whose mean reward
    and mean demo log-density lie within the two-sample bound of
    ``docs/RESULTS.json``'s ``car2d+demo`` and whose seed 0 is the serial
    plan bit for bit."""
    from mbd_tpu_torch.rollout.rollout import rollout_us

    env = envs.get_env("car2d", device="cuda")
    state0 = env.reset(None)
    out = {}
    Y = 2.0 * torch.rand((2048, 50, 2), device="cuda",
                         generator=torch.Generator("cuda").manual_seed(2)) - 1
    batch = mbd.batch_states(env, [state0], 2048)
    out["rollout_ms"], _ = time_ms(torch, lambda: mbd.rollout_batch(
        env, batch, Y, demo=True), 3)
    print(f"car2d: one 2048×50 rollout with the demo log-density, "
          f"{out['rollout_ms']:.3f} ms (CUDA events, mean of 3) on {gpu}",
          flush=True)

    def counted(label, fn):
        rc.LAUNCHES = rc.DEMO_LAUNCHES = rc.QS_LAUNCHES = 0
        fused.CUDA_CALLS = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        rewards = res.final_reward.reshape(-1).tolist()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        print(f"car2d {label}: final reward {[round(r, 4) for r in rewards]}"
              f", diverged {res.final_diverged}, {rc.LAUNCHES} kernel "
              f"launches, {fused.CUDA_CALLS} plain-engine calls; wall "
              f"{wall:.2f} s on {gpu}", flush=True)
        if rc.LAUNCHES or fused.CUDA_CALLS:
            raise AssertionError(f"car2d {label}: the analytic path "
                                 "launched the rollout kernel")
        if not all(math.isfinite(r) for r in rewards) or bool(
                torch.as_tensor(res.final_diverged).any()):
            raise AssertionError(f"car2d {label}: not finite")
        return res, wall

    cfg = mbd.recommended_config("car2d", mbd.MBDConfig(enable_demo=True))
    serial, out["demo_wall_s"] = counted("+demo 2048/50/100 seed 0", lambda:
                                         mbd.plan(env, cfg, torch.Generator(
                                             "cuda").manual_seed(0)))
    _, xs = rollout_us(env, state0, serial.Ybars[-1])
    closest = float((xs[:, :2] - env.xg[:2]).norm(dim=-1).min())
    out["demo_reward"] = float(serial.final_reward)
    out["demo_closest"] = closest
    print(f"  the final plan passes {closest:.4f} from the goal (< 0.2 "
          f"required), final reward {out['demo_reward']:.4f} (> 0.05 "
          "required)", flush=True)
    if not (closest < 0.2 and out["demo_reward"] > 0.05):
        raise AssertionError("car2d + demo: the goal is not reached")
    plain, out["no_demo_wall_s"] = counted(
        "without the demo 2048/50/100 seed 0", lambda: mbd.plan(
            env, mbd.recommended_config("car2d"),
            torch.Generator("cuda").manual_seed(0)))
    out["no_demo_reward"] = float(plain.final_reward)
    out["baselines"] = {}
    for method in BASELINES:
        pcfg = pi.recommended_config("car2d", pi.PathIntegralConfig(
            update_method=method))
        res, wall = counted(f"{method} {pcfg.Nsample}/{pcfg.Hsample}/"
                            f"{pcfg.Nrefine} seed 0", lambda: pi.plan(
                                env, pcfg, torch.Generator(
                                    "cuda").manual_seed(0)))
        out["baselines"][method] = dict(final_reward=float(res.final_reward),
                                        wall_s=wall)
    gens = [torch.Generator("cuda").manual_seed(s) for s in range(8)]
    res, out["batch_wall_s"] = counted("+demo plan_batch seeds 0–7",
                                       lambda: mbd.plan_batch(env, cfg, gens))
    _, xs = rollout_us(env, mbd.batch_states(env, [state0] * 8, 1),
                       res.Ybars[:, -1])
    logpd = env.eval_xref_logpd(xs).tolist()
    out["batch"] = check_bound(sq, "car2d + demo", res.final_reward.tolist(),
                               "car2d+demo")
    ref = sq.reference("car2d+demo")
    b = sq.bound(ref["xref_logpd_mean"], ref["xref_logpd_std"], logpd)
    print(f"  car2d + demo logpd: 8-seed mean {b['mean']:.4f} ± "
          f"{b['std']:.4f} against JAX's {b['ref_mean']:.4f} ± "
          f"{b['ref_std']:.4f}: |Δ| {abs(b['mean'] - b['ref_mean']):.4f}, "
          f"bound {b['bound']:.4f}", flush=True)
    if not b["ok"]:
        raise AssertionError("car2d + demo: the logpd mean is outside the "
                             "bound")
    out["batch"]["logpd_mean"], out["batch"]["logpd_std"] = b["mean"], \
        b["std"]
    same = torch.equal(res.Ybars[0], serial.Ybars) and torch.equal(
        res.rews_trace[0], serial.rews_trace)
    print(f"  seed 0 of the batch is its serial plan bit for bit: {same}",
          flush=True)
    if not same:
        raise AssertionError("car2d: seed 0 of the batch is not its serial "
                             "plan")
    return out


def drive_bbo(torch, sq, gpu):
    """``bbo.optimize`` on the card for Ackley, Rastrigin and Levy at dim
    800, Nsample 64, Ndiffuse 100, seeds 0–5: each mean final J within
    3·√((σ_JAX² + σ²)/6) of ``docs/RESULTS_BLACKBOX.json``; no rollout
    kernel runs."""
    from mbd_tpu_torch.blackbox import bbo

    with open(os.path.join(ROOT, "docs", "RESULTS_BLACKBOX.json")) as f:
        ref = json.load(f)["bbo"]
    out = {}
    for fn_name in ("Ackley", "Rastrigin", "Levy"):
        cfg = bbo.BBOConfig(fn_name=fn_name, dim=800, Nsample=64,
                            Ndiffuse=100)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        finals = [float(bbo.optimize(cfg, torch.Generator(
            "cuda").manual_seed(s), device="cuda").J_trace[-1])
            for s in range(6)]
        wall = time.perf_counter() - t0
        r = ref[fn_name]
        b = sq.bound(r["J_final_mean"], r["J_final_std"], finals)
        print(f"bbo {fn_name} dim 800, 6 seeds: J_final {b['mean']:.4f} ± "
              f"{b['std']:.4f} against JAX's {b['ref_mean']:.4f} ± "
              f"{b['ref_std']:.4f}: |Δ| {abs(b['mean'] - b['ref_mean']):.4f},"
              f" bound {b['bound']:.4f}; wall {wall:.2f} s on {gpu}",
              flush=True)
        if not b["ok"]:
            raise AssertionError(f"bbo {fn_name}: outside the bound")
        out[fn_name] = dict(mean=b["mean"], std=b["std"], wall_s=wall)
    return out


# RL: the kernel's state-out mode (env_step_cuda) at these B, on
# these models, against its plain version; the B it is timed at per model
RL_STEP_ENVS = ("hopper", "pushT", "humanoidrun")
RL_STEP_B = (1, 8, 128, 2048)
RL_TIMED = {"pushT": 2048, "hopper": 128}
# PPO on pushT at its reference config for 2 iterations (2048 envs × 20
# steps each), one eval; SAC on hopper at --scale 0
PPO_SCALE = 0.00082


def rl_states(torch, env, gen, B):
    """Per-sample states around the env's reset (0.01 noise on q, 0.5 on
    qd), every fourth sample's first dof at speed 150, so that the step's
    checks flag it."""
    ps = env.reset(gen).pipeline_state
    q = ps.q[:, None] + 0.01 * torch.randn((env.sys.nq, B), generator=gen,
                                           device="cuda")
    qd = ps.qd[:, None] + 0.5 * torch.randn((env.sys.nv, B), generator=gen,
                                            device="cuda")
    qd[0, ::4] = 150.0
    return q.contiguous(), qd.contiguous()


def drive_rl_step(torch, envs, rc, fused, gpu):
    """The state-out mode against the plain engine on the card, bit for
    bit (q', qd', rewards, flags), on hopper, pushT and humanoidrun at
    B = 1, 8, 128 and 2048 from per-sample states with flagged samples;
    timed at RL_TIMED's B, with its bound (``benchmark/work/count.py``'s
    ``WORK`` a sample)."""
    from benchmark.work import count

    out = {}
    for name in RL_STEP_ENVS:
        env = envs.get_env(name, device="cuda")
        sys_ = env.sys
        for B in RL_STEP_B:
            gen = torch.Generator("cuda").manual_seed(B)
            q, qd = rl_states(torch, env, gen, B)
            u = 2.0 * torch.rand((env.action_size, B), generator=gen,
                                 device="cuda") - 1.0
            plain_ms, plain = time_ms(
                torch, lambda: fused.env_step_outputs(env, q, qd, u), 1)
            got = rc.env_step_cuda(env, q, qd, u)
            torch.cuda.synchronize()
            diff = [k for k, a, b in zip(("q", "qd", "reward", "bad"), got,
                                         plain)
                    if a.shape != b.shape or not torch.equal(a, b)]
            err = max(float((a - b).abs().max()) for a, b in zip(got, plain))
            flagged = int(got[3].sum())
            same = f"differ in {diff}" if diff else "equal bit for bit"
            print(f"rl_step {name} B={B}: kernel and plain version {same}, "
                  f"{flagged} flagged", flush=True)
            if diff or not bool(torch.isfinite(got[0]).all()):
                raise AssertionError(f"state-out mode {name} B={B}: {diff}")
            if B >= 8 and not flagged:
                raise AssertionError(f"rl_step {name} B={B}: no sample "
                                     "flagged")
            if RL_TIMED.get(name) != B:
                continue
            ms, _ = time_ms(torch, lambda: rc.env_step_cuda(env, q, qd, u),
                            50)
            floats = B * (2 * (sys_.nq + sys_.nv) + sys_.nu + 2)
            ops = count.WORK[name, False] * B
            bound, bound_by = bound_ms(ops, 4 * floats)
            out[name] = dict(
                B=B, ms=ms, max_abs_err=err, plain_ms=plain_ms,
                bound_ms=bound, bound_by=bound_by,
                operations=ops, bytes=4 * floats)
            print(f"  state-out {name} B={B}: kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.1f} ms, bound {out[name]['bound_ms']:.6f} ms "
                  f"({out[name]['bound_by']}) on {gpu}", flush=True)
    return out


def drive_train(torch, rc, fused, env_name, argv, expect, gpu):
    """``python -m mbd_tpu_torch.rl.train --env_name env_name *argv`` in
    this process, into a temporary directory, with the launch counts set
    to 0 just before and read just after: every env step of training, of
    the trainer's eval and of the 8-seed eval must be one state-out launch
    (``expect(record)`` of them) and nothing else may launch or call the
    plain engine; losses, eval returns and the saved params finite."""
    import shutil
    import tempfile

    import numpy as np

    from mbd_tpu_torch.rl import train

    out_dir = tempfile.mkdtemp(prefix=f"chip_smoke_rl_{env_name}_")
    try:
        rc.LAUNCHES = rc.STATE_LAUNCHES = rc.QS_LAUNCHES = 0
        rc.DEMO_LAUNCHES = fused.CUDA_CALLS = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        record = train.main(["--env_name", env_name, "--results_dir",
                             out_dir, "--device", "cuda", *argv])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, state = rc.LAUNCHES, rc.STATE_LAUNCHES
        with np.load(os.path.join(out_dir, env_name,
                                  "params_torch.npz")) as d:
            params_finite = all(bool(np.isfinite(d[k]).all())
                                for k in d.files)
        page = os.path.getsize(os.path.join(out_dir, env_name,
                                            "RL_torch.html"))
    finally:
        shutil.rmtree(out_dir)
    want = expect(record)
    hist = record["history"]
    iters = sum(h["train/iterations"] for h in hist)
    losses = {k: v for h in hist for k, v in h.items()
              if k.startswith("train/") and k.endswith("loss")}
    per_iter = sum(h["train/wall_s"] for h in hist) / iters
    print(f"{env_name} {record['algo']}: {iters} iterations, "
          f"{per_iter:.4f} s each; {state} state-out launches (expected "
          f"{want}), {launches} launches in all, plain-engine calls "
          f"{fused.CUDA_CALLS}; losses {losses}; trainer's eval "
          f"{[h['eval/episode_reward'] for h in hist]}; 8-seed eval "
          f"{record['eval_mean']:.4f} ± {record['eval_std']:.4f}; "
          f"RL_torch.html {page} B; wall {wall:.1f} s on {gpu}", flush=True)
    finite = all(math.isfinite(v) for v in losses.values()) and all(
        math.isfinite(h["eval/episode_reward"]) for h in hist) and \
        math.isfinite(record["eval_mean"])
    if not (finite and params_finite):
        raise AssertionError(f"{env_name}: a loss, an eval or a param is "
                             "not finite")
    if state != want or launches != state or fused.CUDA_CALLS:
        raise AssertionError(f"{env_name}: an env step not taken through "
                             "the kernel's state-out mode")
    return dict(launches=state, iterations=iters, wall_per_iter_s=per_iter,
                wall_s=wall, losses=losses, eval_mean=record["eval_mean"],
                eval_std=record["eval_std"],
                trainer_eval=[h["eval/episode_reward"] for h in hist],
                history=hist)


def drive_ppo(torch, rc, fused, gpu):
    """PPO on pushT at its reference config (2048 envs, unroll 20, 16
    minibatches, 8 epochs, policy (32)×4, value (256)×5) for 2 iterations
    and one eval: 20 launches an iteration, 100 for the eval (128 envs ×
    the episode's 100 steps), 40 for the 8-seed eval."""
    from mbd_tpu_torch.rl import train

    cfg = train.PPO_CONFIGS["pushT"]

    def expect(record):
        iters = sum(h["train/iterations"] for h in record["history"])
        return iters * cfg["unroll_length"] + len(record["history"]) * \
            cfg["episode_length"] + train.eval_steps("pushT")

    out = drive_train(torch, rc, fused, "pushT",
                      ["--scale", str(PPO_SCALE), "--num_evals", "1"],
                      expect, gpu)
    if out["iterations"] != 2:
        raise AssertionError(f"PPO took {out['iterations']} iterations")
    return out


def drive_sac(torch, rc, fused, gpu):
    """SAC on hopper at --scale 0: 64 prefill steps, then 64 iterations of
    one env step (128 envs) and 64 gradient updates, the eval of 128 envs
    × 1000 steps, and the 8-seed eval's 50 steps: one launch each."""
    from mbd_tpu_torch.rl import train

    cfg = train.SAC_CONFIGS["hopper"]

    def expect(record):
        h = record["history"]
        return h[0]["train/prefill_steps"] + sum(
            x["train/iterations"] for x in h) + len(h) * \
            cfg["episode_length"] + train.eval_steps("hopper")

    return drive_train(torch, rc, fused, "hopper", ["--scale", "0"],
                       expect, gpu)


def drive_rl_eval(torch, gpu):
    """JAX's trained hopper SAC policy (``mbd_tpu_torch/assets/
    hopper_sac.npz``) in the port, by train.py's eval protocol (8 seeds ×
    50 steps, deterministic actions) from JAX's own eval resets: the
    8-seed mean within 3·√((σ_JAX² + σ²)/8) of JAX's
    (``docs/RESULTS_RL.json``); each seed printed beside JAX's CPU run."""
    import numpy as np

    from mbd_tpu_torch import envs
    from mbd_tpu_torch.rl import networks, sac, train
    from seed_quality import bound

    env = envs.get_env("hopper", device="cuda")
    tree = networks.load_npz(train.HOPPER_SAC)
    cfg = sac.SACConfig(**train.SAC_CONFIGS["hopper"])
    params = sac.init_params(env, 0)
    networks.load_tree(params, tree)
    q0 = torch.tensor(tree["eval"]["q"].T.copy(), device="cuda")
    qd0 = torch.tensor(tree["eval"]["qd"].T.copy(), device="cuda")
    t0 = time.perf_counter()
    rews, _ = train.evaluate_seeds(
        env, networks.make_inference_fn(cfg, params), q0, qd0,
        train.eval_steps("hopper"))
    rews = rews.cpu().numpy().astype(float)
    wall = time.perf_counter() - t0
    with open(os.path.join(ROOT, "docs", "RESULTS_RL.json")) as f:
        ref = json.load(f)["hopper"]
    b = bound(ref["eval_mean"], ref["eval_std"], rews.tolist())
    for s, (r, j) in enumerate(zip(rews, tree["eval"]["rewards"])):
        print(f"  hopper SAC seed {s}: port {r:.6f}, JAX (CPU) {j:.6f}",
              flush=True)
    print(f"rl_eval hopper SAC (JAX's policy): 8-seed mean {b['mean']:.4f} "
          f"± {b['std']:.4f} against JAX's {b['ref_mean']:.4f} ± "
          f"{b['ref_std']:.4f}: |Δ| {abs(b['mean'] - b['ref_mean']):.4f}, "
          f"bound {b['bound']:.4f}; {wall:.2f} s on {gpu}", flush=True)
    if not b["ok"]:
        raise AssertionError("the carried hopper SAC policy is outside the "
                             "bound")
    return dict(mean=b["mean"], std=b["std"], bound=b["bound"],
                per_seed=rews.tolist(), wall_s=wall)



# The sample mesh (``mbd_tpu_torch/parallel``): MESH_RANKS ranks on the one
# card, gloo over CUDA tensors (NCCL refuses two ranks on one card), then
# NCCL at world size 1. PPO on pushT at its reference config for 2
# iterations and one eval.
MESH_RANKS = 2
# on a machine with several cards: multichip's cases over up to 4 of them
MULTICHIP_CARDS = 4
MULTICHIP_CASES = ("dryrun", "hopper_seeds8")
PPO_MESH_TIMESTEPS = 2 * 2048 * 20
# a sharded PPO against one process: JAX's meshed bound
# (tests/test_rl_mesh.py); the planners must agree bit for bit
PPO_MESH_TOL = 1e-4
# the model each mesh case runs (PPO: the state-out mode)
MESH_ENV = {"hopper": "hopper", "hopper_mppi": "hopper",
            "hopper_batch": "hopper", "humanoidtrack_demo": "humanoidtrack",
            "pushT_ppo": "pushT_rl"}


def _plan_fields(res) -> dict:
    """A plan's result fields, on the host."""
    fields = {k: getattr(res, k) for k in ("Ybars", "mu_0ts", "rews_trace",
                                           "final_reward", "final_diverged")
              if hasattr(res, k)}
    return {k: v.cpu() if hasattr(v, "cpu") else v for k, v in fields.items()}


def mesh_cases(mesh):
    """Every mesh case on the card, on ``mesh`` (``None``: this process
    alone): each one's results on the host, its launches by mode, the
    samples of each launch, and its wall. Before the timed cases, an
    untimed short run of each model (hopper, humanoidtrack + demo, pushT
    PPO) takes the process's first launches and collectives, so that no
    case's wall holds them. Run by each spawned rank, so it imports what
    it needs itself."""
    import dataclasses

    import torch

    from mbd_tpu_torch import envs
    from mbd_tpu_torch.ops import rollout_cuda as rc
    from mbd_tpu_torch.planners import mbd
    from mbd_tpu_torch.planners import path_integral as pi
    from mbd_tpu_torch.rl import ppo, train

    samples = []
    run = rc.Built.run

    def counted(self, env, state0, U, *args, **kwargs):
        samples.append(U.shape[0])
        return run(self, env, state0, U, *args, **kwargs)

    rc.Built.run = counted

    def gen(s):
        return torch.Generator("cuda").manual_seed(s)

    hopper = envs.get_env("hopper", device="cuda")
    track = envs.get_env("humanoidtrack", device="cuda")
    pusht = envs.get_env("pushT", device="cuda")
    ppo_cfg = ppo.PPOConfig(**dict(train.PPO_CONFIGS["pushT"],
                                   num_timesteps=PPO_MESH_TIMESTEPS,
                                   num_evals=1))

    def ppo_run():
        _, params, hist = ppo.train(pusht, ppo_cfg, mesh=mesh)
        state = {f"{net}.{k}": v.detach().cpu() for net in
                 ("policy", "value") for k, v in
                 getattr(params, net).state_dict().items()}
        state.update({f"obs_stats.{k}": v.detach().cpu() for k, v in
                      vars(params.obs_stats).items()})
        return dict(params=state, eval=hist[0]["eval/episode_reward"])

    cases = {
        "hopper": lambda: _plan_fields(mbd.plan(
            hopper, mbd.recommended_config("hopper"), gen(0), mesh=mesh)),
        "hopper_mppi": lambda: _plan_fields(pi.plan(
            hopper, pi.recommended_config("hopper", pi.PathIntegralConfig(
                update_method="mppi")), gen(0), mesh=mesh)),
        "humanoidtrack_demo": lambda: _plan_fields(mbd.plan(
            track, mbd.recommended_config("humanoidtrack", mbd.MBDConfig(
                enable_demo=True)), gen(0), mesh=mesh)),
        "hopper_batch": lambda: _plan_fields(mbd.plan_batch(
            hopper, mbd.recommended_config("hopper"), [gen(0), gen(1)],
            mesh=mesh)),
        "pushT_ppo": ppo_run}
    mbd.plan(hopper, dataclasses.replace(mbd.recommended_config("hopper"),
                                         Ndiffuse=3), gen(0), mesh=mesh)
    mbd.plan(track, dataclasses.replace(mbd.recommended_config(
        "humanoidtrack", mbd.MBDConfig(enable_demo=True)), Ndiffuse=3),
        gen(0), mesh=mesh)
    ppo.train(pusht, dataclasses.replace(
        ppo_cfg, num_timesteps=ppo_cfg.num_envs * ppo_cfg.unroll_length),
        mesh=mesh)
    out = {}
    for name, fn in cases.items():
        rc.LAUNCHES = rc.DEMO_LAUNCHES = rc.STATE_LAUNCHES = 0
        samples.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        out[name] = dict(result=result, launches=rc.LAUNCHES,
                         demo_launches=rc.DEMO_LAUNCHES,
                         state_launches=rc.STATE_LAUNCHES,
                         samples=sorted(set(samples)),
                         wall_s=time.perf_counter() - t0)
    rc.Built.run = run
    return out


def _same(a, b) -> bool:
    """Two results' fields (``_plan_fields``) equal bit for bit."""
    import torch

    return a.keys() == b.keys() and all(
        torch.equal(v, b[k]) if isinstance(v, torch.Tensor) else v == b[k]
        for k, v in a.items())


def drive_mesh(torch, gpu):
    """The mesh cases (``mesh_cases``) in this process and then on
    MESH_RANKS spawned ranks on the one card (gloo): every plan's Ybars
    (or mu_0ts), rews_trace, final_reward and flags equal this process's
    bit for bit on every rank; PPO's parameters equal on every rank and
    within PPO_MESH_TOL of this process's; each rank launches the kernel
    on its shard only (hopper: 99 launches of 1024 samples and one of
    the final selection's 50 or 49). Then hopper's plan again with NCCL
    at world size 1, equal to this process's. Then, with 2 cards or
    more, ``multichip.run`` of MULTICHIP_CASES over up to MULTICHIP_CARDS
    of them."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from mbd_tpu_torch.parallel import sample_mesh, start_ranks

    single = mesh_cases(None)
    ranks = start_ranks(mesh_cases, MESH_RANKS, backend="gloo",
                        device="cuda")
    outs = ranks.wait()
    report = {}
    for name, ref in single.items():
        per_rank = [o[name] for o in outs]
        if name == "pushT_ppo":
            p0 = per_rank[0]["result"]["params"]
            same_ranks = all(torch.equal(o["result"]["params"][k], v)
                             for o in per_rank[1:] for k, v in p0.items())
            ref_p = ref["result"]["params"]
            err = max(float((p0[k] - v).abs().max()) for k, v in
                      ref_p.items())
            exact = all(torch.equal(p0[k], v) for k, v in ref_p.items())
            ok = same_ranks and all(torch.allclose(
                p0[k], v, rtol=PPO_MESH_TOL, atol=PPO_MESH_TOL)
                for k, v in ref_p.items())
            detail = (f"parameters equal on every rank: {same_ranks}; "
                      f"against one process max |Δ| {err:.3g} "
                      f"({'bit for bit' if exact else 'not bit for bit'}); "
                      f"eval {per_rank[0]['result']['eval']:.6f} against "
                      f"{ref['result']['eval']:.6f}")
        else:
            ok = exact = all(_same(o["result"], ref["result"])
                             for o in per_rank)
            detail = f"bit for bit on every rank: {ok}"
        print(f"mesh {name}: {detail}; launches per rank "
              f"{[o['launches'] for o in per_rank]} of "
              f"{[o['samples'] for o in per_rank]} samples (one process: "
              f"{ref['launches']} of {ref['samples']}); wall per rank "
              f"{[round(o['wall_s'], 3) for o in per_rank]} s against "
              f"{ref['wall_s']:.3f} s in one process on {gpu}", flush=True)
        if not ok:
            raise AssertionError(f"mesh {name}: the sharded run differs")
        report[name] = dict(
            exact=exact, launches=[o["launches"] for o in per_rank],
            samples=[o["samples"] for o in per_rank],
            demo_launches=[o["demo_launches"] for o in per_rank],
            state_launches=[o["state_launches"] for o in per_rank],
            wall_s=[o["wall_s"] for o in per_rank],
            single_wall_s=ref["wall_s"], single_launches=ref["launches"])
    hop = report["hopper"]
    for launches, samples in zip(hop["launches"], hop["samples"]):
        if launches != 100 or max(samples) != 1024 or len(samples) != 2:
            raise AssertionError(f"mesh hopper: {launches} launches of "
                                 f"{samples} samples on a rank")
    report["spawn_and_run_s"] = ranks.wall_s
    # NCCL at world size 1, in this process
    store = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    dist.init_process_group("nccl", init_method="file://" + os.path.join(
        store, "store"), rank=0, world_size=1)
    try:
        from mbd_tpu_torch import envs
        from mbd_tpu_torch.planners import mbd

        mesh = sample_mesh()
        res = mbd.plan(envs.get_env("hopper", device="cuda"),
                       mbd.recommended_config("hopper"),
                       torch.Generator("cuda").manual_seed(0), mesh=mesh)
        nccl_ok = _same(_plan_fields(res), single["hopper"]["result"])
        print(f"mesh hopper with NCCL at world size 1 on {mesh.device}: "
              f"bit for bit {nccl_ok}, {len(mesh.collectives)} collectives",
              flush=True)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store)
    if not nccl_ok:
        raise AssertionError("mesh: the NCCL plan differs")
    report["nccl_exact"] = nccl_ok
    # across cards, one NCCL rank a card, where the machine has several
    count = torch.cuda.device_count()
    if count < 2:
        print(f"mesh across cards: not run, the machine has {count} card "
              f"(the cross-card cases need at least 2)", flush=True)
        return report
    from mbd_tpu_torch.parallel import multichip

    cross = multichip.run(min(MULTICHIP_CARDS, count), MULTICHIP_CASES,
                          repeat=1, nccl_algos=())
    if not cross["ok"]:
        raise AssertionError("mesh across cards: a check failed")
    # by card count: the wall, and whether every rank equalled one card
    report["multichip"] = {name: {k: dict(exact=row.get("exact"),
                                          wall_s=row["wall_s"])
                                  for k, row in by_cards.items()}
                           for name, by_cards in cross["cases"].items()}
    return report


def drive_mnist(torch, sq, gpu):
    """MNIST weight diffusion at the published config (Nsample 256,
    Ndiffuse 500) on the card, seeds 0–5: the 6-seed mean final test
    accuracy within 3·√((σ_JAX² + σ²)/6) of JAX's over the same seeds
    (``mbd_tpu_torch/assets/mnist_jax.json``); no kernel launches."""
    from mbd_tpu_torch.blackbox import mnist
    from mbd_tpu_torch.ops import rollout_cuda as rc

    with open(os.path.join(os.path.dirname(mnist.ASSET),
                           "mnist_jax.json")) as f:
        ref = json.load(f)
    cfg = mnist.MnistDiffusionConfig()
    data = mnist.load_dataset()
    rc.LAUNCHES = 0
    accs, Js, walls = [], [], []
    for seed in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, (J, acc) = mnist.train(cfg, torch.Generator("cuda").manual_seed(
            seed), data=data)
        accs.append(float(acc[-1]))
        Js.append(float(J[-1]))
        walls.append(time.perf_counter() - t0)
        print(f"  mnist seed {seed}: test accuracy {accs[-1]:.4f}, J "
              f"{Js[-1]:.6f}, {walls[-1]:.2f} s on {gpu}", flush=True)
    b = sq.bound(ref["test_acc_mean"], ref["test_acc_std"], accs)
    print(f"mnist, 6 seeds at {cfg.Nsample} / {cfg.Ndiffuse}: test accuracy "
          f"{b['mean']:.4f} ± {b['std']:.4f} against JAX's "
          f"{b['ref_mean']:.4f} ± {b['ref_std']:.4f}: |Δ| "
          f"{abs(b['mean'] - b['ref_mean']):.4f}, bound {b['bound']:.4f}; "
          f"{rc.LAUNCHES} kernel launches", flush=True)
    if not b["ok"] or rc.LAUNCHES or not all(map(math.isfinite, Js)):
        raise AssertionError("mnist: outside the bound, a launch, or a "
                             "J not finite")
    return dict(mean=b["mean"], std=b["std"], bound=b["bound"],
                test_acc=accs, J=Js, wall_s=walls)


# the explainer's and the 1-D demo's numerics, card against CPU: float64
# both, the same normals; they differ only in libm's last bits and the
# order of sums
EXPLAINER_ATOL = 1e-6


def explainer_numerics(torch, device) -> dict:
    """The noising paths of the explainer's three acts, its score field,
    and the 1-D demo's forward densities and reverse ascent on ``device``,
    from normals drawn on the CPU; each on the host."""
    from mbd_tpu_torch.cli import vis_explainer as ve
    from mbd_tpu_torch.notebooks import demo_1d as d1

    f64 = dict(dtype=torch.float64)
    gen = torch.Generator().manual_seed(0)
    grown = ve.R0 * ve.RSCALE
    out = {}
    for s in ve.SCALES:
        for act, clean in ((1, ve.demo_traj(s, device=device)),
                           (2, ve.demo_traj(s, grown, device=device)),
                           (3, ve._model_traj(s, grown, device=device))):
            z = torch.randn((24,) + tuple(clean.shape), generator=gen,
                            **f64).to(device)
            out[f"act{act} {s}"] = torch.stack(ve.noising_path(
                clean, 24, normals=z)).cpu()
    axis = torch.linspace(-1.8, 1.8, 13, **f64)
    grid = torch.stack(torch.meshgrid(axis, axis, indexing="xy"), dim=-1)
    out["score"] = ve.score_field(grid.to(device)).cpu()
    alphas, ab, sig = d1.schedule(100, device)
    y = torch.linspace(-2, 2, 400, device=device, **f64)
    out["densities"] = d1.forward_densities(y, d1.target_density(y),
                                            ab).cpu()
    z = torch.randn((99, 512), generator=gen, **f64).to(device)
    out["reverse"] = d1.reverse_mc(z, alphas, ab, sig, 100).cpu()
    return out


def drive_explainer(torch, gpu):
    """``explainer_numerics`` on the card against the CPU, to
    EXPLAINER_ATOL; nothing is drawn (the card's machine may lack
    matplotlib)."""
    cpu = explainer_numerics(torch, "cpu")
    t0 = time.perf_counter()
    card_ = explainer_numerics(torch, "cuda")
    wall = time.perf_counter() - t0
    err = max(float((card_[k] - v).abs().max()) for k, v in cpu.items())
    print(f"explainer and demo_1d numerics, card against CPU: max |Δ| "
          f"{err:.3g} over {len(cpu)} arrays (at most {EXPLAINER_ATOL}); "
          f"{wall:.2f} s on {gpu}", flush=True)
    if not err <= EXPLAINER_ATOL:
        raise AssertionError("explainer: the card's numerics differ")
    return dict(max_abs_err=err, wall_s=wall)


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
    from mbd_tpu_torch.utils import profiling
    import seed_quality as sq

    t_start = time.perf_counter()

    def elapsed():
        return f"t = {time.perf_counter() - t_start:.0f} s"

    gpu = profiling.card()
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
                        dict(N=8192, H=50, flags=True)),
        "humanoidtrack": (mbd.recommended_config(
            "humanoidtrack", mbd.MBDConfig(enable_demo=True)),
            dict(min_logpd=MIN_HUMANOIDTRACK_LOGPD),
            dict(N=2048, H=50, demo=True)),
        "pushT": (mbd.recommended_config("pushT"),
                  dict(min_reward=MIN_PUSHT_REWARD), dict(N=2048, H=40))}
    # the baselines after each of these paths, with their floors
    baselines = {"hopper": MIN_HOPPER_BASELINE,
                 "pushT": dict.fromkeys(BASELINES)}

    # the seed-batched paths after these, each given the serial plan
    def hopper_batch(serial):
        """8 seeds at hopper's recommended config, within the two-sample
        bound of JAX's 8-seed mean, no seed flagged, seed 0 its serial
        plan; then MPPI, CEM and CMA-ES batched the same way."""
        cfg, S = paths["hopper"][0], 8
        env, res, launches, wall = drive_batch(torch, envs, rc, fused, mbd,
                                               "hopper", cfg, S, gpu)
        if bool(res.final_diverged.any()):
            raise AssertionError("plan_batch hopper: a seed is flagged")
        out = dict(launches=launches, wall_s=wall, **check_bound(
            sq, "hopper MBD", res.final_reward.tolist(), "hopper"))
        gap = abs(float(res.final_reward[0]) - float(serial.final_reward))
        print(f"  seed 0 in the batch {float(res.final_reward[0]):.6f}, "
              f"serial {float(serial.final_reward):.6f}: |Δ| {gap:.3g} "
              f"(at most {BATCH_SERIAL_ATOL})", flush=True)
        if not gap <= BATCH_SERIAL_ATOL:
            raise AssertionError("seed 0 of the batch is not its serial plan")
        out["ms_SN"], out["ms_one_seed"], layout, out["max_abs_err"] = \
            batch_checks(torch, rc, mbd, env, cfg, S)
        out["G"] = layout["G"]
        out["baselines"] = {}
        for method in BASELINES:
            pcfg = pi.recommended_config("hopper", pi.PathIntegralConfig(
                update_method=method))
            _, pres, n, pwall = drive_batch(torch, envs, rc, fused, pi,
                                            "hopper", pcfg, S, gpu)
            out["baselines"][method] = dict(
                launches=n, wall_s=pwall,
                flagged=int(pres.final_diverged.sum()), **check_bound(
                    sq, f"hopper {method}", pres.final_reward.tolist(),
                    f"hopper/{method}"))
        return out

    def humanoidrun_batch(serial):
        """8 × 8192 samples a step (N = 65 536) for a few steps."""
        cfg = dataclasses.replace(paths["humanoidrun"][0], Ndiffuse=4)
        env, _, launches, wall = drive_batch(torch, envs, rc, fused, mbd,
                                             "humanoidrun", cfg, 8, gpu)
        ms_sn, ms_1, layout, err = batch_checks(torch, rc, mbd, env, cfg, 8)
        return dict(launches=launches, wall_s=wall, ms_SN=ms_sn,
                    ms_one_seed=ms_1, G=layout["G"], max_abs_err=err)

    def humanoidtrack_batch(serial):
        """2 seeds with the demo, for a few steps: the per-seed fusion."""
        cfg = dataclasses.replace(paths["humanoidtrack"][0], Ndiffuse=4)
        env, _, launches, wall = drive_batch(torch, envs, rc, fused, mbd,
                                             "humanoidtrack", cfg, 2, gpu)
        ms_sn, ms_1, layout, err = batch_checks(torch, rc, mbd, env, cfg, 2)
        return dict(launches=launches, wall_s=wall, ms_SN=ms_sn,
                    ms_one_seed=ms_1, G=layout["G"], max_abs_err=err)

    batches = {"hopper": hopper_batch, "humanoidrun": humanoidrun_batch,
               "humanoidtrack": humanoidtrack_batch}

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
             need_qs=True),
        # the retiring form where only its exit engages (the mesh's shard)
        # and where only its refill does (hopper_seeds8's launch)
        dict(name="humanoidrun", N=2048, H=50, retire=True),
        dict(name="hopper", N=16384, H=50, retire=True)]
    def plain(**spec):
        case = Case(torch, envs, gen=gen, **spec)
        print(f"plain {case.label()}: {case.plain_ms:.1f} ms ({elapsed()})",
              flush=True)
        return case

    cases = [plain(**spec) for spec in shapes]

    # 3. as each build ends: its checks, then its path
    stats = {name: dict(max_abs_err=0.0, launches=0, modes=set(),
                        baselines={}, plan_batch=None, retire=[])
             for name in ENVS}

    def check(case):
        st = stats[case.name]
        if case.retire or (case.path and not case.demo):
            # the retiring form, at each path's shape too
            st["retire"].append(case.check_retire(torch, rc))
        if case.retire:
            return
        err, ms, bound_ms, bound_by = case.check(torch, rc)
        st["max_abs_err"] = max(st["max_abs_err"], err)
        st["modes"].update(case.modes())
        if case.timed:
            st.update(ms=ms, plain_ms=case.plain_ms, bound_ms=bound_ms,
                      bound_by=bound_by, shape=f"{case.N}x{case.H}",
                      operations=case.ops_per_sample_step() * case.N
                      * case.H, bytes=case.bytes())

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
            if name in batches:
                st["plan_batch"] = batches[name](res)
                st["max_abs_err"] = max(st["max_abs_err"],
                                        st["plan_batch"]["max_abs_err"])
        else:
            cfg = mbd.recommended_config(name, mbd.MBDConfig(**SHORT_PLAN))
            _, _, _, st["launches"] = drive_plan(torch, envs, rc, fused, mbd,
                                                 name, cfg, gpu)
    pool.shutdown()

    # 4. the CLI and the viewer of its denoising process, the replay of
    # the reference's committed plans, the checkpoint, car2d and bbo, each
    # phase's wall printed
    import shutil
    import tempfile

    from mbd_tpu_torch.utils.profiling import Timer

    timer = Timer()

    def phase(name, fn, *args):
        with timer.phase(name):
            out = fn(torch, *args)
        print(f"phase {name}: {timer.as_dict()[name]:.1f} s ({elapsed()})",
              flush=True)
        return out

    cli_out = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        stats["hopper"]["cli"] = phase("cli", drive_cli, rc, fused, envs,
                                       gpu, cli_out)
        stats["hopper"]["vis_diffusion"] = phase(
            "vis_diffusion", drive_vis_diffusion, rc, fused, gpu, cli_out)
    finally:
        shutil.rmtree(cli_out)
    replay_gaps = phase("replay", drive_replay, envs, rc, gpu)
    stats["hopper"]["checkpoint"] = phase("checkpoint", drive_checkpoint,
                                          envs, rc, fused, mbd, gpu)
    analytic = dict(car2d=phase("car2d", drive_car2d, envs, rc, fused, mbd,
                                pi, sq, gpu),
                    bbo=phase("bbo", drive_bbo, sq, gpu))
    rl_step = phase("rl_step", drive_rl_step, envs, rc, fused, gpu)
    rl = dict(ppo=phase("ppo", drive_ppo, rc, fused, gpu),
              sac=phase("sac", drive_sac, rc, fused, gpu),
              eval=phase("rl_eval", drive_rl_eval, gpu))
    mesh = phase("mesh", drive_mesh, gpu)
    others = dict(mnist=phase("mnist", drive_mnist, sq, gpu),
                  explainer=phase("explainer", drive_explainer, gpu))
    walls = timer.as_dict()
    print(f"smoke: {time.perf_counter() - t_start:.0f} s on {gpu}",
          flush=True)

    # 5. results
    from mbd_tpu_torch.rollout import replay

    for name in ENVS:
        st = stats[name]
        print(f"bound {name} {st['shape']}: {st['operations']:.0f} "
              f"operations, {st['bytes']} bytes → {st['bound_ms']:.4f} ms "
              f"({st['bound_by']}); kernel {st['ms']:.3f} ms", flush=True)
    # the analytic path (car2d, bbo) launches no kernel: its numbers and
    # every phase's wall on a line of their own
    print(json.dumps(dict(analytic, phase_walls_s=walls)))
    # RL: each trainer's iterations, walls, losses and evals, and the
    # carried JAX policy's eval
    print(json.dumps({"rl": {
        "ppo": {k: v for k, v in rl["ppo"].items() if k != "history"},
        "sac": {k: v for k, v in rl["sac"].items() if k != "history"},
        "eval": rl["eval"]}}))
    # the mesh (each case's launches, samples and walls per rank), MNIST
    # and the explainer, which launch no kernel
    print(json.dumps(dict(mesh=mesh, **others)))
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
        # plan_batch: launches, wall, ms per launch at S·N and for one
        # seed, max |Δ| against the plain version at S·N, the seeds' mean
        # and std, and whether the mean held the bound against JAX's
        "plan_batch": stats[name]["plan_batch"],
        # the CLI's single run: its launches, need_qs among them; the
        # viewer of its denoising process (need_qs launches); the resume of
        # a checkpointed plan (launches, walls, cost per chunk)
        "cli": stats[name].get("cli"),
        "vis_diffusion": stats[name].get("vis_diffusion"),
        "checkpoint": stats[name].get("checkpoint"),
        # the sharded plans: each case's launches and their
        # samples on each of the ranks
        "mesh": {case: dict(launches=m["launches"], samples=m["samples"])
                 for case, m in mesh.items() if isinstance(m, dict)
                 and MESH_ENV.get(case) == name},
        # the committed plans replayed: the largest |kernel − committed|,
        # and the largest change one ulp of the resets makes
        "replay": {d: g for d, g in replay_gaps.items()
                   if replay.HARNESS[d] == name},
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
        for name in ENVS] + [{
        # the state-out mode, one env step of RL training: a mode of the
        # same kernel, with no Pallas counterpart (JAX takes the step with
        # XLA, mbd_tpu/rl/batched_env.py:83)
        "name": f"env_step[{name}]", "route": "cuda",
        "source": "mbd_tpu_torch/csrc/rollout.cu",
        "replaces": "mbd_tpu/ops/rollout_pallas.py:151",
        "modes": ["state_out"], "shape": f"{st['B']}x1",
        "launches": rl[algo]["launches"],
        "mesh": {case: dict(launches=m["state_launches"],
                            samples=m["samples"])
                 for case, m in mesh.items() if isinstance(m, dict)
                 and MESH_ENV.get(case) == f"{name}_rl"},
        "max_abs_err": st["max_abs_err"], "ms": st["ms"],
        "plain_ms": st["plain_ms"],
        "bound_ms": st["bound_ms"], "bound_by": st["bound_by"],
        "library_ms": None}
        for name, algo, st in (("pushT", "ppo", rl_step["pushT"]),
                               ("hopper", "sac", rl_step["hopper"]))] + [{
        # the retiring form, the planner's reverse step without the demo:
        # a form of the same kernel with no Pallas counterpart; its bound
        # counts the sample-steps it runs, up to each first flag
        "name": f"rollout_retire[{name}]", "route": "cuda",
        "source": "mbd_tpu_torch/csrc/rollout.cu", "replaces": None,
        "modes": ["retire"], **r, "library_ms": None}
        for name in ENVS for r in stats[name]["retire"]]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
