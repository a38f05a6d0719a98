"""The port's bench: plans each cell on one NVIDIA GPU and prints one JSON
line, the counterpart of the JAX package's root ``bench.py``.

    python -m mbd_tpu_torch.bench [--cell NAME ...] [--seed 0] [--repeat 3]
        [--Nsample N] [--Hsample H] [--Ndiffuse T] [--device cuda|cpu]

Each cell (``CELLS``; ``--cell`` repeatable, default all) plans through
the entry points a user calls, ``mbd.plan`` (``mbd.plan_batch`` for
``hopper_seeds8``), with every rollout of a physics env in the CUDA
kernel (``ops/rollout_cuda.py``). Per cell:

1. set-up: the kernel's build (every model's starts at once, in threads;
   ``build_s`` is its wall, shared by the cells of one model), then one
   untimed warm-up plan;
2. the timed plans (the cell's ``repeat``, 3, and 9 for the host-bound
   car2d, whose walls spread most; ``--repeat`` sets every cell's), each
   from a fresh generator seeded ``--seed`` (seeds s…s+7 for
   ``hopper_seeds8``), tracing off: a host clock around the whole
   ``mbd.plan`` (the reset, the reverse diffusion and the final
   selection; the JAX bench timed the diffusion's scan only) that ends in
   ``torch.cuda.synchronize()``; ``wall_s`` is their median; the peak of
   device memory over them;
3. one more plan under ``torch.profiler``: the busy share (the union of
   the card's activity over the traced wall), the kernel's device time
   and count (``rollout_kernel`` by substring), ``host_s`` (``wall_s``
   less the card's busy seconds in the trace: the profiler slows the
   host, not the card, so this is the untraced plan's host time) and the
   tracing overhead (the traced wall less ``wall_s``); on the CPU this
   plan runs untraced;
4. the last step again: the launch of the plan's last reverse step at its
   own shape (all S·Nsample samples over the whole horizon, each seed's
   final plan in place of its sample 0) through the plain engine
   (``rollout/fused.py::rollout_outputs``), which records the constraint
   rows that acted (``utils/work.py::acting_rows``); on the card, the
   parity: the kernel on the same inputs, flags equal, max |Δ| ≤ 1e-5,
   the demo log-density ≤ 2.4e-7 (the smoke's tolerances). The plain
   engine takes about a minute a cell on the card.

The line: ``device`` (name and power limit as ``nvidia-smi`` reads them,
``torch.cuda.get_device_name``, count, platform) and ``cells``, one entry
each: ``config``, ``seed``, ``reduced`` (each cut of the published config
or of ``--repeat``), ``wall_s`` and ``wall_s_runs``, ``env_steps`` =
(Ndiffuse − 1)·S·Nsample·H and ``env_steps_per_s`` (the JAX bench's unit,
read beside it, never a target), ``plain_engine_ops`` = Σ
``utils/work.py``'s WORK · sample-steps over what the plan rolled out (the
final selection's launch included; car2d's analytic steps from the plan's
structure), ``rows_acting`` (the share of contact and limit row-substeps
that acted in the last step's launch) and ``work_ops``, what the plan
needs: each sample-step's WORK less ``ROW_WORK`` for the rows that did
not act, at the last step's shares (an estimate for the earlier steps,
whose samples are noisier); ``mfu`` = work_ops / wall_s / the FP32 peak,
with the card's power limit beside it; ``final_reward`` (over S seeds,
their mean) and ``final_diverged`` (any), the final plan's demo
log-density for a demo cell, ``checks`` and ``correct``; ``per_layer``:
launches, demo launches, sample-steps, the kernel's ms per launch and
seconds, operations (of ``work_ops``), bytes and bound per launch (means
over the plan's launches) and what bounds it, ``roofline_share`` (the
bound over the kernel's ms per launch), host seconds, busy share, the
layout of the step's launch (``Built.attrs``), ``build_s``,
``peak_mem_bytes`` and ``tracing_overhead_s``.

``correct`` holds every check that applies: the parity; launches and
sample-steps as the plan's steps and final selection give them (none for
car2d); no plain engine on the card; the same counts in every run; the
kernel's count in the trace equal to the launches; ``mfu``,
``roofline_share`` and the busy share in (0, 1.05] (a share above that
means a wrong count or window); a finite final reward. At the published
config also the plan's: not diverged, and the quality floors of PERF.md
§2 (``FLOORS``); a cut config cannot promise a plan's quality, so there
those two are ``null``. Any false check exits 1 after the line.

No fallback: without a card, and without ``--device cpu``, it prints an
error line and exits 1; a build or launch failure is an error line and
exit 1, as is the watchdog (``BENCH_WATCHDOG_S``, default 2700 s), which
names the cell that stalled. ``--device cpu`` (the rehearsal and the
tests) runs the same control flow with the plain engine and writes null
for every field derived from a time, a rate or the device; it keeps the
counts and ``correct`` (without the parity).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import statistics
import sys
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from dataclasses import asdict, dataclass, replace
from typing import Optional

import torch

from . import envs
from .core.schedule import make_schedule
from .envs.physics import PhysicsEnv
from .ops import rollout_cuda
from .planners import mbd
from .rollout import fused
from .rollout.rollout import rollout_us
from .utils import profiling
from .utils.work import (PEAK_FLOPS, WORK, Rows, acting_rows, bound_ms,
                         needed_per_sample_step, rollout_bytes)

# timed plans a cell, and a host-bound cell's (its walls spread most)
REPEAT, HOST_REPEAT = 3, 9
WATCHDOG_S = 2700.0
# kernel against plain engine, chip_smoke.py's tolerances
ATOL, LOGPD_ATOL = 1e-5, 2.4e-7
# above this a share means a wrong count or window
MAX_SHARE = 1.05
# the line's fields, and those a CPU run writes null (derived from a time,
# a rate or the card)
FIELDS = ("config", "seed", "reduced", "wall_s", "wall_s_runs",
          "env_steps", "env_steps_per_s", "plain_engine_ops", "rows_acting",
          "work_ops", "mfu", "power_limit", "final_reward",
          "final_reward_seeds", "final_diverged", "final_logpd", "parity",
          "checks", "correct", "per_layer")
LAYER_FIELDS = ("launches", "demo_launches", "sample_steps",
                "demo_sample_steps", "kernel_ms_per_launch", "kernel_s",
                "ops_per_launch", "bytes_per_launch", "bound_ms_per_launch",
                "bound_by", "roofline_share", "host_s", "busy_share", "G",
                "regs", "shared_bytes", "local_bytes", "build_s",
                "peak_mem_bytes", "tracing_overhead_s")
DEVICE_FIELDS = ("wall_s", "wall_s_runs", "env_steps_per_s", "mfu",
                 "power_limit")
DEVICE_LAYER = LAYER_FIELDS[4:]


@dataclass(frozen=True)
class Cell:
    """A model, its published config, the seeds planned in one batch
    (``plan_batch`` when more than one) and the timed plans."""
    env: str
    cfg: mbd.MBDConfig
    seeds: int = 1
    repeat: int = REPEAT


def _recommended(name: str, **base) -> mbd.MBDConfig:
    return mbd.recommended_config(name, mbd.MBDConfig(**base))


# The cells: bench.py's two humanoidrun shapes (its north star at 1024
# and the flagship at 8192), then the recommended configs of the paper's
# headline env, of the demo-conditioned humanoid, of the sphere-box pair,
# of the 8-seed harness and of the analytic path (no kernel).
CELLS = {
    "humanoidrun_n1024": Cell("humanoidrun", mbd.MBDConfig(
        Nsample=1024, Hsample=50, Ndiffuse=300, temp_sample=0.1)),
    "humanoidrun": Cell("humanoidrun", _recommended("humanoidrun")),
    "hopper": Cell("hopper", _recommended("hopper")),
    "humanoidtrack_demo": Cell("humanoidtrack", _recommended(
        "humanoidtrack", enable_demo=True)),
    "pushT": Cell("pushT", _recommended("pushT")),
    "hopper_seeds8": Cell("hopper", _recommended("hopper"), seeds=8),
    "car2d_demo": Cell("car2d", _recommended("car2d", enable_demo=True),
                       repeat=HOST_REPEAT),
}
# Quality floors at the published config (PERF.md §2): (field, floor,
# strict). humanoidrun_n1024 has none: JAX published no level at 1024.
FLOORS = {
    "humanoidrun": ("final_reward", 1.0, False),
    "hopper": ("final_reward", 1.8, False),
    "humanoidtrack_demo": ("final_logpd", -0.70, False),
    "pushT": ("final_reward", 0.57, False),
    "hopper_seeds8": ("final_reward", 1.8, False),
    "car2d_demo": ("final_reward", 0.05, True),
}


def error_line(message: str, cell: Optional[str] = None) -> str:
    return json.dumps({"error": message, "cell": cell})


class Watchdog:
    """Prints an error line naming the cell in progress and ends the
    process with exit 1 when ``stop`` is not called within ``seconds``."""

    def __init__(self, seconds: float):
        self.cell: Optional[str] = None
        self._done = threading.Event()
        self._seconds = seconds
        threading.Thread(target=self._fire, daemon=True).start()

    def _fire(self):
        if not self._done.wait(self._seconds):
            print(error_line(f"bench watchdog expired after "
                             f"{self._seconds:.0f} s", self.cell), flush=True)
            os._exit(1)

    def stop(self):
        self._done.set()


def env_steps(cfg: mbd.MBDConfig, seeds: int = 1) -> int:
    """The env steps of a plan's reverse diffusion, the JAX bench's count
    (bench.py: (Ndiffuse − 1)·Nsample·H) times the seeds."""
    return (cfg.Ndiffuse - 1) * seeds * cfg.Nsample * cfg.Hsample


def last_step_samples(env, cfg: mbd.MBDConfig, seed: int,
                      Ybars: torch.Tensor) -> torch.Tensor:
    """The samples [Nsample, H, nu] of the last reverse step of the plan
    of ``seed`` whose iterates are ``Ybars`` [T, H, nu]: its noise drawn
    again from a generator seeded as the plan's (the reset first, then a
    draw a step), formed as the planner forms them, clamp(ε·σ₁ + Ȳ, −1,
    1), Ȳ the iterate before the last step."""
    device = Ybars.device
    gen = torch.Generator(device).manual_seed(seed)
    env.reset(gen)
    shape = (cfg.Nsample, cfg.Hsample, env.action_size)
    for _ in range(cfg.Ndiffuse - 1):
        eps = torch.randn(shape, generator=gen, device=device)
    sched = make_schedule(cfg.Ndiffuse, cfg.beta0, cfg.betaT, device=device)
    prev = Ybars[-2] if len(Ybars) > 1 else torch.zeros_like(Ybars[-1])
    return torch.clamp(eps * sched.sigmas[1] + prev, -1.0, 1.0)


def last_step(env, cfg: mbd.MBDConfig, seed: int, Ybars: torch.Tensor):
    """The launch of the last reverse step of the plan of seeds seed… over
    Ybars [S, T, H, nu]: (the initial states of its S·Nsample samples, the
    samples), each seed's final plan in place of its sample 0."""
    S, N = Ybars.shape[0], cfg.Nsample
    gens = [torch.Generator(Ybars.device).manual_seed(seed + s)
            for s in range(S)]
    state0 = mbd.batch_states(env, [env.reset(g) for g in gens], N)
    Y0s = torch.stack([last_step_samples(env, cfg, seed + s, Ybars[s])
                       for s in range(S)])
    Y0s[:, 0] = Ybars[:, -1]
    return state0, Y0s.reshape((S * N,) + Y0s.shape[2:])


def parity(env, cfg: mbd.MBDConfig, state0, Y0s: torch.Tensor):
    """The kernel against the plain engine on the last step's launch
    (``last_step``); (the comparison, or None off the card, and the rows
    the plain engine saw act)."""
    demo = cfg.enable_demo
    plain, rows = acting_rows(fused.rollout_outputs, env, state0, Y0s,
                              demo=demo)
    if not Y0s.is_cuda:
        return None, rows
    got = rollout_cuda.rollout_rewards_cuda(env, state0, Y0s, demo=demo)
    err = float((got[0] - plain[0]).abs().max())
    out = dict(shape=f"{Y0s.shape[0]}x{Y0s.shape[1]}", max_abs_err=err,
               flags_equal=bool(torch.equal(got[1], plain[1])),
               flagged=int(got[1].sum()))
    ok = out["flags_equal"] and err <= ATOL
    if demo:
        out["logpd_max_abs_err"] = float((got[2] - plain[2]).abs().max())
        ok = ok and out["logpd_max_abs_err"] <= LOGPD_ATOL
    out["ok"] = ok
    return out, rows


def final_logpd(env, seed: int, plan: torch.Tensor) -> float:
    """The demo log-density of the final plan [H, nu] from its reset: the
    kernel's demo mode (its plain version on the CPU), or car2d's
    ``eval_xref_logpd`` of its states."""
    state = env.reset(torch.Generator(plan.device).manual_seed(seed))
    if isinstance(env, PhysicsEnv):
        return float(rollout_cuda.rollout_rewards_cuda(
            env, state, plan[None], demo=True)[2][0])
    return float(env.eval_xref_logpd(rollout_us(env, state, plan)[1]))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _counts() -> dict:
    return dict(launches=rollout_cuda.LAUNCHES,
                demo_launches=rollout_cuda.DEMO_LAUNCHES,
                sample_steps=rollout_cuda.SAMPLE_STEPS,
                demo_sample_steps=rollout_cuda.DEMO_SAMPLE_STEPS,
                plain_on_card=fused.CUDA_CALLS)


def plan_once(env, cell: Cell, cfg: mbd.MBDConfig, seed: int):
    """One plan with the counts set to 0 just before and read just after:
    (result, wall s, counts)."""
    device = env.device
    gens = [torch.Generator(device).manual_seed(seed + s)
            for s in range(cell.seeds)]
    _sync(device)
    rollout_cuda.LAUNCHES = rollout_cuda.DEMO_LAUNCHES = 0
    rollout_cuda.SAMPLE_STEPS = rollout_cuda.DEMO_SAMPLE_STEPS = 0
    fused.CUDA_CALLS = 0
    t0 = time.perf_counter()
    if cell.seeds == 1:
        res = mbd.plan(env, cfg, gens[0])
    else:
        res = mbd.plan_batch(env, cfg, gens)
    _sync(device)
    wall = time.perf_counter() - t0
    return res, wall, _counts()


def planned_work(cell: Cell, cfg: mbd.MBDConfig, physics: bool) -> dict:
    """What the plan's structure rolls out: T = Ndiffuse − 1 steps of
    S·Nsample samples (with the demo when the config has it) and the final
    selection, of S·T samples for a physics env (every iterate) and of S
    for car2d (the last iterate), each over H steps."""
    S, N, H = cell.seeds, cfg.Nsample, cfg.Hsample
    T = cfg.Ndiffuse - 1
    final = S * T if physics else S
    return dict(T=T, step_samples=S * N, final_samples=final,
                sample_steps=(T * S * N + final) * H,
                demo_sample_steps=T * S * N * H * int(cfg.enable_demo))


def plan_ops(model: str, src: dict, per_step) -> float:
    """Σ ops · sample-steps over ``src``'s (the counts of what a physics
    plan rolled out, or car2d's plan structure): ``per_step(model, demo)``
    operations a sample-step, with and without the demo."""
    demo = src["demo_sample_steps"]
    ops = per_step(model, False) * (src["sample_steps"] - demo)
    return ops + per_step(model, True) * demo if demo else ops


def bound_of_plan(env, model: str, cfg: mbd.MBDConfig, planned: dict,
                  per_step):
    """The kernel's least time over the plan's launches, summed (ms), its
    bytes, and what bounds its step launches; ``per_step`` as in
    ``plan_ops``."""
    H, demo = cfg.Hsample, cfg.enable_demo
    T, step, final = (planned["T"], planned["step_samples"],
                      planned["final_samples"])
    step_bytes = rollout_bytes(env, step, H, per_sample=True, demo=demo)
    final_bytes = rollout_bytes(env, final, H, per_sample=True)
    step_ms, by = bound_ms(per_step(model, demo) * step * H, step_bytes)
    final_ms, _ = bound_ms(per_step(model, False) * final * H, final_bytes)
    return T * step_ms + final_ms, T * step_bytes + final_bytes, by


def _share(x: Optional[float]) -> Optional[bool]:
    return None if x is None else bool(0.0 < x <= MAX_SHARE)


def _log(message: str):
    print(message, file=sys.stderr, flush=True)


def run_cell(name: str, cell: Cell, cfg: mbd.MBDConfig, reduced: list,
             args, env, build, power_limit: Optional[str]) -> dict:
    """The protocol of the module docstring for one cell."""
    device = env.device
    on_card = device.type == "cuda"
    physics = isinstance(env, PhysicsEnv)
    model, S = cell.env, cell.seeds
    layout, build_s = {}, None
    if physics and on_card:
        built, build_s = build.result()
        layout = built.attrs(S * cfg.Nsample)
    plan_once(env, cell, cfg, args.seed)                       # warm-up

    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    walls, runs = [], []
    for _ in range(args.repeat or cell.repeat):
        res, wall, counts = plan_once(env, cell, cfg, args.seed)
        walls.append(wall)
        runs.append(counts)
    peak_mem = torch.cuda.max_memory_allocated(device) if on_card else None
    # the trace reads the card only: on the CPU the plan runs untraced
    tracer = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA]) if on_card \
        else contextlib.nullcontext()
    with tracer as prof:
        res, traced_wall, traced = plan_once(env, cell, cfg, args.seed)
    runs.append(traced)
    counts = runs[0]
    wall = statistics.median(walls)

    Ybars = res.Ybars if S > 1 else res.Ybars[None]        # [S, T, H, nu]
    rewards = res.final_reward.reshape(-1).tolist()
    final_reward = sum(rewards) / len(rewards)
    diverged = bool(torch.as_tensor(res.final_diverged).any())
    logpd = final_logpd(env, args.seed, Ybars[0, -1]) if cfg.enable_demo \
        else None

    planned = planned_work(cell, cfg, physics)
    src = counts if physics else planned
    plain_ops = plan_ops(model, src, lambda m, d: WORK[m, d])
    par, rows, acting = None, Rows(0, 0, 0, 0), None
    if physics:
        state0, Y0s = last_step(env, cfg, args.seed, Ybars)
        par, rows = parity(env, cfg, state0, Y0s)
        acting = dict(contacts=rows.contacts_acting / rows.contacts
                      if rows.contacts else None,
                      limits=rows.limits_acting / rows.limits
                      if rows.limits else None,
                      shape=f"{Y0s.shape[0]}x{Y0s.shape[1]}")

    def per_step(m, demo):
        return needed_per_sample_step(m, demo, rows,
                                      Y0s.shape[0] * Y0s.shape[1]) \
            if physics else WORK[m, demo]

    ops = plan_ops(model, src, per_step)
    per_layer = dict(
        launches=counts["launches"], demo_launches=counts["demo_launches"],
        sample_steps=counts["sample_steps"],
        demo_sample_steps=counts["demo_sample_steps"],
        kernel_ms_per_launch=None, kernel_s=None, ops_per_launch=None,
        bytes_per_launch=None, bound_ms_per_launch=None, bound_by=None,
        roofline_share=None, host_s=None, busy_share=None,
        **{k: layout.get(k) for k in rollout_cuda.LAYOUT},
        build_s=build_s, peak_mem_bytes=peak_mem,
        tracing_overhead_s=traced_wall - wall if on_card else None)
    checks = dict(
        finite=all(math.isfinite(r) for r in rewards),
        counts_repeat=all(r == counts for r in runs),
        parity=None if par is None else par["ok"],
        no_plain_engine_on_card=counts["plain_on_card"] == 0
        if on_card else None,
        launches_as_planned=None, trace_launches=None, mfu_share=None,
        roofline_share=None, busy_share=None, not_diverged=None,
        quality=None)
    if physics:
        expect = dict(sample_steps=planned["sample_steps"],
                      demo_sample_steps=planned["demo_sample_steps"],
                      launches=planned["T"] + 1 if on_card else 0,
                      demo_launches=planned["T"] * int(cfg.enable_demo)
                      if on_card else 0)
    else:
        expect = dict(launches=0, demo_launches=0, sample_steps=0,
                      demo_sample_steps=0)
    checks["launches_as_planned"] = all(counts[k] == v
                                        for k, v in expect.items())
    if on_card:
        kernels = profiling.device_events(prof)
        busy = profiling.busy_us((e.time_range.start, e.time_range.end)
                                 for e in kernels) / 1e6
        per_layer.update(busy_share=busy / traced_wall, host_s=wall - busy)
        checks["busy_share"] = _share(per_layer["busy_share"])
        launches = counts["launches"]
        if physics and launches:
            n, us = profiling.named(profiling.kernel_totals(kernels),
                                    "rollout_kernel")
            bound, nbytes, by = bound_of_plan(env, model, cfg, planned,
                                              per_step)
            per_layer.update(
                kernel_s=us / 1e6, ops_per_launch=ops / launches,
                bytes_per_launch=nbytes / launches,
                bound_ms_per_launch=bound / launches, bound_by=by)
            checks["trace_launches"] = n == launches
            if n:
                kernel_ms = us / 1e3 / n
                per_layer.update(kernel_ms_per_launch=kernel_ms,
                                 roofline_share=bound / launches / kernel_ms)
            checks["roofline_share"] = bool(_share(
                per_layer["roofline_share"]))
    mfu = ops / wall / PEAK_FLOPS if on_card else None
    checks["mfu_share"] = _share(mfu)
    if not reduced:
        checks["not_diverged"] = not diverged
        if name in FLOORS:
            field, floor, strict = FLOORS[name]
            value = logpd if field == "final_logpd" else final_reward
            checks["quality"] = value > floor if strict else value >= floor
    steps = env_steps(cfg, S)
    return dict(
        config=dict(env=model, seeds=S, **asdict(cfg)), seed=args.seed,
        reduced=reduced, wall_s=wall if on_card else None,
        wall_s_runs=walls if on_card else None, env_steps=steps,
        env_steps_per_s=steps / wall if on_card else None,
        plain_engine_ops=plain_ops, rows_acting=acting, work_ops=ops,
        mfu=mfu, power_limit=power_limit, final_reward=final_reward,
        final_reward_seeds=rewards if S > 1 else None,
        final_diverged=diverged, final_logpd=logpd, parity=par,
        checks=checks,
        correct=all(v for v in checks.values() if v is not None),
        per_layer=per_layer)


def cell_config(cell: Cell, args) -> tuple:
    """The cell's config with the command line's cuts, and the list of
    cuts (of the published config and of ``--repeat``)."""
    cfg, reduced = cell.cfg, []
    for key in ("Nsample", "Hsample", "Ndiffuse"):
        value = getattr(args, key)
        if value is not None and value != getattr(cfg, key):
            reduced.append(f"{key} {value} (published {getattr(cfg, key)})")
            cfg = replace(cfg, **{key: value})
    if args.repeat is not None and args.repeat < cell.repeat:
        reduced.append(f"repeat {args.repeat} (default {cell.repeat})")
    return cfg, reduced


def short_run(cells, Ndiffuse: int, Hsample: int,
              timeout: float = 600.0) -> dict:
    """This bench on the card at a cut config, in a subprocess killed at
    ``timeout`` s: its last line, checked. Each cell is ``correct`` with
    every field, its cuts are in ``reduced``, a plan launches Ndiffuse
    times (the steps and the final selection), and ``mfu`` and the
    kernel's ``roofline_share`` lie in (0, 1.05]; anything else raises
    AssertionError. The smoke's bench phase and the card's test run it."""
    import subprocess

    argv = [sys.executable, "-m", "mbd_tpu_torch.bench",
            "--Ndiffuse", str(Ndiffuse), "--Hsample", str(Hsample)]
    for name in cells:
        argv += ["--cell", name]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(argv, cwd=root, capture_output=True, text=True,
                          timeout=timeout)
    sys.stderr.write(proc.stderr[-4000:])
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"bench: exit {proc.returncode}: "
                             f"{proc.stdout[-2000:]}")
    line = json.loads(lines[-1])
    if line["device"]["platform"] != "gpu" or \
            list(line["cells"]) != list(cells) or not line["correct"]:
        raise AssertionError(f"bench: {lines[-1][:2000]}")
    for name, cell in line["cells"].items():
        layer = cell["per_layer"]
        missing = [k for k in FIELDS if k not in cell] + [
            k for k in LAYER_FIELDS if k not in layer]
        cuts = [r.split()[0] for r in cell["reduced"]]
        if missing or not cell["correct"] or not cell["parity"]["ok"] or \
                cuts != ["Hsample", "Ndiffuse"] or \
                layer["launches"] != Ndiffuse or not all(
                    _share(x) for x in (cell["mfu"],
                                        layer["roofline_share"])):
            raise AssertionError(f"bench {name}: missing {missing} or "
                                 f"wrong: {json.dumps(cell)[:2000]}")
    return line


def parse(argv):
    ap = argparse.ArgumentParser(
        prog="python -m mbd_tpu_torch.bench",
        description="Plan each cell on the card; print one JSON line.")
    ap.add_argument("--cell", action="append",
                    help=f"a cell to run, repeatable (default all): "
                         f"{', '.join(CELLS)}")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--repeat", type=int,
                    help=f"timed plans per cell (default {REPEAT}, "
                         f"{HOST_REPEAT} for car2d_demo)")
    ap.add_argument("--Nsample", type=int)
    ap.add_argument("--Hsample", type=int)
    ap.add_argument("--Ndiffuse", type=int)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    names = args.cell or list(CELLS)
    unknown = [n for n in names if n not in CELLS]
    if unknown:
        print(error_line(f"unknown cell {unknown}; the cells are "
                         f"{list(CELLS)}"), flush=True)
        return 1
    if args.repeat is not None and args.repeat < 1:
        print(error_line("--repeat must be at least 1"), flush=True)
        return 1
    if args.device == "cuda" and not torch.cuda.is_available():
        print(error_line("no CUDA card: the bench measures the card and "
                         "never falls back to the CPU (--device cpu is "
                         "the CPU rehearsal)"), flush=True)
        return 1
    device = torch.device(args.device)
    watchdog = Watchdog(float(os.environ.get("BENCH_WATCHDOG_S",
                                             WATCHDOG_S)))
    pool = ThreadPoolExecutor(max_workers=4)
    try:
        if device.type == "cuda":
            gpu, power = (x.strip() for x in profiling.card().split(","))
            info = dict(name=gpu, power_limit=power, platform="gpu",
                        kind=torch.cuda.get_device_name(0),
                        count=torch.cuda.device_count())
        else:
            info = dict(name="cpu", power_limit=None, platform="cpu",
                        kind="cpu", count=None)
        models = {CELLS[n].env for n in names}
        env_of = {m: envs.get_env(m, device=device) for m in models}

        def timed_build(env):
            t0 = time.perf_counter()
            built = rollout_cuda.library(env)
            return built, time.perf_counter() - t0

        builds = {m: pool.submit(timed_build, env)
                  for m, env in env_of.items()
                  if isinstance(env, PhysicsEnv) and device.type == "cuda"}
        cells = {}
        for name in names:
            watchdog.cell = name
            cell = CELLS[name]
            cfg, reduced = cell_config(cell, args)
            _log(f"bench: cell {name} {cfg} seeds {cell.seeds}")
            cells[name] = run_cell(name, cell, cfg, reduced, args,
                                   env_of[cell.env], builds.get(cell.env),
                                   info["power_limit"])
            c = cells[name]
            _log(f"bench: {name} wall {c['wall_s']} mfu {c['mfu']} correct "
                 f"{c['correct']} checks {c['checks']}")
    except Exception as e:  # noqa: BLE001 - the bench's boundary
        watchdog.stop()
        traceback.print_exc()
        print(error_line(f"{type(e).__name__}: {e}", watchdog.cell),
              flush=True)
        return 1
    finally:
        pool.shutdown(wait=False, cancel_futures=True)
    watchdog.stop()
    correct = all(c["correct"] for c in cells.values())
    print(json.dumps(dict(bench="mbd_tpu_torch", device=info, cells=cells,
                          correct=correct)), flush=True)
    return 0 if correct else 1


if __name__ == "__main__":
    sys.exit(main())
