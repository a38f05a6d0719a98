"""One run of a cell: set-up, the window of whole plans through the
cell's entry, and the comparison with the reference.

Set-up loads the env from its snapshot, loads (on a checkout's first run
builds) the rollout kernel through the program's own cache, and warms up
with one plan at the cell's Nsample, Hsample and seeds and Ndiffuse cut to
the traffic's ``warmup_diffuse_steps``: it ends where the window starts.

The window plans the traffic's fixed set of ``problems`` (each a plan's
seeds, for fresh ``torch.Generator``s), in an order drawn from
``--seed`` (``plan_seeds``): how long a plan takes depends on its data
(which contact rows act, which samples flag), so every run plans the same
set and the seed changes the order, not the work. After the window the
reference checks one plan and one later step of it, both drawn from
``--seed`` (``drawn``).

A cell of one card runs in this process (``run_single``); a cell of K
cards spawns one NCCL rank a card as the program's ``start_ranks`` does
(``run_mesh``), each rank running ``rank_main``, and this process touches
no card until they have ended.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from . import trace as tr
from . import window as win
from .spec import Cell

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "mbd_tpu")


class Started:
    """When this process started, read from ``/proc/self/stat`` on the boot
    clock (so that the interpreter's own start counts)."""

    def __init__(self):
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        self.boot = int(fields[19]) / os.sysconf("SC_CLK_TCK")

    def elapsed(self) -> float:
        return time.clock_gettime(time.CLOCK_BOOTTIME) - self.boot

    def epoch(self) -> float:
        """The start as ``time.time()`` reads it."""
        return time.time() - self.elapsed()


def forbidden_modules() -> List[str]:
    """The top-level names of the loaded modules that are JAX's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _seed(*key: int) -> int:
    words = np.random.SeedSequence([k % 2 ** 64 for k in key]) \
        .generate_state(2, np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


def plan_seeds(traffic: dict, seed: int, k: int) -> List[int]:
    """The generator seeds of the window's plan k: problem ``order[k mod
    P]`` of the traffic's P ``problems``, ``order`` a permutation drawn
    from ``seed``; problem j's seed slot s seeds ``_seed(0, j, s)``."""
    P = traffic["problems"]
    order = np.random.default_rng(np.random.SeedSequence(
        [seed % 2 ** 64, 1])).permutation(P)
    j = int(order[k % P])
    return [_seed(0, j, s) for s in range(traffic["seeds_per_plan"])]


def warm_seeds(traffic: dict) -> List[int]:
    """The warm-up plan's seeds, none of a problem's."""
    return [_seed(1, s) for s in range(traffic["seeds_per_plan"])]


def drawn(seed: int, plans: int, T: int):
    """(the plan the reference checks, the later step it checks, in
    [2, T − 2])."""
    rng = np.random.default_rng(np.random.SeedSequence([seed % 2 ** 64, 2]))
    return int(rng.integers(plans)), int(rng.integers(2, T - 1))


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def counters() -> dict:
    """The program's counts of the rollout kernel's work."""
    from mbd_tpu_torch.ops import rollout_cuda as rc

    return dict(launches=rc.LAUNCHES, demo_launches=rc.DEMO_LAUNCHES,
                sample_steps=rc.SAMPLE_STEPS,
                demo_sample_steps=rc.DEMO_SAMPLE_STEPS)


def _delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def planner(cell: Cell, device, mesh=None, Ndiffuse: Optional[int] = None
            ) -> Callable[[List[int]], object]:
    """The system under test: ``run(seeds)`` makes one plan of the cell's
    entry from generators of those seeds, waits for the card, and returns
    a ``reference.check.Plan``."""
    from mbd_tpu_torch import envs
    from mbd_tpu_torch.planners import mbd

    from ..reference.check import Plan

    c = cell.config
    env = envs.get_env(c["env"], device=device)
    cfg = mbd.MBDConfig(
        Nsample=c["Nsample"], Hsample=c["Hsample"],
        Ndiffuse=Ndiffuse or c["Ndiffuse"], temp_sample=c["temp_sample"],
        beta0=c["beta0"], betaT=c["betaT"], enable_demo=c["enable_demo"])
    batch = cell.traffic["entry"] == "plan_batch"

    def run(seeds):
        gens = [torch.Generator(device).manual_seed(s) for s in seeds]
        with torch.profiler.record_function(tr.PLAN):
            if batch:
                res = mbd.plan_batch(env, cfg, gens, mesh=mesh)
                out = Plan(res.Ybars, res.final_reward, res.final_diverged)
            else:
                res = mbd.plan(env, cfg, gens[0], mesh=mesh)
                out = Plan(res.Ybars[None],
                           torch.as_tensor(res.final_reward).reshape(1),
                           torch.as_tensor(res.final_diverged).reshape(1))
            _sync(device)
        return out

    return run


def _window(cell: Cell, run, seed: int, seconds: float, trace: bool,
            agree=None, end=None):
    """The window, traced or not: (``window.Window``, the trace's summary
    or None)."""
    def plan(k):
        return run(plan_seeds(cell.traffic, seed, k))

    if not trace:
        return win.run(plan, seconds, agree=agree, end=end), None
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(tr.WINDOW):
            window = win.run(plan, seconds, agree=agree, end=end)
    return window, tr.reduce(prof)


def run_single(cell: Cell, seed: int, seconds: float, trace: bool, device,
               started: Started) -> dict:
    """The cell in this process on ``device``: what ``report.finish``
    takes (set-up, window, counts, memory, trace, the plans)."""
    run = planner(cell, device)
    warm = planner(cell, device,
                   Ndiffuse=cell.traffic["warmup_diffuse_steps"])
    warm(warm_seeds(cell.traffic))
    setup_s = started.elapsed()
    before = counters()
    window, summary = _window(cell, run, seed, seconds, trace)
    peak = torch.cuda.max_memory_allocated(device) \
        if torch.device(device).type == "cuda" else 0
    return dict(setup_s=setup_s, span_s=window.span_s, walls=window.walls,
                results=window.results, ranks=[dict(
                    summary=summary, counts=_delta(counters(), before),
                    memory_peak_bytes=peak, forbidden=forbidden_modules())])


def rank_main(mesh, cell: Cell, seed: int, seconds: float, trace: bool,
              prepare=None) -> dict:
    """One rank of a cell of K ranks: the rank's plans of the cell's
    entry over the mesh. Every rank takes rank 0's decision on whether to
    start another plan, and the window ends in a barrier; traced, each
    rank's profiler starts after a barrier. ``prepare()``, when given,
    runs first (the tests plant a fault with it)."""
    import torch.distributed as dist

    if prepare is not None:
        prepare()
    device = mesh.device
    run = planner(cell, device, mesh)
    warm = planner(cell, device, mesh,
                   Ndiffuse=cell.traffic["warmup_diffuse_steps"])
    warm(warm_seeds(cell.traffic))
    mesh.barrier()
    warm_end = time.time()

    def agree(go: bool) -> bool:
        flag = torch.tensor([float(go)], device=device)
        dist.broadcast(flag, src=0, group=mesh.group)
        return bool(flag.item())

    before = counters()
    mesh.barrier()
    _sync(device)
    window, summary = _window(cell, run, seed, seconds, trace, agree=agree,
                              end=mesh.barrier)
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    results = [type(r)(*(x.cpu() for x in r)) for r in window.results]
    return dict(rank=mesh.rank, warm_end=warm_end, span_s=window.span_s,
                walls=window.walls, results=results, summary=summary,
                counts=_delta(counters(), before), memory_peak_bytes=peak,
                forbidden=forbidden_modules())


def run_mesh(cell: Cell, seed: int, seconds: float, trace: bool,
             started: Started, backend: str = "nccl", device=None,
             prepare=None) -> dict:
    """The cell on ``cell.chips`` spawned ranks (NCCL, one card a rank;
    gloo on ``device`` for the CPU tests): what
    ``report.finish`` takes, with every rank's results."""
    from mbd_tpu_torch.parallel.mesh import start_ranks

    # the ranks need the cell's sizes, not its metrics' readers
    bare = dataclasses.replace(cell, end_to_end=[], per_layer=[])
    outs = start_ranks(rank_main, cell.chips, bare, seed,
                       seconds, trace, prepare, backend=backend,
                       device=device).wait()
    first = outs[0]
    return dict(setup_s=first["warm_end"] - started.epoch(),
                span_s=first["span_s"], walls=first["walls"],
                results=first["results"],
                rank_results=[o["results"] for o in outs],
                ranks=[dict(summary=o["summary"], counts=o["counts"],
                            memory_peak_bytes=o["memory_peak_bytes"],
                            forbidden=o["forbidden"]) for o in outs])
