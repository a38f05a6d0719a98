"""The sample mesh across several cards, one rank a card over NCCL: the
counterpart of the JAX package's ``dryrun_multichip`` hook
(``__graft_entry__.py``) and of its meshed tests.

    python -m mbd_tpu_torch.parallel.multichip [--cards K] [--case NAME ...]
        [--out FILE]

K (default: every card of the machine) must be at least 2 and at most the
card count; otherwise the module says why and exits with 2. The cases
(``CASES``; ``--case`` repeatable, default all), each at its model's
recommended config (``recommended_config``):

- ``dryrun``: one reverse step of humanoidrun at 8192 × 50 (JAX's hook at
  the flagship's width, which JAX could only lower);
- ``humanoidrun``: the flagship plan, 8192 / 50 / 300, temp 0.1;
- ``hopper_seeds8``: ``plan_batch`` over 8 seeds at hopper's config,
  16 384 samples a step;
- ``humanoidtrack_demo``: 2048 / 50 / 100 with the jog demo (the demo
  log-density gathered beside the rewards);
- ``hopper_mppi``: MPPI at hopper's recommended config;
- ``pushT_ppo``: PPO on pushT at its reference config for 2 iterations
  and one eval, every env step through the kernel's state-out mode.

Each case runs first in this process on ``cuda:0`` without a mesh (the
reference and the 1-card time), then on 2 and on K cards: ranks spawned
by ``start_ranks(..., backend="nccl", device=None)``, rank r on card r.
Before the cases every rank checks the exact gather (``exact_gather``:
one all_reduce of float32 rows holding NaN, ±inf, ±0.0 and subnormals, at
every shape the cases gather, bit for bit), that its first draws of
noise equal card 0's (Philox on each card) and that the kernel's layout
on its card is card 0's. Then per case and card count: the result (the
planners' Ybars or mu_0ts, rews_trace, final_reward and final_diverged
bit for bit on every rank; PPO's parameters equal on every rank and
within ``PPO_MESH_TOL`` of one process), every launch of the kernel on
the rank's own card at the rank's share of the samples (``SampleMesh``'s
split of one process's launch), the plan's wall (median of ``REPEAT``
runs, each started after a barrier and ended in a synchronise), the
kernel's ms a launch and each rank's busy share from a ``torch.profiler``
trace of one more run, the gathers (the ``mesh.gather`` spans of the
recorder, ``utils/profiling.py``, timed by their CUDA events: ms, bytes and
count a plan) and the host seconds
(wall less busy time, one CPU thread a rank). Each spawn logs NCCL at
``NCCL_DEBUG=INFO`` and prints the lines that name a transport. First of
all, before any build, the exact gather runs alone on K cards under
NCCL's own choice of algorithm, then with its ring and then its tree
algorithm forced, each collective's algorithm read from NCCL's log (an
algorithm NCCL refuses on the machine is reported, not failed: the port
never forces one).

Progress and the per-case lines go to stdout, the last line is one JSON
object (also written to ``--out``). Any difference, a failed NCCL
start, no card or a failed build is exit 1: nothing falls back to gloo,
to one process or to the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from .. import envs
from ..core.schedule import make_schedule
from ..envs.physics import PhysicsEnv
from ..ops import rollout_cuda as rc
from ..planners import mbd
from ..planners import path_integral as pi
from ..rl import ppo, train
from ..utils import profiling
from .mesh import SampleMesh, start_ranks

REPEAT = 3
# a sharded PPO against one process: JAX's meshed bound
# (tests/test_rl_mesh.py); the planners must agree bit for bit
PPO_MESH_TOL = 1e-4
PPO_TIMESTEPS = 2 * 2048 * 20          # 2 iterations of pushT's config
# every [rows, columns] the cases gather (the rewards' H columns, the
# flag and the demo log-density; PPO's q, qd, reward and flag): the
# shapes at which the exact gather is checked before the plans
GATHER_SHAPES = ((8192, 51), (299, 51), (16384, 51), (792, 51), (2048, 52),
                 (99, 51), (2048, 51), (2048, 18), (128, 18))
# the transports (and NVLink SHARP) NCCL names at its start, and its choice
# of algorithm for each collective (with NCCL_DEBUG_SUBSYS=TUNING)
TRANSPORT = re.compile(r" via |NVLS")
TUNING = re.compile(r"AllReduce: (\d+) Bytes -> Algo (\S+) proto (\S+)")
ALGOS = ("Tree", "Ring", "CollNetDirect", "CollNetChain", "NVLS", "NVLSTree",
         "PAT")
# the exact gather alone under NCCL's own choice (None), then each of
# these algorithms forced
NCCL_ALGOS = (None, "Ring", "Tree")


@dataclass(frozen=True)
class Case:
    """One case: the model, what runs (``kind``: "step", one reverse
    step; "plan", ``mbd.plan`` or, with ``seeds`` > 1, ``plan_batch``;
    "mppi", ``path_integral.plan``; "ppo", ``ppo.train``), its config and
    its seeds."""
    model: str
    kind: str
    cfg: Any
    seeds: int = 1

    def warm(self, size: int = 1):
        """The case cut short, to take a process's first launches and
        collectives out of the timed runs: one PPO iteration, or as few
        diffusion or refine steps as leave every one of ``size`` ranks a
        rollout of the final selection (``SampleMesh.split``), and at
        least 2."""
        cfg, steps = self.cfg, max(2, size) + 1
        if self.kind == "ppo":
            cfg = dataclasses.replace(
                cfg, num_timesteps=cfg.num_envs * cfg.unroll_length)
        elif self.kind == "mppi":
            cfg = dataclasses.replace(cfg, Nrefine=steps)
        elif self.kind == "plan":
            cfg = dataclasses.replace(cfg, Ndiffuse=steps)
        return dataclasses.replace(self, cfg=cfg)

    def samples(self) -> int:
        """The samples (or envs) of one sharded launch in one process."""
        return self.cfg.num_envs if self.kind == "ppo" \
            else self.seeds * self.cfg.Nsample

    def run(self, env, mesh: Optional[SampleMesh], state_init=None,
            eps: Optional[torch.Tensor] = None) -> dict:
        """The case on ``env`` (``mesh``: sharded; ``None``: one process),
        its result's tensors on the host by name. ``state_init`` and
        ``eps`` replace the reset state and the noise of a one-seed
        planner (eps [Ndiffuse − 1, Nsample, H, nu]; the step's
        [Nsample, H, nu])."""
        cfg, device = self.cfg, env.device
        if self.kind == "ppo":
            _, params, hist = ppo.train(env, cfg, mesh=mesh)
            state = {f"{net}.{k}": v.detach().cpu() for net in
                     ("policy", "value") for k, v in
                     getattr(params, net).state_dict().items()}
            state.update({f"obs_stats.{k}": torch.as_tensor(v).cpu()
                          for k, v in vars(params.obs_stats).items()})
            return dict(params=state,
                        eval=torch.tensor(hist[0]["eval/episode_reward"]))
        gens = [torch.Generator(device).manual_seed(s)
                for s in range(self.seeds)]
        if self.kind == "step":
            state = state_init if state_init is not None \
                else env.reset(gens[0])
            sched = make_schedule(cfg.Ndiffuse, cfg.beta0, cfg.betaT,
                                  device=device)
            step = mbd.make_reverse_once(env, cfg, state, sched, mesh)
            shape = (cfg.Nsample, cfg.Hsample, env.action_size)
            if eps is None:
                eps = mbd.draw_eps(gens, shape, device)[0]
            Ybar, rew = step(torch.zeros(shape[1:], device=device),
                             cfg.Ndiffuse - 1, eps)
            return dict(Ybar=Ybar.cpu(), rew=rew.cpu())
        if self.kind == "mppi":
            res = pi.plan(env, cfg, gens[0], state_init=state_init, eps=eps,
                          mesh=mesh)
        elif self.seeds == 1:
            res = mbd.plan(env, cfg, gens[0], state_init=state_init, eps=eps,
                           mesh=mesh)
        else:
            res = mbd.plan_batch(env, cfg, gens, mesh=mesh)
        return {k: torch.as_tensor(getattr(res, k)).cpu()
                for k in ("Ybars", "mu_0ts", "rews_trace", "final_reward",
                          "final_diverged") if hasattr(res, k)}


def cases() -> Dict[str, Case]:
    """The cases by name, at their models' recommended configs."""
    humanoidrun = mbd.recommended_config("humanoidrun")
    return {
        "dryrun": Case("humanoidrun", "step", humanoidrun),
        "humanoidrun": Case("humanoidrun", "plan", humanoidrun),
        "hopper_seeds8": Case("hopper", "plan",
                              mbd.recommended_config("hopper"), seeds=8),
        "humanoidtrack_demo": Case("humanoidtrack", "plan",
                                   mbd.recommended_config(
                                       "humanoidtrack",
                                       mbd.MBDConfig(enable_demo=True))),
        "hopper_mppi": Case("hopper", "mppi", pi.recommended_config(
            "hopper", pi.PathIntegralConfig(update_method="mppi"))),
        "pushT_ppo": Case("pushT", "ppo", ppo.PPOConfig(**dict(
            train.PPO_CONFIGS["pushT"], num_timesteps=PPO_TIMESTEPS,
            num_evals=1))),
    }


CASES = ("dryrun", "humanoidrun", "hopper_seeds8", "humanoidtrack_demo",
         "hopper_mppi", "pushT_ppo")


# ---------------------------------------------------------------------------
# what a rank records
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def launch_log():
    """Every launch of the rollout kernel in the block, as (the index of
    its card, its samples N)."""
    log = []
    run = rc.Built.run

    def logged(self, env, state0, Y0s, *args, **kwargs):
        log.append((Y0s.device.index, Y0s.shape[0]))
        return run(self, env, state0, Y0s, *args, **kwargs)

    rc.Built.run = logged
    try:
        yield log
    finally:
        rc.Built.run = run


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _counts() -> dict:
    return dict(launches=rc.LAUNCHES, demo_launches=rc.DEMO_LAUNCHES,
                state_launches=rc.STATE_LAUNCHES,
                sample_steps=rc.SAMPLE_STEPS)


def timed_run(case: Case, env, mesh: Optional[SampleMesh], log: list,
              **inputs) -> dict:
    """One run of the case with the counts set to 0 just before and read
    just after: its result, wall (from a barrier and a synchronise to a
    synchronise), counts, launches (card, N), collectives and the gathers
    (the run's ``mesh.gather`` spans, recorded for it; the recorder keeps
    no counter there, so the run does no counting work)."""
    device = env.device
    if mesh is not None:
        mesh.barrier()
        mesh.collectives.clear()
    _sync(device)
    rc.LAUNCHES = rc.DEMO_LAUNCHES = rc.STATE_LAUNCHES = 0
    rc.SAMPLE_STEPS = rc.DEMO_SAMPLE_STEPS = 0
    log.clear()
    profiling.clear()
    with profiling.recording():
        t0 = time.perf_counter()
        result = case.run(env, mesh, **inputs)
        _sync(device)
        wall = time.perf_counter() - t0
    out = dict(result=result, wall_s=wall, launch_cards=sorted(
        {c for c, _ in log if c is not None}),
        launch_samples=[n for _, n in log], **_counts())
    if mesh is not None:
        gathers = [s for s in profiling.recorded().spans
                   if s.name == "mesh.gather"]
        out.update(collectives=len(mesh.collectives),
                   gathers=len(gathers),
                   gather_bytes=sorted({s.attrs["bytes"] for s in gathers}),
                   gather_ms=sum(s.device_ms for s in gathers)
                   if device.type == "cuda" else None)
    return out


def same_bits(a, b) -> bool:
    """Two results (dicts of tensors, tensors or numbers) equal bit for
    bit: floats by their bits, so that −0.0 ≠ 0.0 and NaN = NaN of the
    same bits."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            same_bits(v, b[k]) for k, v in a.items())
    if not isinstance(a, torch.Tensor):
        return a == b
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype.is_floating_point:
        as_int = {2: torch.int16, 4: torch.int32, 8: torch.int64}[
            a.element_size()]
        return torch.equal(a.contiguous().view(as_int),
                           b.contiguous().view(as_int))
    return torch.equal(a, b)


def measure(case: Case, device, mesh: Optional[SampleMesh],
            repeat: int = REPEAT, **inputs) -> dict:
    """The case on ``device`` (``mesh``: this rank's; ``None``: one
    process): ``repeat`` timed runs, then on a card one more under
    ``torch.profiler`` for the kernel's ms a launch, the busy share and
    the cards its kernels ran on; on a card the short form of the case
    runs first, untimed. ``inputs``: ``Case.run``'s state_init and eps.
    The result is the first run's; ``repeat_equal`` says whether every
    run gave it bit for bit."""
    env = envs.get_env(case.model, device=device)
    on_card = device.type == "cuda"
    with launch_log() as log:
        if on_card:
            case.warm(1 if mesh is None else mesh.size).run(env, mesh)
        runs = [timed_run(case, env, mesh, log, **inputs)
                for _ in range(repeat)]
        first = runs[0]
        out = {k: v for k, v in first.items() if k != "result"}
        out.update(result=first["result"],
                   repeat_equal=all(same_bits(r["result"], first["result"])
                                    for r in runs[1:]),
                   wall_s=statistics.median(r["wall_s"] for r in runs),
                   wall_s_runs=[r["wall_s"] for r in runs],
                   threads=torch.get_num_threads(), kernel_ms=None,
                   busy_share=None, host_s=None, kernel_cards=None,
                   nccl_ms=None)
        if mesh is not None and on_card:
            out["gather_ms"] = statistics.mean(r["gather_ms"] for r in runs)
        if not on_card:
            return out
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            traced = timed_run(case, env, mesh, log, **inputs)
    events = profiling.device_events(prof)
    busy = profiling.busy_us((e.time_range.start, e.time_range.end)
                             for e in events) / 1e6
    totals = profiling.kernel_totals(events)
    n, us = profiling.named(totals, "rollout_kernel")
    out.update(busy_share=busy / traced["wall_s"],
               host_s=out["wall_s"] - busy,
               kernel_ms=us / 1e3 / n if n else None, kernel_traced=n,
               kernel_cards=sorted({e.device_index for e in events
                                    if "rollout_kernel" in e.name}),
               nccl_ms=profiling.named(totals, "nccl")[1] / 1e3)
    return out


# ---------------------------------------------------------------------------
# the checks before the plans
# ---------------------------------------------------------------------------

def special_rows(shape: Tuple[int, int], seed: int = 0) -> torch.Tensor:
    """Random float32 rows [rows, cols] across the exponent range, with
    NaN (quiet, with a payload and negative), ±inf, ±0.0, ±subnormals and
    ±the largest finite value planted among them, on the CPU."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=gen) * torch.exp2(
        torch.randint(-60, 60, shape, generator=gen).float())
    bits = [0x7FC00000, 0x7FC00123, 0xFFC00000, 0x7F800000, 0xFF800000,
            0x00000000, 0x80000000, 0x00000001, 0x807FFFFF, 0x7F7FFFFF,
            0xFF7FFFFF]
    specials = torch.tensor([b - (1 << 32) if b >= 1 << 31 else b
                             for b in bits], dtype=torch.int32)
    flat = x.view(-1).view(torch.int32)
    k = max(len(bits), flat.numel() // 16)
    at = torch.randperm(flat.numel(), generator=gen)[:k]
    flat[at] = specials[torch.arange(k) % len(bits)]
    return x


def exact_gather(mesh: SampleMesh, shapes=GATHER_SHAPES) -> List[dict]:
    """``SampleMesh.gather`` of ``special_rows`` at each shape, each rank
    giving its ``split`` of the rows, against the rows themselves: NaN
    where they hold NaN, every other element equal (``torch.equal``), in
    its sign bit and in all its bits. ``nan_bits_kept``: whether the NaNs
    kept their payload and sign too (reported, not required). On a card,
    ``ms`` is one all_reduce's time after a barrier (10 in a row)."""
    out = []
    for shape in shapes:
        x = special_rows(shape)
        lo, hi = mesh.split(shape[0])
        full = mesh.gather(x[lo:hi].to(mesh.device), shape[0], lo).cpu()
        nan = torch.isnan(x)
        keep = ~nan
        xi, fi = x.view(torch.int32), full.view(torch.int32)
        check = dict(
            shape=list(shape), nan=torch.equal(nan, torch.isnan(full)),
            equal=torch.equal(x[keep], full[keep]),
            sign_bits=torch.equal(torch.signbit(x[keep]),
                                  torch.signbit(full[keep])),
            bits=torch.equal(xi[keep], fi[keep]),
            nan_bits_kept=torch.equal(xi[nan], fi[nan]), ms=None)
        check["ok"] = all(check[k] for k in ("nan", "equal", "sign_bits",
                                             "bits"))
        if mesh.device.type == "cuda":
            local = x[lo:hi].to(mesh.device)
            mesh.barrier()
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in "se")
            start.record()
            for _ in range(10):
                mesh.gather(local, shape[0], lo)
            end.record()
            end.synchronize()
            check["ms"] = start.elapsed_time(end) / 10
        out.append(check)
    return out


def first_draws(names: Sequence[str], device) -> Dict[str, str]:
    """For each planner case, a digest of its generators' first draws on
    ``device``: each seed's reset and the first step's noise, as the plan
    draws them (Philox must give every card the same numbers)."""
    table = cases()
    out = {}
    for name in names:
        case = table[name]
        if case.kind == "ppo":
            continue
        env = envs.get_env(case.model, device=device)
        gens = [torch.Generator(device).manual_seed(s)
                for s in range(case.seeds)]
        states = [env.reset(g) for g in gens]
        eps = mbd.draw_eps(gens, (case.cfg.Nsample, case.cfg.Hsample,
                                  env.action_size), device)
        digest = hashlib.sha256()
        for t in [x for s in states for x in (s.pipeline_state.q,
                                               s.pipeline_state.qd)] + [eps]:
            digest.update(t.cpu().numpy().tobytes())
        out[name] = digest.hexdigest()
    return out


def layouts(names: Sequence[str], size: int) -> Dict[str, dict]:
    """The kernel's layout (``Built.attrs``) on the current card for each
    case's model at the case's samples a rank on ``size`` cards."""
    table = cases()
    out = {}
    for name in names:
        case = table[name]
        env = envs.get_env(case.model, device="cuda")
        if isinstance(env, PhysicsEnv):
            out[name] = rc.library(env).attrs(case.samples() // size)
    return out


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def rank_main(mesh: SampleMesh, names: Sequence[str], repeat: int) -> dict:
    """What each rank runs: the exact gather (raising at once if it is
    not), its first draws and layouts, then every case measured."""
    exact = exact_gather(mesh)
    bad = [c for c in exact if not c["ok"]]
    if bad:
        raise RuntimeError(f"rank {mesh.rank}: the gather over "
                           f"{mesh.size} ranks is not exact: {bad}")
    out = dict(rank=mesh.rank, device=str(mesh.device), exact=exact,
               draws=first_draws(names, mesh.device),
               layouts=layouts(names, mesh.size), cases={})
    table = cases()
    for name in names:
        m = measure(table[name], mesh.device, mesh, repeat)
        if table[name].kind == "step":
            m["shard"] = list(mesh.shard(table[name].samples()))
        out["cases"][name] = m
    out["nvcc_s"] = build_all(names)          # 0: loaded, not built here
    return out


@contextlib.contextmanager
def nccl_log(**variables):
    """The ranks spawned in the block log NCCL at INFO, each into a file
    of a temporary directory, with ``variables`` (NCCL_ALGO, ...) set;
    yields a list that holds, after the block, every line of those
    files."""
    workdir = tempfile.mkdtemp(prefix="mbd_nccl_")
    variables = dict(NCCL_DEBUG="INFO", NCCL_DEBUG_FILE=os.path.join(
        workdir, "nccl.%h.%p.log"), **variables)
    saved = {k: os.environ.get(k) for k in variables}
    os.environ.update(variables)
    lines: List[str] = []
    try:
        yield lines
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        for name in sorted(os.listdir(workdir)):
            with open(os.path.join(workdir, name), errors="replace") as f:
                lines.extend(line.rstrip("\n") for line in f)
        shutil.rmtree(workdir, ignore_errors=True)


def _info(line: str) -> str:
    """An NCCL log line without its host, pid and thread prefix."""
    return line.split("NCCL INFO ", 1)[-1]


def transports(lines: Sequence[str]) -> dict:
    """The transport lines of an NCCL log: each distinct one (without the
    prefix) and how often it came, and the count by kind."""
    kept: Dict[str, int] = {}
    for line in lines:
        if "NCCL INFO" in line and TRANSPORT.search(line):
            text = _info(line)
            kept[text] = kept.get(text, 0) + 1
    kinds: Dict[str, int] = {}
    for text, n in kept.items():
        m = re.search(r" via (\S+)", text)
        kind = m.group(1) if m else "NVLS"
        kinds[kind] = kinds.get(kind, 0) + n
    return dict(kinds=kinds, lines=sorted(kept))


def algorithms(lines: Sequence[str]) -> Dict[str, List[str]]:
    """NCCL's choice for each all_reduce it logged (TUNING): by message
    bytes, the distinct "algorithm/protocol" pairs."""
    chosen: Dict[str, set] = {}
    for line in lines:
        m = TUNING.search(line)
        if m:
            algo = m.group(2)
            if algo.isdigit() and int(algo) < len(ALGOS):
                algo = ALGOS[int(algo)]
            chosen.setdefault(m.group(1), set()).add(f"{algo}/{m.group(3)}")
    return {k: sorted(v) for k, v in sorted(chosen.items(),
                                            key=lambda kv: int(kv[0]))}


# ---------------------------------------------------------------------------
# the parent: one card, then 2 and K
# ---------------------------------------------------------------------------

def cards() -> List[str]:
    """Every card's index, name and power limit as ``nvidia-smi
    --query-gpu=index,name,power.limit --format=csv,noheader`` prints
    them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=index,name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()


def expected_samples(single: List[int], rank: int, size: int) -> List[int]:
    """A rank's launches, as the split over ``size`` ranks of each launch
    of one process (``SampleMesh.split``; ``shard`` is the same split
    when the samples divide)."""
    mesh = SampleMesh(group=None, rank=rank, size=size,
                      device=torch.device("cpu"))
    return [hi - lo for lo, hi in (mesh.split(n) for n in single)]


def _ratio(a, b):
    return None if a is None or not b else a / b


def judge(case: Case, ref: dict, per_rank: List[dict]) -> dict:
    """One case on one mesh against one process: the checks and the line's
    numbers."""
    size = len(per_rank)
    checks = {}
    if case.kind == "ppo":
        p0 = per_rank[0]["result"]["params"]
        ref_p = ref["result"]["params"]
        checks["ranks_equal"] = all(same_bits(o["result"], per_rank[0]
                                              ["result"]) for o in per_rank)
        checks["within_tol"] = all(torch.allclose(
            p0[k], v, rtol=PPO_MESH_TOL, atol=PPO_MESH_TOL)
            for k, v in ref_p.items())
        max_err = max(float((p0[k] - v).abs().max()) for k, v in
                      ref_p.items())
        exact = same_bits(per_rank[0]["result"], ref["result"])
    else:
        checks["bit_for_bit"] = exact = all(
            same_bits(o["result"], ref["result"]) for o in per_rank)
        max_err = None
    checks["repeat_equal"] = all(o["repeat_equal"] for o in per_rank)
    checks["own_card"] = all(
        o["launch_cards"] in ([], [r]) and o["kernel_cards"] in (None, [],
                                                                 [r])
        for r, o in enumerate(per_rank))
    checks["own_shard"] = all(
        o["launch_samples"] == expected_samples(ref["launch_samples"], r,
                                                size)
        for r, o in enumerate(per_rank))
    checks["launches"] = all(o["launches"] == ref["launches"]
                             for o in per_rank)
    checks["sample_steps"] = sum(o["sample_steps"] for o in per_rank) \
        == ref["sample_steps"]
    walls = [o["wall_s"] for o in per_rank]
    return dict(
        cards=size, ok=all(checks.values()), checks=checks, exact=exact,
        max_abs_err=max_err, wall_s=max(walls), wall_s_ranks=walls,
        speedup=ref["wall_s"] / max(walls),
        kernel_ms=[o["kernel_ms"] for o in per_rank],
        samples_per_launch=[sorted(set(o["launch_samples"]))
                            for o in per_rank],
        launches=[o["launches"] for o in per_rank],
        gathers=per_rank[0]["gathers"],
        gather_bytes=per_rank[0]["gather_bytes"],
        gather_ms_plan=[o["gather_ms"] for o in per_rank],
        gather_ms_each=[_ratio(o["gather_ms"], o["gathers"])
                        for o in per_rank],
        gather_share=[_ratio(o["gather_ms"], 1e3 * o["wall_s"])
                      for o in per_rank],
        collectives=per_rank[0]["collectives"],
        busy_share=[o["busy_share"] for o in per_rank],
        host_s=[o["host_s"] for o in per_rank],
        nccl_ms=[o["nccl_ms"] for o in per_rank],
        threads=per_rank[0]["threads"],
        shards=[o.get("shard") for o in per_rank], of=case.samples())


def _fmt(xs, digits=3) -> str:
    return "[" + ", ".join("—" if x is None else f"{x:.{digits}f}"
                           for x in xs) + "]"


def print_case(name: str, ref: dict, row: dict) -> None:
    size = row["cards"]
    what = "bit for bit" if row["exact"] else (
        f"max |Δ| {row['max_abs_err']:.3g} against one process")
    print(f"multichip {name} on {size} cards: ok {row['ok']} ({what}; "
          f"{row['checks']}); wall {row['wall_s']:.4f} s (ranks "
          f"{_fmt(row['wall_s_ranks'], 4)}) against {ref['wall_s']:.4f} s "
          f"on one card: ×{row['speedup']:.3f}; kernel ms a launch "
          f"{_fmt(row['kernel_ms'])} (one card "
          f"{_fmt([ref['kernel_ms']])}); launches {row['launches']} of "
          f"{row['samples_per_launch']} samples (one card {ref['launches']}"
          f" of {sorted(set(ref['launch_samples']))}); {row['gathers']} "
          f"gathers of {row['gather_bytes']} B, ms each "
          f"{_fmt(row['gather_ms_each'], 4)}, share of the wall "
          f"{_fmt(row['gather_share'], 5)}; {row['collectives']} "
          f"collectives; busy share {_fmt(row['busy_share'], 4)} (one card "
          f"{_fmt([ref['busy_share']], 4)}); host s {_fmt(row['host_s'])} "
          f"at {row['threads']} thread(s) a rank (one card "
          f"{_fmt([ref['host_s']])} at {ref['threads']})", flush=True)
    if row["shards"][0] is not None:
        for r, shard in enumerate(row["shards"]):
            print(f"  rank {r}: shard {shard} of {row['of']} samples, "
                  f"launches {row['launches'][r]} of "
                  f"{row['samples_per_launch'][r]}, {row['collectives']} "
                  f"collectives", flush=True)


def build_all(names: Sequence[str]) -> Dict[str, float]:
    """Each case model's kernel, built at once (one nvcc each), before
    any rank starts: nvcc seconds by model (0 when cached)."""
    table = cases()
    models = sorted({table[n].model for n in names})
    with ThreadPoolExecutor(max_workers=len(models)) as pool:
        built = {m: pool.submit(rc.library, envs.get_env(m, device="cuda"))
                 for m in models}
        return {m: f.result().seconds for m, f in built.items()}


def spawn(fn, size: int, *args, **variables) -> Tuple[list, List[str]]:
    """``fn`` on ``size`` NCCL ranks, one a card, with the NCCL
    ``variables`` (NCCL_ALGO, ...) set: each rank's return value and the
    lines of NCCL's INFO log."""
    with nccl_log(**variables) as lines:
        outs = start_ranks(fn, size, *args, backend="nccl",
                           device=None).wait()
    return outs, lines


def run(size: int, names: Sequence[str] = CASES, repeat: int = REPEAT,
        nccl_algos: Sequence[Optional[str]] = NCCL_ALGOS) -> dict:
    """The module's protocol on ``size`` cards for the cases ``names``:
    a report whose ``ok`` says whether every check held (see the module's
    docstring). Raises when a rank fails."""
    table = cases()
    listed = cards()
    for line in listed:
        print(f"card {line}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, NCCL "
          f"{'.'.join(map(str, torch.cuda.nccl.version()))}", flush=True)
    # the collective alone first: NCCL's choice, then ring and tree
    forced, ok = {}, True
    for algo in nccl_algos:
        variables = dict(NCCL_DEBUG_SUBSYS="INIT,TUNING")
        if algo is not None:
            variables["NCCL_ALGO"] = algo
        algo = algo or "default"
        try:
            outs, lines = spawn(exact_gather, size, **variables)
        except (torch.multiprocessing.ProcessRaisedException,
                torch.multiprocessing.ProcessExitedException) as e:
            # NCCL may offer no such algorithm on this machine: reported,
            # since the port never forces one
            forced[algo] = dict(exact=None, refused=str(e)[-2000:])
            print(f"multichip NCCL_ALGO={algo} on {size} cards: refused "
                  f"({str(e)[-300:]})", flush=True)
            continue
        exact = all(c["ok"] for o in outs for c in o)
        chosen = algorithms(lines)
        forced[algo] = dict(exact=exact, chosen=chosen, checks=outs[0])
        print(f"multichip exact gather with NCCL_ALGO={algo} on {size} "
              f"cards: {exact} (all_reduce ms "
              f"{_fmt([c['ms'] for c in outs[0]], 4)}); NCCL chose "
              f"{chosen}", flush=True)
        ok &= exact
    built = build_all(names)
    print(f"builds (nvcc s by model): {built}", flush=True)
    device = torch.device("cuda:0")
    draws = first_draws(names, device)
    single = {}
    for name in names:
        single[name] = measure(table[name], device, None, repeat)
        ref = single[name]
        print(f"multichip {name} on one card: wall {ref['wall_s']:.4f} s "
              f"(runs {_fmt(ref['wall_s_runs'], 4)}), {ref['launches']} "
              f"launches of {sorted(set(ref['launch_samples']))}, kernel "
              f"{_fmt([ref['kernel_ms']])} ms a launch, busy share "
              f"{_fmt([ref['busy_share']], 4)}", flush=True)
    report = dict(cards=listed, nccl=torch.cuda.nccl.version(), builds=built,
                  cases={n: {"1": {k: v for k, v in s.items()
                                   if k not in ("result", "launch_samples")}}
                         for n, s in single.items()},
                  exact={}, draws_equal={}, layouts_equal={},
                  transports={}, algorithms=forced)
    for k in sorted({2, size}):
        outs, lines = spawn(rank_main, k, list(names), repeat)
        report["exact"][str(k)] = outs[0]["exact"]
        report["draws_equal"][str(k)] = all(o["draws"] == draws
                                            for o in outs)
        with torch.cuda.device(device):
            ref_layout = layouts(names, k)
        report["layouts_equal"][str(k)] = all(o["layouts"] == ref_layout
                                              for o in outs)
        print(f"multichip on {k} cards: exact gather "
              f"{all(c['ok'] for o in outs for c in o['exact'])} at "
              f"{len(outs[0]['exact'])} shapes (all_reduce ms "
              f"{_fmt([c['ms'] for c in outs[0]['exact']], 4)} at "
              f"{[c['shape'] for c in outs[0]['exact']]}; NaN bits kept "
              f"{[c['nan_bits_kept'] for c in outs[0]['exact']]}); first "
              f"draws equal card 0's {report['draws_equal'][str(k)]}; "
              f"layouts equal card 0's {report['layouts_equal'][str(k)]}; "
              f"nvcc s on the ranks {[o['nvcc_s'] for o in outs]}",
              flush=True)
        ok &= report["draws_equal"][str(k)] and \
            report["layouts_equal"][str(k)]
        t = report["transports"][str(k)] = transports(lines)
        print(f"multichip NCCL transports on {k} cards: {t['kinds']}",
              flush=True)
        for line in [x for x in t["lines"]
                     if not x.startswith("Channel")][:16]:
            print(f"  {line}", flush=True)
        for name in names:
            row = judge(table[name], single[name],
                        [o["cases"][name] for o in outs])
            print_case(name, single[name], row)
            report["cases"][name][str(k)] = row
            ok &= row["ok"]
    report["ok"] = bool(ok)
    return report


def parse(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m mbd_tpu_torch.parallel.multichip",
        description="The sample mesh across K cards over NCCL against one "
                    "card.")
    ap.add_argument("--cards", type=int,
                    help="cards to shard over (default: every card)")
    ap.add_argument("--case", action="append", choices=CASES,
                    help="a case to run (repeatable; default: all)")
    ap.add_argument("--out", help="also write the report's JSON here")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    if not torch.cuda.is_available():
        print("multichip: no CUDA card; the mesh across cards needs at "
              "least 2", file=sys.stderr)
        return 2
    count = torch.cuda.device_count()
    size = count if args.cards is None else args.cards
    if count < 2:
        print(f"multichip: the machine has {count} card; the mesh across "
              f"cards needs at least 2", file=sys.stderr)
        return 2
    if not 2 <= size <= count:
        print(f"multichip: --cards {size} must lie in [2, {count}], the "
              f"machine's {count} cards", file=sys.stderr)
        return 2
    report = run(size, args.case or CASES)
    line = json.dumps(report)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    if not report["ok"]:
        print("multichip: a check failed (see the lines above)",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
