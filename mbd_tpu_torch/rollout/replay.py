"""Replay of the reference's committed 8-seed plans through the port.

``results/<dir>/seed_harness.npz`` holds the JAX package's final plans of
its 8-seed harness (``plans`` [8, H, nu]) and their rewards (``rewards``
[8], the plans' mean per-step reward, and ``diverged`` [8]). Seed s
planned from the reset that ``env.reset(split(PRNGKey(s))[1])`` draws in
JAX; those resets are stored in ``assets/seed_resets.npz``, so the port
replays each plan from its own initial state without JAX
(``PYTHONPATH=. python tests/test_torch_replay.py`` rewrites the file).
"""

from __future__ import annotations

import os
from types import SimpleNamespace

import numpy as np
import torch

from ..ops.rollout_cuda import rollout_rewards_cuda

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
RESETS = os.path.join(ROOT, "mbd_tpu_torch", "assets", "seed_resets.npz")
# each harness directory under results/ and the env that planned it
HARNESS = {
    "hopper": "hopper", "walker2d": "walker2d",
    "halfcheetah": "halfcheetah", "cartpole": "cartpole", "ant": "ant",
    "pushT": "pushT", "humanoidrun": "humanoidrun",
    "humanoidstandup": "humanoidstandup", "humanoidtrack": "humanoidtrack",
    "humanoidtrack_demo": "humanoidtrack",
    "humanoidtrack_walk": "humanoidtrack_walk",
    "humanoidtrack_walk_demo": "humanoidtrack_walk"}


# |replay − committed reward| allowed per env. The committed plans were
# planned and scored by JAX on a TPU. For the six cheap envs: JAX's own
# engine replays them on a CPU this far from the committed rewards (the
# platform alone: the largest gap over the 8 seeds, replayed in a batch of
# 8 and in one of 72 with 8 one-ulp perturbations of the resets, rounded
# up; ``python tests/test_torch_replay.py --measure``). No humanoid engine
# compiles on JAX's CPU backend in reasonable time, so for the humanoids:
# the kernel's own spread on the card, the largest |perturbed −
# unperturbed| of the 8 plans replayed from 32 one-ulp perturbations of
# their resets (``spread``), over the env's harness directories, rounded
# up; ``chip_smoke.py`` prints it and fails if it passes the value here.
REPLAY_ATOL = {"hopper": 0.015, "walker2d": 0.30, "halfcheetah": 0.025,
               "cartpole": 2.4e-7, "pushT": 6.7e-6, "ant": 0.15,
               "humanoidrun": 0.54, "humanoidstandup": 0.12,
               "humanoidtrack": 0.037, "humanoidtrack_walk": 0.11}
# the envs whose tolerance is the kernel's spread on the card
SPREAD_SET = ("humanoidrun", "humanoidstandup", "humanoidtrack",
              "humanoidtrack_walk")
# Seeds whose replay misses (``misses``), logged in ROADMAP.md Queue 3
# with their gaps: (harness directory, seed) → the device types ("cpu":
# the plain engine on the CPU, "cuda": the kernel) on which it misses.
FAULTS = {("hopper", 0): ("cpu",), ("humanoidrun", 1): ("cuda",),
          ("humanoidrun", 7): ("cuda",)}


def misses(directory: str, rews, bad, ref) -> set:
    """The seeds whose replay is beyond ``tolerance(directory)`` of the
    committed reward, or whose validity flag differs from the committed
    one."""
    tol = tolerance(directory)
    return {s for s in range(len(rews))
            if not abs(rews[s] - ref["rewards"][s]) <= tol
            or bad[s] != ref["diverged"][s]}


def faults(directory: str, device) -> set:
    """The seeds of ``directory`` logged as missing on ``device``."""
    kind = torch.device(device).type
    return {s for (d, s), kinds in FAULTS.items()
            if d == directory and kind in kinds}


def tolerance(directory: str) -> float:
    """The replay's tolerance on ``results/<directory>``'s rewards."""
    return REPLAY_ATOL[HARNESS[directory]]


def harness(directory: str) -> dict:
    """The committed harness file of ``results/<directory>``."""
    path = os.path.join(ROOT, "results", directory, "seed_harness.npz")
    with np.load(path) as d:
        return {k: d[k] for k in ("plans", "rewards", "diverged")}


def perturbed(q: np.ndarray, copies: int) -> np.ndarray:
    """The resets q [8, nq], then ``copies`` copies of them with every
    entry moved by one ulp up or down (seeded): [(1 + copies)·8, nq]."""
    rng = np.random.default_rng(0)
    # the direction in float32 too: against a float64 one, nextafter steps
    # by a float64 ulp, which rounds back to q
    return np.concatenate([q] + [
        np.nextafter(q, (rng.choice([-1, 1], q.shape) * np.inf
                         ).astype(q.dtype)) for _ in range(copies)])


def seed_states(env, env_name: str, copies: int = 0) -> SimpleNamespace:
    """The reference's reset states of seeds 0–7 of ``env_name``, as
    per-sample initial states q [nq, 8] / qd [nv, 8] on ``env.device``;
    with ``copies``, followed by that many one-ulp perturbations of q
    (``perturbed``): [nq, (1 + copies)·8]."""
    with np.load(RESETS) as d:
        q, qd = d[f"{env_name}/q"], d[f"{env_name}/qd"]

    def rows(a):
        return torch.from_numpy(a.T.copy()).to(env.device)

    return SimpleNamespace(pipeline_state=SimpleNamespace(
        q=rows(perturbed(q, copies)), qd=rows(np.tile(qd, (1 + copies, 1)))))


def replay(env, directory: str, copies: int = 0):
    """Roll the 8 committed plans of ``results/<directory>`` out through
    ``rollout_rewards_cuda`` in one batch (the kernel on the card, the
    plain engine on the CPU), each from its seed's reset (and, with
    ``copies``, from that many one-ulp perturbations of the resets after
    them): (mean rewards, flags) on the host, [8] or [1 + copies, 8], and
    the harness file's arrays."""
    ref = harness(directory)
    plans = torch.from_numpy(np.tile(ref["plans"], (1 + copies, 1, 1))
                             ).to(env.device)
    rews, bad = rollout_rewards_cuda(
        env, seed_states(env, HARNESS[directory], copies), plans)
    rews = rews.mean(dim=-1).cpu().numpy()
    bad = bad.cpu().numpy() > 0
    if copies:
        rews, bad = rews.reshape(1 + copies, 8), bad.reshape(1 + copies, 8)
    return (rews, bad), ref


def spread(env, directory: str, copies: int = 32):
    """How far one ulp of the resets moves the replay: the committed plans
    from their resets and from ``copies`` one-ulp perturbations, in one
    batch; (the largest |perturbed − unperturbed| mean reward over the
    pairs clean in both, the pairs whose flag differs)."""
    (rews, bad), _ = replay(env, directory, copies)
    clean = ~bad[1:] & ~bad[0]
    gaps = np.abs(rews[1:] - rews[0])[clean]
    return float(gaps.max(initial=0.0)), int((bad[1:] != bad[0]).sum())
