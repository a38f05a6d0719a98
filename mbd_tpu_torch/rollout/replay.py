"""Replay of the reference's committed 8-seed plans through the port.

``results/<dir>/seed_harness.npz`` holds the JAX package's final plans of
its 8-seed harness (``plans`` [8, H, nu]) and their rewards (``rewards``
[8], the plans' mean per-step reward, and ``diverged`` [8]). Seed s
planned from the reset that ``env.reset(split(PRNGKey(s))[1])`` draws in
JAX; those resets are stored in ``assets/seed_resets.npz``, so the port
replays each plan from its own initial state without JAX
(``PYTHONPATH=. python tests/test_torch_replay.py`` rewrites the file).
car2d starts every seed from its fixed x0 and needs no reset.
"""

from __future__ import annotations

import os
from types import SimpleNamespace

import numpy as np
import torch

from ..envs.physics import PhysicsEnv
from ..ops.rollout_cuda import rollout_rewards_cuda
from ..sim import batched as BT
from .rollout import rollout_us

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
    "humanoidtrack_walk_demo": "humanoidtrack_walk", "car2d": "car2d"}


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
# car2d: JAX on a CPU replays the TPU's rewards exactly (every committed
# plan stays at least 0.81 from the goal, outside the reward's 0.2), so 0.
REPLAY_ATOL = {"car2d": 0.0, "hopper": 0.015, "walker2d": 0.30,
               "halfcheetah": 0.025, "cartpole": 2.4e-7, "pushT": 6.7e-6,
               "ant": 0.15, "humanoidrun": 0.54, "humanoidstandup": 0.12,
               "humanoidtrack": 0.037, "humanoidtrack_walk": 0.11}
# the envs whose tolerance is the kernel's spread on the card
SPREAD_SET = ("humanoidrun", "humanoidstandup", "humanoidtrack",
              "humanoidtrack_walk")
# Seeds whose replay misses (``misses``), logged in ROADMAP.md Queue 3
# with their gaps: (harness directory, seed) → the device types ("cpu":
# the plain engine on the CPU, "cuda": the kernel) on which it misses.
FAULTS = {("hopper", 0): ("cpu",)}
# Plans on the validity envelope's edge: the replay flags them where the
# reference's run kept them clean, and the reference's own engine flags
# the same state. (harness directory, seed) → {device type: the margin
# by which the first flagged substep trips its check}, measured by
# ``first_flag`` (``python -m mbd_tpu_torch.rollout.replay``). From the
# card's state before that substep (``EDGE_STATES``), one eager substep of
# the JAX engine trips the same check, |qd| > 100, by 6.32 (seed 1) and
# 5.68 (seed 7) (``tests/test_torch_replay.py``). Their flags are accepted
# when the reward is within the tolerance; every other miss is not.
EDGE = {("humanoidrun", 1): {"cpu": 1.791351, "cuda": 6.170166},
        ("humanoidrun", 7): {"cuda": 5.681023}}
EDGE_STATES = os.path.join(ROOT, "mbd_tpu_torch", "assets",
                           "humanoidrun_edge.npz")


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


def edge(directory: str, device, rews, bad, ref) -> dict:
    """The seeds of ``directory`` on the envelope's edge on ``device``
    (``EDGE``) whose replay is flagged where the committed plan is clean,
    with the reward within the tolerance: seed → its recorded margin."""
    kind = torch.device(device).type
    tol = tolerance(directory)
    return {s: margins[kind] for (d, s), margins in EDGE.items()
            if d == directory and kind in margins and bad[s]
            and not ref["diverged"][s]
            and abs(rews[s] - ref["rewards"][s]) <= tol}


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
    plain engine on the CPU; car2d, an analytic env, through its own step
    from its fixed start), each from its seed's reset (and, with
    ``copies``, from that many one-ulp perturbations of the resets after
    them): (mean rewards, flags) on the host, [8] or [1 + copies, 8], and
    the harness file's arrays."""
    ref = harness(directory)
    plans = torch.from_numpy(np.tile(ref["plans"], (1 + copies, 1, 1))
                             ).to(env.device)
    if not isinstance(env, PhysicsEnv):
        rews, _ = rollout_us(env, env.reset(None), plans)
        bad = torch.zeros_like(rews[:, 0])
    else:
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


def first_flag(env, directory: str, seed: int):
    """Where the validity envelope first flags seed ``seed``'s committed
    plan of ``results/<directory>``: the plan rolled out from its reset
    one substep at a time through the plain engine (a batch of 1, on
    ``env.device``; on the card the kernel gives the same bits), each
    check read after every substep as ``env_step_checked_b`` reads it.
    Returns None when the rollout stays clean, else a dict: the env step
    and substep, the check that tripped (``"qd"``: a joint speed above
    ``QD_DIVERGED``; ``"root"``: a root more than ``ROOT_SINK_TOL`` below
    the floor), each check's margin there (positive = tripped: max |qd| −
    the limit, and the limit's height − the lowest root), the dof of the
    largest speed, and the state before that substep (q, qd, the control
    u) on the host."""
    sys = env.sys
    ref = harness(directory)
    state = seed_states(env, HARNESS[directory]).pipeline_state
    q = state.q[:, seed:seed + 1]
    qd = state.qd[:, seed:seed + 1]
    U = torch.from_numpy(ref["plans"][seed]).to(env.device)
    hs = BT.height_sensors(sys)
    for t in range(U.shape[0]):
        u = U[t][:, None]
        for f in range(env.n_frames):
            q_pre, qd_pre = q, qd
            q, qd = BT.substep_b(sys, q, qd, u)
            speed = qd.abs().amax(dim=0)[0]
            qd_margin = float(speed) - BT.QD_DIVERGED
            root_margin = -float("inf")
            if hs is not None:
                sensors, floor_z = hs
                zmin = BT.f32(floor_z - BT.ROOT_SINK_TOL)
                root_margin = max(zmin - float(q[qadr, 0] + BT.f32(off))
                                  for qadr, off in sensors)
            if qd_margin > 0 or root_margin > 0:
                return dict(step=t, substep=f,
                            check="qd" if qd_margin > 0 else "root",
                            qd_margin=qd_margin, root_margin=root_margin,
                            dof=int(qd.abs()[:, 0].argmax()),
                            q=q_pre[:, 0].cpu().numpy(),
                            qd=qd_pre[:, 0].cpu().numpy(),
                            u=u[:, 0].cpu().numpy())
            qd = torch.clamp(qd, -BT.QD_DIVERGED, BT.QD_DIVERGED)
    return None


def main(argv=None) -> int:
    """``python -m mbd_tpu_torch.rollout.replay --first_flag humanoidrun:1,7
    [--device cuda] [--out FILE]``: ``first_flag`` of each seed, printed;
    on the card the kernel's trace of the same plan (``need_qs``) is held
    against the plain engine's bit for bit first. ``--out`` writes the
    states before each first flagged substep as ``<seed>/q``, ``/qd``,
    ``/u``, ``/step``, ``/substep`` (the fixture of the envelope-edge
    seeds, ``EDGE_STATES``)."""
    import argparse

    from .. import envs
    from .fused import rollout_outputs

    p = argparse.ArgumentParser()
    p.add_argument("--first_flag", required=True,
                   help="<harness directory>:<seed>[,<seed>...]")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    directory, seeds = args.first_flag.split(":")
    env = envs.get_env(HARNESS[directory], device=args.device)
    arrays = {}
    for seed in map(int, seeds.split(",")):
        if env.device.type == "cuda":
            ref = harness(directory)
            state = seed_states(env, HARNESS[directory]).pipeline_state
            one = SimpleNamespace(pipeline_state=SimpleNamespace(
                q=state.q[:, seed:seed + 1].contiguous(),
                qd=state.qd[:, seed:seed + 1].contiguous()))
            plan = torch.from_numpy(ref["plans"][seed:seed + 1]).to(
                env.device)
            kernel = rollout_rewards_cuda(env, one, plan, need_qs=True)
            plain = rollout_outputs(env, one, plan, need_qs=True)
            same = all(bool(torch.equal(a, b))
                       for a, b in zip(kernel, plain))
            print(f"{directory} seed {seed}: kernel flag "
                  f"{int(kernel[1][0])}, kernel and plain engine equal bit "
                  f"for bit: {same}", flush=True)
            if not same:
                raise AssertionError("the kernel and the plain engine "
                                     "differ")
        hit = first_flag(env, directory, seed)
        if hit is None:
            print(f"{directory} seed {seed}: clean", flush=True)
            continue
        print(f"{directory} seed {seed}: first flag at env step "
              f"{hit['step']}, substep {hit['substep']}, check "
              f"{hit['check']}: qd margin {hit['qd_margin']!r} (dof "
              f"{hit['dof']}), root margin {hit['root_margin']!r}",
              flush=True)
        for k in ("q", "qd", "u", "step", "substep"):
            arrays[f"{seed}/{k}"] = np.asarray(hit[k])
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        np.savez(args.out, **arrays)
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
