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
from .fused import initial_states, rollout_outputs
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
# The card's flagged and clean humanoid states on the last step of the
# humanoid plans of ``tests/torch_flag_check.py --card``, and one
# substep's margins from each.
FLAG_STATES = os.path.join(ROOT, "mbd_tpu_torch", "assets",
                           "humanoid_flags.npz")


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


def first_flags(env, state0, Y0s: torch.Tensor, states: bool = False,
                trace: bool = False) -> SimpleNamespace:
    """Where the validity envelope first flags each of N samples: Y0s
    [N, H, nu] rolled out from ``state0`` (q/qd shared or per sample)
    through the plain engine one substep at a time on ``env.device``, each
    check read after every substep in ``env_step_checked_b``'s order: the
    substep, |qd| against ``QD_DIVERGED`` (``"qd"``), each root against
    ``ROOT_SINK_TOL`` below the floor through ``height_sensors``
    (``"root"``), the clamp. On the card the kernel gives the same bits.

    Returns a namespace of [N] tensors on ``env.device``: ``first``, the
    first flagged substep (env step · n_frames + substep; −1: clean);
    ``root``, True where the root check tripped there and |qd| did not;
    ``speed``, ``low`` and ``dof`` after that substep (the largest |qd|,
    the lowest root, +inf without a floor, and the dof of the largest
    speed); the closest approach up to the first flag (a clean sample's
    whole run): ``peak`` and ``peak_dof`` at ``peak_at``, the substep of
    the largest |qd|, and ``lowest`` at ``lowest_at``, that of the lowest
    root; ``bad``, the flags as the kernel gives them; and ``H``,
    ``n_frames``, ``zmin`` (the roots' limit, None without a floor). With
    ``states``, ``pre``: for "flag", "peak" and "lowest", the state before
    that substep, (q [nq, N], qd [nv, N], u [nu, N]). With ``trace``,
    ``rews`` [N, H], ``rollout_outputs``' rewards."""
    sys, nf = env.sys, env.n_frames
    N, H = Y0s.shape[:2]
    U = Y0s.permute(1, 2, 0).contiguous()                # [H, nu, N]
    q0, qd0 = initial_states(sys, state0, N)
    hs = sys.cached("height_sensors", lambda: BT.height_sensors(sys))
    zmin = None if hs is None else BT.f32(hs[1] - BT.ROOT_SINK_TOL)
    inf = torch.full((N,), float("inf"), dtype=q0.dtype, device=q0.device)
    never = torch.full((N,), -1, dtype=torch.long, device=q0.device)
    r = SimpleNamespace(first=never, root=never >= 0, speed=-inf, low=inf,
                        dof=never, peak=-inf, peak_at=never, peak_dof=never,
                        lowest=inf, lowest_at=never, H=H, n_frames=nf,
                        zmin=zmin)
    if states:
        r.pre = dict.fromkeys(("flag", "peak", "lowest"), (
            torch.zeros_like(q0), torch.zeros_like(qd0),
            torch.zeros_like(U[0])))
    q, qd, qs, qds = q0, qd0, [], []
    for t in range(H):
        u = U[t]
        for f in range(nf):
            pre = (q, qd, u)
            q, qd = BT.substep_b(sys, q, qd, u)
            speed, dof = qd.abs().max(dim=0)
            fast = speed > BT.QD_DIVERGED
            tripped, low = fast, inf
            if hs is not None:
                for qadr, off in hs[0]:
                    z = q[qadr] + BT.f32(off)
                    tripped = tripped | (z < zmin)
                    low = torch.minimum(low, z)
            live = r.first < 0
            k = t * nf + f
            for name, mask, fields in (
                    ("flag", live & tripped, dict(
                        first=k, root=~fast, speed=speed, low=low,
                        dof=dof)),
                    ("peak", live & (speed > r.peak), dict(
                        peak=speed, peak_at=k, peak_dof=dof)),
                    ("lowest", live & (low < r.lowest), dict(
                        lowest=low, lowest_at=k))):
                for field, v in fields.items():
                    setattr(r, field, torch.where(mask, v,
                                                  getattr(r, field)))
                if states:
                    r.pre[name] = tuple(torch.where(mask, a, b) for a, b
                                        in zip(pre, r.pre[name]))
            qd = torch.clamp(qd, -BT.QD_DIVERGED, BT.QD_DIVERGED)
        if trace:
            qs.append(q)
            qds.append(qd)
    r.bad = (r.first >= 0).to(q0.dtype)
    if trace:
        r.rews = env.reward_qs_b(torch.stack(qs), torch.stack(qds), U, q0,
                                 qd0).transpose(0, 1)
    return r


def margins(zmin, speed, low):
    """Each check's margin in float64 on the host (positive = tripped):
    the largest |qd| less ``QD_DIVERGED``, and the roots' limit ``zmin``
    less the lowest root (−inf without a floor, ``zmin`` None)."""
    speed = np.asarray(torch.as_tensor(speed).cpu(), np.float64)
    low = np.asarray(torch.as_tensor(low).cpu(), np.float64)
    if zmin is None:
        return speed - BT.QD_DIVERGED, np.full_like(low, -np.inf)
    return speed - BT.QD_DIVERGED, zmin - low


def summary(rec) -> dict:
    """``first_flags``' counts: samples, flagged, flagged by check,
    ``first_steps`` (the flagged samples by the env step of their first
    flag) and ``tail_share`` (the sample-substeps after each sample's
    first flagged substep, over N · H · n_frames)."""
    first = rec.first.cpu().numpy()
    root = rec.root.cpu().numpy()
    hit = first >= 0
    steps = rec.H * rec.n_frames
    return dict(samples=len(first), flagged=int(hit.sum()),
                by_check={"qd": int((hit & ~root).sum()),
                          "root": int((hit & root).sum())},
                first_steps=np.bincount(first[hit] // rec.n_frames,
                                        minlength=rec.H).tolist(),
                tail_share=float((steps - 1 - first[hit]).sum()
                                 / (len(first) * steps)))


def flag_of(rec, n: int):
    """Sample ``n`` of a ``first_flags`` record taken with ``states``:
    None when clean, else a dict of the env step and substep of its first
    flag, the check that tripped, both margins there (``margins``), the
    dof of the largest speed and the state before that substep (q, qd,
    the control u) on the host."""
    k = int(rec.first[n])
    if k < 0:
        return None
    qd_margin, root_margin = margins(rec.zmin, rec.speed[n], rec.low[n])
    q, qd, u = (a[:, n].cpu().numpy() for a in rec.pre["flag"])
    return dict(step=k // rec.n_frames, substep=k % rec.n_frames,
                check="root" if bool(rec.root[n]) else "qd",
                qd_margin=float(qd_margin), root_margin=float(root_margin),
                dof=int(rec.dof[n]), q=q, qd=qd, u=u)


def seed_plan(env, directory: str, seed: int):
    """Seed ``seed``'s reset and committed plan of ``results/<directory>``
    as a batch of 1 on ``env.device``: (state, plan [1, H, nu])."""
    ps = seed_states(env, HARNESS[directory]).pipeline_state
    one = SimpleNamespace(pipeline_state=SimpleNamespace(
        q=ps.q[:, seed:seed + 1].contiguous(),
        qd=ps.qd[:, seed:seed + 1].contiguous()))
    plan = harness(directory)["plans"][seed:seed + 1]
    return one, torch.from_numpy(plan).to(env.device)


def first_flag(env, directory: str, seed: int):
    """Where the validity envelope first flags seed ``seed``'s committed
    plan of ``results/<directory>``, rolled out from its reset:
    ``first_flags`` at a batch of 1, as ``flag_of`` gives it."""
    return flag_of(first_flags(env, *seed_plan(env, directory, seed),
                               states=True), 0)


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
            one, plan = seed_plan(env, directory, seed)
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
