"""The comparison that decides ``correct``: one of the window's plans held
against the reference, at the plan's own sizes.

The reference works out again, from the plan's seeds and the model's
snapshot, the reset and the noise of the reverse steps it takes, and
rolls out:

* the first two steps on its own: the first around the zero iterate, the
  second around the reference's own first iterate, so that for two steps
  it takes nothing of the program's state;
* a later step t in [2, T − 2] drawn from the run's seed, around the
  program's iterate before it: from there the reference follows the
  program's own state, since a plan of 300 steps cannot be followed at
  the cost of a run;
* every candidate of the final selection (the program's iterates before
  the last, and the plan it returned);
* the ``extra`` steps asked for, around the program's iterate before
  each, for the work count alone.

It then forms the steps' next iterates and makes the final selection
itself. The program's outputs are only judged:

* ``first_step_gap``, ``second_step_gap``, ``step_gap``: the largest
  |Δ| between the program's iterate after the step and the reference's,
  over the seeds;
* ``final_reward_gap``: the largest |Δ| between the plan's reported
  final reward and the reference's mean reward of the plan it returned;
* ``final_flag_miss``: seeds whose reported divergence is not the
  reference's flag of the returned plan;
* ``selection_miss``: seeds whose returned plan is not the one the
  selection rule picks from the reference's rewards and flags. The
  program writes its choice over its last iterate, so: when the returned
  plan is one of the earlier iterates, it must be the best clean one;
  when it is not, it is the last iterate, and it must be clean unless no
  earlier candidate is.

``control_plan`` is the control: the reference put in the program's
place, in the nearest precision below the configuration's, for the same
comparison to judge.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence

import torch

from . import planner as P
from .rollout import Work, rollout


class Plan(NamedTuple):
    """What the program returned for one plan of S seeds (on any device):
    the iterates [S, T, H, nu] (the last overwritten by the final
    selection's choice), the final rewards [S] and divergence [S]."""
    Ybars: torch.Tensor
    final_reward: torch.Tensor
    final_diverged: torch.Tensor


class Outcome(NamedTuple):
    numbers: Dict[str, float]
    steps: Dict[int, Work]    # each step rolled out: its launch of S·N
    final: Work               # the final selection's launch of S·T


def _gap(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max())


def _part(work: Work, lo: int, hi: int) -> Work:
    return Work(*(x[lo:hi] for x in work[:3]), work.n_contacts,
                work.n_limits)


def _launch(model, d: P.Draws, batches: Sequence[torch.Tensor]) -> List:
    """The seed-major batches [S, n, H, nu] rolled out in one launch, each
    from its seeds' resets: (rewards [S·n, H] as a launch of its own lays
    them out, flags [S·n], ``Work``) a batch."""
    S = d.q0.shape[0]
    sizes = [S * b.shape[1] for b in batches]
    Y = torch.cat([b.reshape(-1, *b.shape[2:]) for b in batches])
    q0 = torch.cat([P.seed_major(d.q0, b.shape[1]) for b in batches], dim=1)
    qd0 = torch.cat([P.seed_major(d.qd0, b.shape[1]) for b in batches],
                    dim=1)
    rews, bad, work = rollout(model, q0, qd0, Y, record=True)
    out, lo = [], 0
    for n, (r, f) in zip(sizes, P.segments(rews, bad, sizes)):
        out.append((r, f, _part(work, lo, lo + n)))
        lo += n
    return out


def _index(cfg: dict, k: int) -> int:
    """The schedule's index of reverse step k."""
    return cfg["Ndiffuse"] - 1 - k


def _next(cfg, sched, k, Ybar, Y, rolled, precision="float32"):
    """Step k's next iterate from Ybar [S, H, nu], its samples Y [S, N, H,
    nu] and their rollout."""
    S, N, H = Y.shape[:3]
    r, f, _ = rolled
    return P.step(sched, _index(cfg, k), Ybar, Y, r.reshape(S, N, H),
                  f.reshape(S, N), cfg["temp_sample"], precision)


def compare(model, cfg: dict, seeds, plan: Plan, t: int, device,
            extra: Sequence[int] = ()) -> Outcome:
    """The numbers of the module docstring for ``plan`` (of ``seeds``, at
    config ``cfg``), with the later step t (2 ≤ t ≤ T − 2), and the work
    of every step rolled out (0, 1, t and ``extra``) and of the final
    selection."""
    Ybars = plan.Ybars.to(device)
    S, T, H, nu = Ybars.shape
    N = cfg["Nsample"]
    if not 2 <= t <= T - 2:
        raise ValueError(f"step {t} is not in [2, {T - 2}]")
    sched = P.schedule(cfg["Ndiffuse"], cfg["beta0"], cfg["betaT"], device)
    around = sorted(({t} | set(extra)) - {0, 1})
    d = P.draws(model, seeds, [0, 1] + around, (N, H, nu), device)

    def samples(k, Ybar):
        return P.samples(sched, _index(cfg, k), Ybar, d.eps[k])

    zero = torch.zeros((S, H, nu), device=device)
    Y = {0: samples(0, zero)}
    Y.update({k: samples(k, Ybars[:, k - 1]) for k in around})
    *rolled, final = _launch(model, d, [Y[k] for k in [0] + around]
                             + [Ybars])
    rolled = dict(zip([0] + around, rolled))
    first = _next(cfg, sched, 0, zero, Y[0], rolled[0])
    Y[1] = samples(1, first)
    rolled[1] = _launch(model, d, [Y[1]])[0]
    second = _next(cfg, sched, 1, first, Y[1], rolled[1])
    later = _next(cfg, sched, t, Ybars[:, t - 1], Y[t], rolled[t])

    sel = P.select(final[0], final[1], S)
    last = T - 1
    reward = sel.cand[:, last]
    flagged = ~sel.feasible[:, last]
    final_reward = plan.final_reward.to(device).reshape(S)
    final_diverged = plan.final_diverged.to(device).reshape(S).bool()
    miss = 0
    for s in range(S):
        same = [k for k in range(last)
                if torch.equal(Ybars[s, k], Ybars[s, last])]
        feasible = sel.feasible[s]
        if same:
            masked = torch.where(feasible[:last], sel.cand[s, :last],
                                 torch.full_like(sel.cand[s, :last],
                                                 -float("inf")))
            ok = bool(feasible[same[0]]) and \
                same[0] == int(torch.argmax(masked))
        else:
            ok = bool(feasible[last]) or not bool(feasible[:last].any())
        miss += not ok
    numbers = dict(
        first_step_gap=_gap(Ybars[:, 0], first),
        second_step_gap=_gap(Ybars[:, 1], second),
        step_gap=_gap(Ybars[:, t], later),
        final_reward_gap=_gap(final_reward, reward),
        final_flag_miss=int((final_diverged != flagged).sum()),
        selection_miss=miss)
    return Outcome(numbers, {k: w for k, (_, _, w) in rolled.items()},
                   final[2])


def control_plan(model, cfg: dict, seeds, plan: Plan, t: int,
                 device) -> Plan:
    """The control: the reference in the program's place, in the nearest
    precision below the float32 (TF32 off) that the configuration states.
    ``plan`` with its iterates after the first step and after step t
    replaced by the reference's, each with its barycenter formed from
    TF32-rounded operands; every other output is the program's."""
    Ybars = plan.Ybars.to(device).clone()
    S, T, H, nu = Ybars.shape
    sched = P.schedule(cfg["Ndiffuse"], cfg["beta0"], cfg["betaT"], device)
    d = P.draws(model, seeds, (0, t), (cfg["Nsample"], H, nu), device)
    zero = torch.zeros((S, H, nu), device=device)
    Y0 = P.samples(sched, _index(cfg, 0), zero, d.eps[0])
    Yt = P.samples(sched, _index(cfg, t), Ybars[:, t - 1], d.eps[t])
    r0, rt = _launch(model, d, [Y0, Yt])
    Ybars[:, 0] = _next(cfg, sched, 0, zero, Y0, r0, "tf32")
    Ybars[:, t] = _next(cfg, sched, t, Ybars[:, t - 1], Yt, rt, "tf32")
    return Plan(Ybars, plan.final_reward, plan.final_diverged)
