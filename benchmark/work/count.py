"""The work a plan needs, the bytes it moves and the least time an H100
could take for them, independent of how the program computes them.

``WORK`` and ``ROW_WORK`` are copied from ``mbd_tpu_torch/utils/work.py``
at commit f68a38a, where ``tests/test_torch_work.py`` held them equal to
live counts of the port's plain engine (torch 2.13 on the CPU):
``WORK[(model, demo)]`` is the operations the plain engine computes for
one sample and one env step (its n_frames substeps and the reward; with
``demo`` the demo score too), every constraint row included;
``ROW_WORK[model]`` is the part of one substep that a contact row and a
limit row need only when they act (force cap not 0).

What a launch needs (``needed_ops``): each sample counts only up to and
including its first flagged env step, since no planner reads a flagged
sample's rewards and the final selection drops it; a demo launch counts
every sample-step, since the demo's log-density is read past the flag.
Per counted sample-step, ``WORK`` less ``ROW_WORK`` for each row-substep
that did not act. Which rows act and where samples flag are data: the
reference records them (``Work``) on the launches of a fixed set of steps
(``tallied_steps``: the first two, the middle one and the last), which
does not depend on the run's seed, and every other step is taken at the
operations interpolated linearly between the tallied steps on either side
(an estimate for the steps the reference does not roll out).

The peaks are NVIDIA's data sheet for the H100 SXM at its 700 W limit:
67 TFLOP/s in float32 outside the tensor cores, 3.35 TB/s of HBM.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple

PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12

WORK = {
    ("hopper", False): 229745,
    ("walker2d", False): 403905,
    ("halfcheetah", False): 108125,
    ("ant", False): 238343,
    ("cartpole", False): 6475,
    ("pushT", False): 37035,
    ("humanoidrun", False): 412475,
    ("humanoidstandup", False): 580681,
    ("humanoidtrack", False): 390205,
    ("humanoidtrack", True): 394014,
}
ROW_WORK = {
    "hopper": (393, 209),
    "walker2d": (570, 314),
    "halfcheetah": (570, 314),
    "ant": (945, 569),
    "cartpole": (0, 74),
    "pushT": (442, 210),
    "humanoidrun": (1712, 1120),
    "humanoidstandup": (1712, 1120),
    "humanoidtrack": (1927, 1215),
}


class Tally(NamedTuple):
    """Sums over some samples of one launch: the env steps counted, and
    the contact and limit row-substeps that acted in them; with the rows
    a substep has."""
    steps: float
    contacts: float
    limits: float
    n_contacts: int
    n_limits: int


def tally(work, demo: bool = False, H: int = 0) -> Tally:
    """A ``reference.rollout.Work`` summed over its samples. A demo launch
    counts every sample-step (then its rows must have been recorded with
    every sample live)."""
    steps = float(work.live_steps.numel() * H) if demo \
        else float(work.live_steps.sum())
    return Tally(steps, float(work.contacts.sum()), float(work.limits.sum()),
                 work.n_contacts, work.n_limits)


def needed_ops(model: str, n_frames: int, t: Tally,
               demo: bool = False) -> float:
    """The operations the counted sample-steps of ``t`` need."""
    contact, limit = ROW_WORK[model]
    substeps = t.steps * n_frames
    idle = (substeps * t.n_contacts - t.contacts) * contact + \
        (substeps * t.n_limits - t.limits) * limit
    return t.steps * WORK[model, demo] - idle


def launch_bytes(nq: int, nv: int, nu: int, N: int, H: int) -> int:
    """What one launch of N samples over H steps must move: the controls
    and the per-sample initial states read once, the rewards and flags
    written once (float32)."""
    return 4 * (N * H * nu + (nq + nv) * N + N * H + N)


def least_s(ops: float, nbytes: float) -> float:
    """The least time for ``ops`` operations moving ``nbytes``: the larger
    of the two over their peaks."""
    return max(ops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def tallied_steps(T: int) -> List[int]:
    """The reverse steps (of T) whose launches the count tallies."""
    return sorted({0, min(1, T - 1), T // 2, T - 1})


class PlanWork(NamedTuple):
    ops: float        # what one plan needs
    least_s: float    # Σ over its launches of their least time


def plan_work(model: str, sys_sizes, n_frames: int, S: int, N: int, H: int,
              T: int, steps: Dict[int, Tally], final: Tally,
              demo: bool = False) -> PlanWork:
    """One plan of S seeds: T reverse steps, each a launch of S·N samples,
    and the final selection, one launch of S·T. ``steps``: the tallies of
    some steps' launches, step 0 and step T − 1 among them; every other
    step needs the operations interpolated linearly between the nearest
    tallied steps on either side. ``final``: the final launch's tally.
    ``sys_sizes``: (nq, nv, nu)."""
    known = sorted(steps)
    if known[0] != 0 or known[-1] != T - 1:
        raise ValueError(f"tallied steps {known} do not span [0, {T - 1}]")
    ops = {k: needed_ops(model, n_frames, steps[k], demo) for k in known}
    per_step = [ops[T - 1]]
    for a, b in zip(known, known[1:]):
        per_step += [ops[a] + (ops[b] - ops[a]) * (k - a) / (b - a)
                     for k in range(a, b)]
    final_ops = needed_ops(model, n_frames, final)
    nq, nv, nu = sys_sizes
    step_bytes = launch_bytes(nq, nv, nu, S * N, H)
    least = sum(least_s(o, step_bytes) for o in per_step) + \
        least_s(final_ops, launch_bytes(nq, nv, nu, S * T, H))
    return PlanWork(sum(per_step) + final_ops, least)
