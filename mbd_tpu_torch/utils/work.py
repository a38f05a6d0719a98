"""The fixed work count of a rollout: operations per sample and env step,
bytes moved, and the least time an H100 could take for them.

``WORK[(model, demo)]`` is the number of operations the plain version
computes for one sample and one env step (n_frames substeps and the
reward; with ``demo``, the demo score too): for every model the CUDA
rollout kernel builds, for humanoidtrack's demo mode, and for car2d's
step through ``rollout/rollout.py::rollout_us`` (with the demo, its
``eval_xref_logpd``). It counts every constraint row, as the plain
version computes them all.

A row whose force cap is 0 (a contact out of penetration, a limit within
its range) adds nothing to the result, and the kernel skips its work: for
a contact its Jacobian and force-direction rows, and for every row its
M⁻¹Jᵀ solve, effective mass, force bound and Gauss–Seidel updates.
``ROW_WORK[model]`` is that work per row and substep, (a contact row's, a
limit row's), in the plain version's count. What a rollout needs is then
``WORK`` less ``ROW_WORK`` for each row-substep that did not act; which
rows act depends on the data, so ``acting_rows`` records them while the
plain version runs (``sim/batched.py``'s ``ROW_LOG``), and
``needed_per_sample_step`` applies them.

Both tables are yardsticks, so they are fixed here and not counted at run
time: a live count (``ops_per_sample_step``, ``row_ops``) may shift with
the torch version or an edit of the plain engine, and
``tests/test_torch_work.py`` holds it equal to the tables, so that such a
change updates them in the open. The counts were taken with torch 2.13 on
the CPU.

The bound (``bound_ms``) is the larger of the operations over the H100
SXM's FP32 peak outside the tensor cores and the bytes over its memory
rate (NVIDIA's data sheet, at the full 700 W power limit).
"""

from __future__ import annotations

import functools
import sys as _sys
from typing import NamedTuple, Optional, Tuple

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

# operations per sample and env step, by (model, demo)
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
    ("car2d", False): 172,
    ("car2d", True): 184,
}
# operations per row and substep that only an acting row needs, by model:
# (a contact row's, a limit row's)
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


class Rows(NamedTuple):
    """Constraint row-substeps over some rollouts: the contact rows that
    acted and all contact rows, the limit rows that acted and all."""
    contacts_acting: int
    contacts: int
    limits_acting: int
    limits: int


def acting_rows(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` with the plain engine's rows recorded:
    (its result, the ``Rows`` of every substep it ran)."""
    import torch

    from ..sim import batched

    batched.ROW_LOG = log = []
    try:
        out = fn(*args, **kwargs)
    finally:
        batched.ROW_LOG = None
    if not log:
        return out, Rows(0, 0, 0, 0)
    acting = torch.stack([torch.stack([e[0].sum(), e[2].sum()])
                          for e in log]).sum(0)
    return out, Rows(int(acting[0]), sum(e[1] for e in log),
                     int(acting[1]), sum(e[3] for e in log))


@functools.lru_cache(maxsize=None)
def _live_count(name: str, demo: bool) -> Tuple[int, int, int]:
    """One rollout at N = 1, H = 1 on the CPU, its operations counted by a
    dispatch mode: one per output element of each computing aten op, one
    per input element of a reduction, a sine or a square root as one.
    Returns (all operations, those of the contact rows' directions, those
    of every row's solve and sweep). A physics model rolls out through
    the kernel's plain version
    (``rollout/fused.py::rollout_outputs``; the position trace adds no
    operation, only bytes), car2d through ``rollout_us`` from a
    per-sample state, as the planner steps it, and with ``demo`` its
    ``eval_xref_logpd``."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from .. import envs
    from ..envs.physics import PhysicsEnv
    from ..rollout.fused import rollout_outputs
    from ..rollout.rollout import rollout_us
    from ..sim import batched

    dirs = batched._contact_dirs.__code__
    per_row = {batched._row_solve.__code__, batched._gs_sweep.__code__}

    class Count(TorchDispatchMode):
        ops = {"all": 0, "dirs": 0, "row": 0}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            op = func.overloadpacket.__name__
            n = 0
            if op in REDUCTIONS:
                n = args[0].numel()
            elif op not in MOVES:
                outs = out if isinstance(out, (tuple, list)) else (out,)
                n = sum(o.numel() for o in outs
                        if isinstance(o, torch.Tensor))
            self.ops["all"] += n
            # the phases call the ops at most a few frames down
            frame = _sys._getframe(1)
            for _ in range(6):
                if frame is None:
                    break
                if frame.f_code is dirs:
                    self.ops["dirs"] += n
                    break
                if frame.f_code in per_row:
                    self.ops["row"] += n
                    break
                frame = frame.f_back
            return out

    env = envs.get_env(name, device="cpu")
    state0 = env.reset(torch.Generator().manual_seed(0))
    us = torch.zeros((1, 1, env.action_size))
    if not isinstance(env, PhysicsEnv):
        state0 = state0.replace(pipeline_state=state0.pipeline_state[None])
    with Count() as count:
        if isinstance(env, PhysicsEnv):
            rollout_outputs(env, state0, us, demo=demo)
        else:
            _, xs = rollout_us(env, state0, us)
            if demo:
                env.eval_xref_logpd(xs)
    return count.ops["all"], count.ops["dirs"], count.ops["row"]


def ops_per_sample_step(name: str, demo: bool = False) -> int:
    """The live count behind ``WORK[(name, demo)]`` (``_live_count``)."""
    return _live_count(name, demo)[0]


def row_ops(name: str) -> Tuple[int, int]:
    """The live count behind ``ROW_WORK[name]``: the operations of one
    contact row and of one limit row in one substep that the row needs
    only when it acts. The plain version computes each phase for all rows
    at once, as much for each row, so a phase's count divides evenly by
    its rows."""
    import torch

    from .. import envs
    from ..rollout.fused import rollout_outputs

    _, dirs, row = _live_count(name, False)
    env = envs.get_env(name, device="cpu")
    rows = acting_rows(rollout_outputs, env,
                       env.reset(torch.Generator().manual_seed(0)),
                       torch.zeros((1, 1, env.action_size)))[1]
    every = rows.contacts + rows.limits
    if dirs % max(rows.contacts, 1) or row % max(every, 1):
        raise AssertionError(f"{name}: the row phases' operations do not "
                             f"divide by the rows ({dirs}, {row}, {rows})")
    per_row = row // every if every else 0
    return (dirs // rows.contacts + per_row if rows.contacts else 0,
            per_row if rows.limits else 0)


def needed_per_sample_step(model: str, demo: bool, rows: Rows,
                           sample_steps: int) -> float:
    """What a rollout needs per sample and env step: ``WORK`` less
    ``ROW_WORK`` for each row-substep of ``rows`` that did not act, over
    the ``sample_steps`` those rows were recorded on."""
    if not sample_steps:
        return float(WORK[model, demo])
    contact, limit = ROW_WORK.get(model, (0, 0))
    idle = (rows.contacts - rows.contacts_acting) * contact + \
        (rows.limits - rows.limits_acting) * limit
    return WORK[model, demo] - idle / sample_steps


def rollout_bytes(env, N: int, H: int, per_sample: bool = False,
                  need_qs: bool = False, demo: bool = False) -> int:
    """What one launch of the kernel must move: the controls, the initial
    state (per sample or shared) and the demo frames read once, every
    output (rewards, flags, the trace, the log-density) written once."""
    sys = env.sys
    floats = N * H * sys.nu + (sys.nq + sys.nv) * (N if per_sample else 1)
    floats += N * H + N                                # rews, bad
    floats += H * sys.nq * N if need_qs else 0
    floats += H * env.xref.shape[0] * 3 + N if demo else 0
    return 4 * floats


def bound_ms(ops: float, nbytes: float) -> Tuple[float, str]:
    """The least time the card could take for ``ops`` operations that move
    ``nbytes``: (ms, "operations" or "bytes", whichever bounds it)."""
    t_ops = ops / PEAK_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def rollout_bound(env, name: str, N: int, H: int, per_sample: bool = False,
                  need_qs: bool = False, demo: bool = False,
                  ops_per_sample_step: Optional[float] = None
                  ) -> Tuple[float, str]:
    """``bound_ms`` of one launch of model ``name`` at N samples and H
    steps, its operations ``ops_per_sample_step`` per sample and step
    (``WORK``'s when not given)."""
    if ops_per_sample_step is None:
        ops_per_sample_step = WORK[name, demo]
    return bound_ms(ops_per_sample_step * N * H,
                    rollout_bytes(env, N, H, per_sample, need_qs, demo))
