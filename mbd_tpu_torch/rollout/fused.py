"""Batch-last rollout through the plain torch engine (port of
``mbd_tpu/rollout/fused.py``).

Rolls Nsample control sequences out over the horizon and scores them with
the env's ``reward_qs_b`` and, for a demo, its ``traj_xref_logpd_qs``. On
the CPU this is the planner's rollout; on the card it is the oracle the
CUDA kernel (``ops/rollout_cuda.py``) is held against, and the planner
never calls it there. ``states_from_qs`` turns a rollout's trace into
stacked link poses, for the viewer.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..envs.physics import PipelineState, X, Xd
from ..sim import batched as BT

# Calls of rollout_rewards on CUDA tensors. The planner's path on the card
# goes through the kernel, so a run can show this stayed 0.
CUDA_CALLS = 0
# The bits of the rewards a retiring rollout leaves unrun: the quiet NaN
# that the card's float arithmetic gives, so that the mesh's exact gather
# (a sum with −0.0) keeps them as they are.
RETIRED_BITS = 0x7FFFFFFF


def rollout_qs(sys, n_frames: int, q0: torch.Tensor, qd0: torch.Tensor,
               U: torch.Tensor, first: bool = False, rows: bool = False):
    """q0 [nq, N], qd0 [nv, N], U [H, nu, N] →
    (qs [H, nq, N], qds [H, nv, N], diverged [N]), and with ``first`` the
    env step at whose end each sample's flag first rose [N] (int32, −1
    where it never did), as the kernel writes it into its first-flag
    buffer; with ``rows`` each sample's contact-row substeps that acted
    (force cap not 0) in the env steps that started with it unflagged [N]
    (int32), as the kernel writes them into its rows buffer, from the
    engine's row log (``sim/batched.py``'s ``ROW_LOG``, whose entries an
    enclosing caller's log keeps, as ``tests/test_torch_work.py`` does)."""
    q, qd = q0, qd0
    bad = torch.zeros_like(q0[0])
    first_flag = torch.full(bad.shape, -1, dtype=torch.int32,
                            device=bad.device)
    acted = torch.zeros(bad.shape, dtype=torch.int64, device=bad.device)
    own = rows and BT.ROW_LOG is None
    if own:
        BT.ROW_LOG = []
    qs, qds = [], []
    try:
        for t in range(U.shape[0]):
            if rows:
                live, logged = bad == 0, len(BT.ROW_LOG)
            q, qd, bad = BT.env_step_checked_b(sys, q, qd, U[t], n_frames,
                                               bad)
            if first:
                first_flag = torch.where((first_flag < 0) & (bad != 0), t,
                                         first_flag)
            if rows:
                for entry in BT.ROW_LOG[logged:]:
                    acted += torch.where(live, entry[0], 0)
            qs.append(q)
            qds.append(qd)
    finally:
        if own:
            BT.ROW_LOG = None
    out = torch.stack(qs), torch.stack(qds), bad
    if first:
        out += (first_flag,)
    return out + (acted.to(torch.int32),) if rows else out


def env_step_outputs(env, q: torch.Tensor, qd: torch.Tensor,
                     u: torch.Tensor):
    """The plain version of the CUDA kernel's state-out mode: one env step
    of B samples from q [nq, B], qd [nv, B] under u [nu, B] →
    (q' [nq, B], qd' [nv, B], reward [B], bad [B])."""
    qs, qds, bad = rollout_qs(env.sys, env.n_frames, q, qd, u[None])
    rew = env.reward_qs_b(qs, qds, u[None], q, qd)[0]
    return qs[0], qds[0], rew, bad


def states_from_qs(sys, qs: torch.Tensor,
                   qds: Optional[torch.Tensor] = None) -> PipelineState:
    """Stacked PipelineState [H, B, ...] from a batch-last trace qs
    [H, nq, B] (and qds [H, nv, B]), by one forward-kinematics pass over
    the H·B states folded into one batch. Without ``qds`` (the CUDA
    kernel's ``need_qs`` mode gives q only) ``qd`` and the link velocities
    ``xd`` are None: the viewer reads the link poses ``x`` only."""
    H, nq, B = qs.shape
    q_flat = qs.permute(1, 2, 0).reshape(nq, B * H)      # [nq, B·H]
    if qds is None:
        kin = BT.fk_b(sys, q_flat)
        rows = (kin.xpos, kin.xquat)
    else:
        out = BT.link_out_b(sys, q_flat,
                            qds.permute(1, 2, 0).reshape(-1, B * H))
        rows = (out.xpos, out.xquat, out.vel, out.ang)

    def unfold(r):   # nbody × [k, B·H] → [H, B, nbody − 1, k]
        arr = torch.stack(r[1:])                         # [nlink, k, B·H]
        return arr.reshape(arr.shape[:2] + (B, H)).permute(3, 2, 0, 1)

    return PipelineState(
        q=qs.permute(0, 2, 1),                           # [H, B, nq]
        qd=None if qds is None else qds.permute(0, 2, 1),
        x=X(pos=unfold(rows[0]), rot=unfold(rows[1])),
        xd=None if qds is None else Xd(vel=unfold(rows[2]),
                                       ang=unfold(rows[3])))


def initial_states(sys, state0, N: int):
    """[nq, N] / [nv, N] initial states from ``state0.pipeline_state``,
    whose q/qd are shared ([nq]) or per sample ([nq, N])."""
    q0 = state0.pipeline_state.q
    qd0 = state0.pipeline_state.qd
    if q0.dim() == 1:
        q0 = q0[:, None].expand(sys.nq, N)
        qd0 = qd0[:, None].expand(sys.nv, N)
    return q0.contiguous(), qd0.contiguous()


def rollout_rewards(env, state0, Y0s: torch.Tensor, need_qs: bool = False,
                    first: bool = False, rows: bool = False
                    ) -> Tuple[Optional[torch.Tensor], ...]:
    """Y0s [N, H, nu] → (rews [N, H], qs [H, nq, N] if need_qs else None,
    diverged [N]), and with ``first`` each sample's first flagged env step
    [N], with ``rows`` its acting contact-row substeps [N]
    (``rollout_qs``)."""
    global CUDA_CALLS
    if Y0s.is_cuda:
        CUDA_CALLS += 1
    sys = env.sys
    N = Y0s.shape[0]
    U = Y0s.permute(1, 2, 0).contiguous()                # [H, nu, N]
    q0, qd0 = initial_states(sys, state0, N)
    qs, qds, diverged, *counts = rollout_qs(sys, env.n_frames, q0, qd0, U,
                                            first, rows)
    rews = env.reward_qs_b(qs, qds, U, q0, qd0)          # [H, N]
    return (rews.transpose(0, 1), (qs if need_qs else None), diverged,
            *counts)


def rollout_outputs(env, state0, Y0s: torch.Tensor, need_qs: bool = False,
                    demo: bool = False, first: bool = False,
                    retire: bool = False, rows: bool = False
                    ) -> Tuple[torch.Tensor, ...]:
    """The plain version of the CUDA rollout kernel: Y0s [N, H, nu] →
    (rews [N, H], bad [N][, qs [H, nq, N]][, logpd [N]][, first [N]][,
    rows [N]]), in the order of ``rollout_rewards_pallas``, with ``first``
    (the kernel's first-flag buffer) each sample's first flagged env step
    and with ``rows`` (its rows buffer) its acting contact-row substeps
    last (``rollout_qs``). The demo log-density is scored from the position
    trace, as JAX's fused engine scores it
    (``mbd_tpu/planners/mbd.py:179-188``). With ``retire``, the kernel's
    retiring form: rolled out whole, then every reward after a sample's
    first flagged env step replaced by the NaN of bits ``RETIRED_BITS``."""
    rews, qs, bad, *counts = rollout_rewards(env, state0, Y0s,
                                             need_qs or demo,
                                             first or retire, rows)
    if retire:
        first_flag = counts[0]
        after = torch.arange(rews.shape[1], device=rews.device) > \
            first_flag[:, None]
        # in place, so that the rewards keep the layout of the whole form's
        rews.view(torch.int32).masked_fill_(
            after & (first_flag >= 0)[:, None], RETIRED_BITS)
        if not first:
            counts = counts[1:]
    out = (rews, bad)
    if need_qs:
        out += (qs,)
    if demo:
        out += (env.traj_xref_logpd_qs(qs),)
    return out + tuple(counts)
