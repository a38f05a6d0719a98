"""Batch-last rollout through the plain torch engine (port of
``mbd_tpu/rollout/fused.py``).

Rolls Nsample control sequences out over the horizon and scores them with
the env's ``reward_qs_b`` and, for a demo, its ``traj_xref_logpd_qs``. On
the CPU this is the planner's rollout; on the card it is the oracle the
CUDA kernel (``ops/rollout_cuda.py``) is held against, and the planner
never calls it there.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..sim import batched as BT

# Calls of rollout_rewards on CUDA tensors. The planner's path on the card
# goes through the kernel, so a run can show this stayed 0.
CUDA_CALLS = 0


def rollout_qs(sys, n_frames: int, q0: torch.Tensor, qd0: torch.Tensor,
               U: torch.Tensor):
    """q0 [nq, N], qd0 [nv, N], U [H, nu, N] →
    (qs [H, nq, N], qds [H, nv, N], diverged [N])."""
    q, qd = q0, qd0
    bad = torch.zeros_like(q0[0])
    qs, qds = [], []
    for t in range(U.shape[0]):
        q, qd, bad = BT.env_step_checked_b(sys, q, qd, U[t], n_frames, bad)
        qs.append(q)
        qds.append(qd)
    return torch.stack(qs), torch.stack(qds), bad


def initial_states(sys, state0, N: int):
    """[nq, N] / [nv, N] initial states from ``state0.pipeline_state``,
    whose q/qd are shared ([nq]) or per sample ([nq, N])."""
    q0 = state0.pipeline_state.q
    qd0 = state0.pipeline_state.qd
    if q0.dim() == 1:
        q0 = q0[:, None].expand(sys.nq, N)
        qd0 = qd0[:, None].expand(sys.nv, N)
    return q0.contiguous(), qd0.contiguous()


def rollout_rewards(env, state0, Y0s: torch.Tensor, need_qs: bool = False
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                               torch.Tensor]:
    """Y0s [N, H, nu] → (rews [N, H], qs [H, nq, N] if need_qs else None,
    diverged [N])."""
    global CUDA_CALLS
    if Y0s.is_cuda:
        CUDA_CALLS += 1
    sys = env.sys
    N = Y0s.shape[0]
    U = Y0s.permute(1, 2, 0).contiguous()                # [H, nu, N]
    q0, qd0 = initial_states(sys, state0, N)
    qs, qds, diverged = rollout_qs(sys, env.n_frames, q0, qd0, U)
    rews = env.reward_qs_b(qs, qds, U, q0, qd0)          # [H, N]
    return rews.transpose(0, 1), (qs if need_qs else None), diverged


def rollout_outputs(env, state0, Y0s: torch.Tensor, need_qs: bool = False,
                    demo: bool = False) -> Tuple[torch.Tensor, ...]:
    """The plain version of the CUDA rollout kernel: Y0s [N, H, nu] →
    (rews [N, H], bad [N][, qs [H, nq, N]][, logpd [N]]), in the order of
    ``rollout_rewards_pallas``. The demo log-density is scored from the
    position trace, as JAX's fused engine scores it
    (``mbd_tpu/planners/mbd.py:179-188``)."""
    rews, qs, bad = rollout_rewards(env, state0, Y0s,
                                    need_qs=need_qs or demo)
    out = (rews, bad)
    if need_qs:
        out += (qs,)
    if demo:
        out += (env.traj_xref_logpd_qs(qs),)
    return out
