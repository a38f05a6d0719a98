"""Horizon rollouts outside the kernel (the counterparts of
``mbd_tpu/rollout/rollout.py``): ``rollout_us`` / ``eval_us`` step an
analytic env (car2d) over a batch of control sequences, and
``rollout_states`` stacks one plan's states for the viewer."""

from __future__ import annotations

from typing import Tuple

import torch

from ..envs.physics import PhysicsEnv, PipelineState
from ..ops.rollout_cuda import rollout_rewards_cuda
from .fused import states_from_qs


def rollout_us(env, state, us: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Roll controls ``us`` [..., H, nu] out from ``state`` (its pipeline
    state shared, or with the same leading axes as ``us``) through
    ``env.step``, one step of the whole batch at a time: (rewards
    [..., H], the pipeline states after each step [..., H, *]). JAX's
    ``rollout_us`` under ``jax.vmap`` over the leading axes."""
    rews, xs = [], []
    for t in range(us.shape[-2]):
        state = env.step(state, us[..., t, :])
        rews.append(state.reward)
        xs.append(state.pipeline_state)
    return torch.stack(rews, dim=-1), torch.stack(xs, dim=-2)


def eval_us(env, state, us: torch.Tensor) -> torch.Tensor:
    """The rewards [..., H] of ``rollout_us``."""
    return rollout_us(env, state, us)[0]


def rollout_states(env, state_init, us: torch.Tensor):
    """The states after each step of rolling ``us`` [H, nu] out from
    ``state_init``, stacked [H, ...].

    A physics env: a PipelineState with q [H, nq] and the link poses x
    (pos [H, nlink, 3], rot [H, nlink, 4]); qd and xd are None. The trace
    comes from one rollout of one sample with the position trace (on the
    card, one launch of the kernel's ``need_qs`` mode), and the link poses
    from ``states_from_qs``. An analytic env: its pipeline states [H, 3]
    from ``rollout_us``."""
    if not isinstance(env, PhysicsEnv):
        return rollout_us(env, state_init, us)[1]
    _, _, qs = rollout_rewards_cuda(env, state_init, us[None], need_qs=True)
    ps = states_from_qs(env.sys, qs)
    return PipelineState(q=ps.q[:, 0], qd=None,
                         x=type(ps.x)(pos=ps.x.pos[:, 0],
                                      rot=ps.x.rot[:, 0]),
                         xd=None)
