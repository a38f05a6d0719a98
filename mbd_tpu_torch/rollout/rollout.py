"""One plan's rollout as stacked states, for the viewer (the physics-env
counterpart of ``mbd_tpu/rollout/rollout.py::rollout_states``)."""

from __future__ import annotations

import torch

from ..envs.physics import PipelineState
from ..ops.rollout_cuda import rollout_rewards_cuda
from .fused import states_from_qs


def rollout_states(env, state_init, us: torch.Tensor) -> PipelineState:
    """The states after each step of rolling ``us`` [H, nu] out from
    ``state_init``, stacked [H, ...]: q [H, nq] and the link poses x
    (pos [H, nlink, 3], rot [H, nlink, 4]); qd and xd are None.

    The trace comes from one rollout of one sample with the position trace
    (on the card, one launch of the kernel's ``need_qs`` mode), and the
    link poses from ``states_from_qs``."""
    _, _, qs = rollout_rewards_cuda(env, state_init, us[None], need_qs=True)
    ps = states_from_qs(env.sys, qs)
    return PipelineState(q=ps.q[:, 0], qd=None,
                         x=type(ps.x)(pos=ps.x.pos[:, 0],
                                      rot=ps.x.rot[:, 0]),
                         xd=None)
