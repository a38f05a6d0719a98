"""Halfcheetah: planar runner, forward-velocity reward (port of
``mbd_tpu/envs/halfcheetah.py``): reward = forward_velocity − 0.1·Σu²,
velocity from the torso x displacement over env.dt; reset noise ±0.1 on q,
N(0, 0.1) on qd; n_frames=5."""

from __future__ import annotations

import torch

from ..device import DEFAULT
from ..sim.batched import recip32
from .base import State
from .physics import PhysicsEnv, load


class Halfcheetah(PhysicsEnv):
    def __init__(self, device=DEFAULT):
        super().__init__(load("halfcheetah", device), n_frames=5)

    @property
    def kernel_reward(self):
        # (q0 − q0_prev)·(1/dt) − ctrl_cost·Σu²
        return ("velocity", {"inv_dt": recip32(self.dt), "ctrl_cost": 0.1})

    def reset(self, generator: torch.Generator) -> State:
        q = self.sys.init_q + self._uniform(generator, self.sys.nq, -0.1, 0.1)
        qd = 0.1 * torch.randn(self.sys.nv, generator=generator,
                               device=self.device)
        return self._state(self.pipeline_init(q, qd))

    def step(self, state: State, action: torch.Tensor) -> State:
        ps0 = state.pipeline_state
        ps = self.pipeline_step(ps0, action)
        velocity = (ps.x.pos[0] - ps0.x.pos[0]) * recip32(self.dt)
        reward = velocity[0] - 0.1 * (action * action).sum()
        return state.replace(pipeline_state=ps, obs=self._obs(ps),
                             reward=reward,
                             done=torch.zeros((), device=self.device))

    def _obs(self, ps) -> torch.Tensor:
        return torch.cat([ps.q[1:], ps.qd])

    def obs_qs_b(self, q, qd):
        """Batch-last _obs: [q[1:], qd] (root x excluded)."""
        return torch.cat([q[1:], qd], dim=0)

    def reward_qs_b(self, qs, qds, us, q0, qd0):
        """Batch-last reward [H, N]: torso x = q[0], previous step's x from
        the trace (q0 for the first step)."""
        prev = torch.cat([q0[0:1], qs[:-1, 0]], dim=0)
        vel = (qs[:, 0] - prev) * recip32(self.dt)
        u2 = us * us
        cost = u2[:, 0]
        for k in range(1, u2.shape[1]):
            cost = cost + u2[:, k]
        return vel - 0.1 * cost
