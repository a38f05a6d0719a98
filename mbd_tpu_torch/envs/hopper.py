"""Hopper: planar one-legged hopper, forward-progress reward (port of
``mbd_tpu/envs/hopper.py``): n_frames=20, reset noise ±5e-3 on q/qd,
reward = torso_x − 0.5·clip(|torso_z − 1|, −1, 1)."""

from __future__ import annotations

import torch

from ..device import DEFAULT
from .base import State
from .physics import PhysicsEnv, load


class Hopper(PhysicsEnv):
    model = "hopper"
    z_target = 1.0          # torso height the reward centres on
    reset_noise = 5e-3

    def __init__(self, device=DEFAULT):
        super().__init__(load(self.model, device), n_frames=20)

    @property
    def kernel_reward(self):
        # q0 − 0.5·clip(|q1 − z_target|, −1, 1)
        return ("progress", {"z_target": self.z_target})

    def reset_q(self, generator: torch.Generator):
        lo, hi = -self.reset_noise, self.reset_noise
        q = self.sys.init_q + self._uniform(generator, self.sys.nq, lo, hi)
        qd = self._uniform(generator, self.sys.nv, lo, hi)
        return q, qd

    def reset(self, generator: torch.Generator) -> State:
        return self._state(self.pipeline_init(*self.reset_q(generator)))

    def step(self, state: State, action: torch.Tensor) -> State:
        ps = self.pipeline_step(state.pipeline_state, action)
        return state.replace(pipeline_state=ps, obs=self._obs(ps),
                             reward=self._reward(ps),
                             done=torch.zeros((), device=self.device))

    def _obs(self, ps) -> torch.Tensor:
        position = ps.q.clone()
        position[1] = ps.x.pos[0, 2]
        return torch.cat([position, torch.clamp(ps.qd, -10.0, 10.0)])

    def _reward(self, ps) -> torch.Tensor:
        return ps.x.pos[0, 0] - 0.5 * torch.clamp(
            (ps.x.pos[0, 2] - self.z_target).abs(), -1.0, 1.0)

    def obs_qs_b(self, q, qd):
        """Batch-last _obs: torso z is q[1] for this morphology."""
        return torch.cat([q, torch.clamp(qd, -10.0, 10.0)], dim=0)

    def reward_qs_b(self, qs, qds, us, q0, qd0):
        """Batch-last reward [H, N]: torso (x, z) = (q[0], q[1])."""
        return qs[:, 0] - 0.5 * torch.clamp(
            (qs[:, 1] - self.z_target).abs(), -1.0, 1.0)
