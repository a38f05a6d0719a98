"""HumanoidRun: 17-actuator humanoid on a free root, run-forward reward
(port of ``mbd_tpu/envs/humanoidrun.py``): n_frames=7 at the model's
timestep 0.006, reset noise ±0.01 on q and qd, obs = [q, qd],
reward = torso_x − clip(|torso_z − 1.3|, −1, 1) − 0.1·|torso_y|."""

from __future__ import annotations

import torch

from ..device import DEFAULT
from .base import State
from .physics import PhysicsEnv, load


class HumanoidRun(PhysicsEnv):
    model = "humanoidrun"
    z_target = 1.3          # torso height the reward centres on
    reset_noise = 0.01
    # its plans run at N = 8192, where 16 lanes a sample beat 8 on an H100
    # (at N = 2048, 8 did; PERF.md, PR 5)
    kernel_group = 16

    def __init__(self, device=DEFAULT):
        super().__init__(load(self.model, device), n_frames=7)

    @property
    def kernel_reward(self):
        # q0 − clip(|q2 − z_target|, −1, 1) − 0.1·|q1|
        return ("run", {"z_target": self.z_target})

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
                             reward=self._reward(ps))

    def _reward(self, ps) -> torch.Tensor:
        return self.torso_reward(ps.x.pos[0, 0], ps.x.pos[0, 1],
                                 ps.x.pos[0, 2])

    def torso_reward(self, x, y, z):
        return (x - torch.clamp((z - self.z_target).abs(), -1.0, 1.0)
                - 0.1 * y.abs())

    def reward_qs_b(self, qs, qds, us, q0, qd0):
        """Batch-last reward [H, N]: free root, so the torso position is
        q[0:3]."""
        return self.torso_reward(qs[:, 0], qs[:, 1], qs[:, 2])
