"""Cartpole swing-up (port of ``mbd_tpu/envs/cartpole.py``): sys.dt :=
0.005, n_frames=4; reset adds π to the pole angle plus ±0.01 noise;
reward = cos(pole angle) − |cart velocity|."""

from __future__ import annotations

import math

import torch

from ..device import DEFAULT
from .base import State
from .physics import PhysicsEnv, load


class Cartpole(PhysicsEnv):
    kernel_reward = ("swingup", {})

    def __init__(self, device=DEFAULT):
        sys = load("cartpole", device)
        sys = sys.replace(dt=torch.tensor(0.005, dtype=torch.float32,
                                          device=sys.device))
        super().__init__(sys, n_frames=4)

    def reset(self, generator: torch.Generator) -> State:
        q = self.sys.init_q + self._uniform(generator, self.sys.nq,
                                            -0.01, 0.01)
        q = q + torch.tensor([0.0, math.pi], device=self.device)
        qd = self._uniform(generator, self.sys.nv, -0.01, 0.01)
        return self._state(self.pipeline_init(q, qd))

    def step(self, state: State, action: torch.Tensor) -> State:
        ps = self.pipeline_step(state.pipeline_state, action)
        reward = torch.cos(ps.q[1]) - ps.qd[0].abs()
        return state.replace(pipeline_state=ps, obs=self._obs(ps),
                             reward=reward,
                             done=torch.zeros((), device=self.device))

    @property
    def action_size(self) -> int:
        return 1

    def reward_qs_b(self, qs, qds, us, q0, qd0):
        """Batch-last reward [H, N]: a pure (q, qd) function."""
        return torch.cos(qs[:, 1]) - qds[:, 0].abs()
