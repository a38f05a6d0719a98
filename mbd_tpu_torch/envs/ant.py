"""Ant: quadruped on a free root, forward-velocity reward (port of
``mbd_tpu/envs/ant.py``): reward = forward_velocity + healthy − 0.5·Σu²,
velocity from the torso x displacement over env.dt, healthy = 1 while the
torso z stays in [0.2, 1.0] (done otherwise); obs = [q[2:], qd]; reset
noise ±0.1 on q with the root quaternion kept at its unit init value,
N(0, 0.1) on qd; n_frames=5."""

from __future__ import annotations

import torch

from ..device import DEFAULT
from .base import State
from .physics import PhysicsEnv, load


class Ant(PhysicsEnv):
    z_low, z_high = 0.2, 1.0    # healthy torso height band
    ctrl_cost = 0.5

    def __init__(self, device=DEFAULT):
        super().__init__(load("ant", device), n_frames=5)

    @property
    def kernel_reward(self):
        # (q0 − q0_prev)/dt + healthy(q2) − ctrl_cost·Σu²
        return ("healthy", {"dt": self.dt, "ctrl_cost": self.ctrl_cost,
                            "z_low": self.z_low, "z_high": self.z_high})

    def reset_q(self, generator: torch.Generator):
        q = self.sys.init_q + self._uniform(generator, self.sys.nq, -0.1, 0.1)
        quat = self.sys.init_q[3:7]
        q[3:7] = quat / torch.linalg.norm(quat)
        qd = 0.1 * torch.randn(self.sys.nv, generator=generator,
                               device=self.device)
        return q, qd

    def reset(self, generator: torch.Generator) -> State:
        return self._state(self.pipeline_init(*self.reset_q(generator)))

    def _healthy(self, z: torch.Tensor) -> torch.Tensor:
        return ((z >= self.z_low) & (z <= self.z_high)).to(z.dtype)

    def _velocity(self, x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
        # a tensor divisor: a true division on every device, as JAX divides
        dt = torch.full((), self.dt, dtype=x.dtype, device=x.device)
        return (x - prev) / dt

    def step(self, state: State, action: torch.Tensor) -> State:
        ps0 = state.pipeline_state
        ps = self.pipeline_step(ps0, action)
        velocity = self._velocity(ps.x.pos[0], ps0.x.pos[0])
        healthy = self._healthy(ps.x.pos[0, 2])
        reward = velocity[0] + healthy - self.ctrl_cost * (action * action
                                                           ).sum()
        return state.replace(pipeline_state=ps, obs=self._obs(ps),
                             reward=reward, done=1.0 - healthy)

    def _obs(self, ps) -> torch.Tensor:
        return torch.cat([ps.q[2:], ps.qd])

    def obs_qs_b(self, q, qd):
        """Batch-last _obs: [q[2:], qd] (root x/y excluded)."""
        return torch.cat([q[2:], qd], dim=0)

    def rl_done_qs_b(self, q, qd):
        """step() terminates when unhealthy: torso z = q[2] (free root)."""
        return 1.0 - self._healthy(q[2])

    def reward_qs_b(self, qs, qds, us, q0, qd0):
        """Batch-last reward [H, N]: free root, so the torso position is
        q[0:3]; the previous step's x from the trace (q0 for the first)."""
        prev = torch.cat([q0[0:1], qs[:-1, 0]], dim=0)
        u2 = us * us
        cost = u2[:, 0]
        for k in range(1, u2.shape[1]):
            cost = cost + u2[:, k]
        return (self._velocity(qs[:, 0], prev) + self._healthy(qs[:, 2])
                - self.ctrl_cost * cost)
