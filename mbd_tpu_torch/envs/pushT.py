"""PushT: planar pushing of a T-shaped slider to a randomized goal pose
(port of ``mbd_tpu/envs/pushT.py``): n_frames=5, gravity off; reset pins
the pusher at (0.1, −0.15) and draws the goal pose around (−0.4, 0.4, π)
± (0.2, 0.2, π/4), with qd 0; reward = 1 − ((‖r_goal − r_slider‖ +
|Δθ|/π) + max(‖pusher − slider‖ − 0.2, 0)); done = reward > 0.95;
obs = [q, qd] (16-dim).

q holds the pusher's (x, y) slides, the slider's (x, y, θ) and the goal's
(x, y, θ). The pusher is a sphere and the slider's two bars are boxes:
the model's two sphere–box contact pairs.
"""

from __future__ import annotations

import math

import torch

from ..device import DEFAULT
from ..sim import batched as BT
from .base import State
from .physics import PhysicsEnv, load

# |Δθ|/π as JAX's compiled reward forms it: times the float32 reciprocal
INV_PI = BT.recip32(BT.f32(math.pi))


class PushT(PhysicsEnv):
    model = "pushT"
    kernel_reward = ("push", {})
    pusher_start = (0.1, -0.15)
    goal_centre = (-0.4, 0.4, math.pi)
    goal_spread = (0.2, 0.2, math.pi / 4)
    success = 0.95          # reward above which an episode is done

    def __init__(self, device=DEFAULT):
        super().__init__(load(self.model, device), n_frames=5)

    def reset(self, generator: torch.Generator) -> State:
        q = self.sys.init_q.clone()
        q[:2] = torch.tensor(self.pusher_start, device=self.device)
        u = torch.rand(3, generator=generator, device=self.device)
        goal = (u * 2.0 - 1.0) * torch.tensor(
            self.goal_spread, device=self.device) + torch.tensor(
            self.goal_centre, device=self.device)
        q[5:] = goal
        qd = torch.zeros(self.sys.nv, device=self.device)
        ps = self.pipeline_init(q, qd)
        return State(ps, self._obs(ps), self._reward(ps), self._done(ps))

    def step(self, state: State, action: torch.Tensor) -> State:
        ps = self.pipeline_step(state.pipeline_state, action)
        return state.replace(pipeline_state=ps, obs=self._obs(ps),
                             reward=self._reward(ps), done=self._done(ps))

    def _reward(self, ps) -> torch.Tensor:
        q = ps.q[None, :, None]
        return self.reward_qs_b(q, None, None, None, None)[0, 0]

    def _done(self, ps) -> torch.Tensor:
        return (self._reward(ps) > self.success).to(ps.q.dtype)

    @property
    def action_size(self) -> int:
        return 2

    @property
    def observation_size(self) -> int:
        return 16

    def rl_done_qs_b(self, q, qd):
        """step() terminates on success: reward > 0.95 (_done)."""
        r = self.reward_qs_b(q[None], qd[None], None, q, qd)[0]
        return (r > self.success).to(q.dtype)

    def reward_qs_b(self, qs, qds, us, q0, qd0):
        """Batch-last reward [H, N]: a pure function of the post-step q."""
        def dist(a, b):
            dx = qs[:, a] - qs[:, b]
            dy = qs[:, a + 1] - qs[:, b + 1]
            return torch.sqrt(dx * dx + dy * dy)

        d_goal = dist(5, 2)
        d_theta = (qs[:, 7] - qs[:, 4]).abs() * INV_PI
        d_ps = torch.clamp_min(dist(0, 2) - 0.2, 0.0)
        return 1.0 - ((d_goal + d_theta) + d_ps)
