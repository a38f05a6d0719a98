"""Car2d: analytic Dubins-style 2D navigation among circular obstacles
(port of ``mbd_tpu/envs/car2d.py``).

 - state x = (px, py, θ); controls u = (steer, throttle) in [−1, 1];
 - ẋ = 3·u1·sin θ, ẏ = 3·u1·cos θ, θ̇ = (2π/3)·u0, integrated by RK4 at
   dt = 0.1;
 - 11 obstacles of radius 0.3 in a U-shaped wall; a step that would end
   inside one is rejected and the state stays where it was;
 - reward = 1 − (clip(‖p − goal‖, 0, 0.2)/0.2)²;
 - the demo is an RRT path of 50 (x, y) waypoints
   (``assets/car2d_xref.npy``), scored by ``eval_xref_logpd``.

Every function takes states and controls with any leading batch shape
(``x[..., 3]``, ``u[..., 2]``), so N samples step as one batch. The env has
no physics engine: the planners roll it out with ``rollout/rollout.py``'s
``rollout_us``, as JAX's vmap engine does.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from ..device import DEFAULT, resolve
from .base import Env, State

XREF_PATH = os.path.join(os.path.dirname(__file__), "..", "assets",
                         "car2d_xref.npy")


def _dynamics(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    sin_t, cos_t = torch.sin(x[..., 2]), torch.cos(x[..., 2])
    return torch.stack([
        3.0 * u[..., 1] * sin_t,
        3.0 * u[..., 1] * cos_t,
        u[..., 0] * (2.0 * math.pi / 3.0),
    ], dim=-1)


def _rk4(x: torch.Tensor, u: torch.Tensor, dt: float) -> torch.Tensor:
    k1 = _dynamics(x, u)
    k2 = _dynamics(x + 0.5 * dt * k1, u)
    k3 = _dynamics(x + 0.5 * dt * k2, u)
    k4 = _dynamics(x + dt * k3, u)
    return x + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


def _norm(d: torch.Tensor) -> torch.Tensor:
    """‖d‖ over the last axis, as ``jnp.linalg.norm`` forms it."""
    return torch.sqrt((d * d).sum(dim=-1))


class Car2d(Env):
    def __init__(self, device=DEFAULT):
        self._device = resolve(device)
        self.dt = 0.1
        self.H = 50
        r = 0.3
        self.obs_radius = r
        # the U-shaped wall of obstacle centres: top row, right column,
        # bottom row
        top = [(-3 * r, 2 * r), (-2 * r, 2 * r), (-1 * r, 2 * r),
               (0.0, 2 * r)]
        right = [(0.0, r), (0.0, 0.0), (0.0, -r)]
        bottom = [(-3 * r, -2 * r), (-2 * r, -2 * r), (-1 * r, -2 * r),
                  (0.0, -2 * r)]

        def tensor(values):
            return torch.tensor(values, dtype=torch.float32,
                                device=self._device)

        self.obs_center = tensor(top + right + bottom)
        self.x0 = tensor([-0.5, 0.0, 1.5 * math.pi])
        self.xg = tensor([0.5, 0.0, 0.0])
        self.xref = torch.from_numpy(np.load(XREF_PATH).astype(
            np.float32)).to(self._device)
        self.rew_xref = self._reward(self.xref).mean()

    @property
    def device(self) -> torch.device:
        return self._device

    # -- dynamics -----------------------------------------------------------

    def _reward(self, q: torch.Tensor) -> torch.Tensor:
        dist = _norm(q[..., :2] - self.xg[:2])
        return 1.0 - (torch.clamp(dist, 0.0, 0.2) / 0.2) ** 2

    def reset(self, generator: torch.Generator) -> State:
        """The fixed start x0; draws nothing from ``generator``."""
        zero = torch.zeros((), device=self._device)
        return State(self.x0, self.x0, zero, zero)

    def step(self, state: State, action: torch.Tensor) -> State:
        x = state.pipeline_state
        u = torch.clamp(action, -1.0, 1.0)
        q_new = _rk4(x, u, self.dt)
        dists = _norm(q_new[..., None, :2] - self.obs_center)
        collide = (dists < self.obs_radius).any(dim=-1)
        q = torch.where(collide[..., None], x, q_new)
        return state.replace(pipeline_state=q, obs=q, reward=self._reward(q),
                             done=torch.zeros_like(q[..., 0]))

    # -- demo conditioning --------------------------------------------------

    def eval_xref_logpd(self, xs: torch.Tensor) -> torch.Tensor:
        """The tracking log-density surrogate of rollouts xs [..., H, 3]:
        minus the mean over H of (clip(‖p − p_ref‖, 0, 0.5)/0.5)²."""
        err = _norm(xs[..., :2] - self.xref[:xs.shape[-2], :2])
        return -((torch.clamp(err, 0.0, 0.5) / 0.5) ** 2).mean(dim=-1)

    # -- sizes and rendering ------------------------------------------------

    @property
    def action_size(self) -> int:
        return 2

    @property
    def observation_size(self) -> int:
        return 3

    def render(self, ax, xs, show_demo: bool = True):
        """Top-down scene on a matplotlib axis: the wall, start and goal,
        the RRT demo path if ``show_demo``, and the rollout xs [T, 3]
        coloured by time."""
        from matplotlib.collections import PatchCollection
        from matplotlib.patches import Circle

        wall = PatchCollection(
            [Circle(c, self.obs_radius)
             for c in self.obs_center.cpu().numpy()],
            facecolor="0.35", edgecolor="none", zorder=1)
        ax.add_collection(wall)
        if show_demo:
            ref = self.xref.cpu().numpy()
            ax.plot(ref[:, 0], ref[:, 1], ls="--", lw=1.2, color="tab:blue",
                    zorder=2, label="RRT demo")
        xs = np.asarray(torch.as_tensor(xs).cpu())
        pts = ax.scatter(xs[:, 0], xs[:, 1], c=np.arange(len(xs)),
                         cmap="viridis", s=14, zorder=3, label="plan (t →)")
        ax.plot(*self.x0[:2].cpu().numpy(), marker="s", color="tab:green",
                ms=9, zorder=4, label="start")
        ax.plot(*self.xg[:2].cpu().numpy(), marker="*", color="tab:red",
                ms=14, zorder=4, label="goal")
        ax.set(xlim=(-2, 2), ylim=(-2, 2), aspect="equal")
        ax.legend(loc="lower right", fontsize=8)
        return pts
