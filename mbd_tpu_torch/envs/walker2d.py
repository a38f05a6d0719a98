"""Walker2d: planar biped, forward-progress reward (port of
``mbd_tpu/envs/walker2d.py``): hopper's env on the walker2d model,
n_frames=20, reset noise ±5e-3,
reward = torso_x − 0.5·clip(|torso_z − 1.1|, −1, 1)."""

from __future__ import annotations

from .hopper import Hopper


class Walker2d(Hopper):
    model = "walker2d"
    z_target = 1.1
