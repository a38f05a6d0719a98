"""HumanoidStandup: the humanoid starting supine (torso z = 0.15),
stand-up reward (port of ``mbd_tpu/envs/humanoidstandup.py``): humanoidrun's
env on the humanoidstandup model, n_frames=7, reset noise ±0.01,
reward = 1.5 − clip(|torso_z − 1.3|, −2, 1) − 0.1·|torso_x|
− 0.1·|torso_y|."""

from __future__ import annotations

import torch

from .humanoidrun import HumanoidRun


class HumanoidStandup(HumanoidRun):
    model = "humanoidstandup"
    kernel_group = 8        # its plans run at N = 2048 (PhysicsEnv)

    @property
    def kernel_reward(self):
        # 1.5 − clip(|q2 − z_target|, −2, 1) − 0.1·|q0| − 0.1·|q1|
        return ("standup", {"z_target": self.z_target})

    def torso_reward(self, x, y, z):
        return (1.5 - torch.clamp((z - self.z_target).abs(), -2.0, 1.0)
                - 0.1 * x.abs() - 0.1 * y.abs())
