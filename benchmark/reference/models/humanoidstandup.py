"""humanoidstandup: n_frames 7, reset noise ±0.01, reward 1.5 −
clip(|torso_z − 1.3|, −2, 1) − 0.1·|torso_x| − 0.1·|torso_y| with the
torso at q[0:3] (a free root, lying on its back at z = 0.15 in the
model's initial q)."""

import torch

N_FRAMES = 7
RESET_NOISE = 0.01
Z_TARGET = 1.3


def reward(qs: torch.Tensor) -> torch.Tensor:
    """qs [H, nq, N] → [H, N]."""
    x, y, z = qs[:, 0], qs[:, 1], qs[:, 2]
    return (1.5 - torch.clamp((z - Z_TARGET).abs(), -2.0, 1.0)
            - 0.1 * x.abs() - 0.1 * y.abs())
