"""humanoidrun: n_frames 7, reset noise ±0.01, reward torso_x −
clip(|torso_z − 1.3|, −1, 1) − 0.1·|torso_y| with the torso at q[0:3]
(a free root)."""

import torch

N_FRAMES = 7
RESET_NOISE = 0.01
Z_TARGET = 1.3


def reward(qs: torch.Tensor) -> torch.Tensor:
    """qs [H, nq, N] → [H, N]."""
    x, y, z = qs[:, 0], qs[:, 1], qs[:, 2]
    return x - torch.clamp((z - Z_TARGET).abs(), -1.0, 1.0) - 0.1 * y.abs()
