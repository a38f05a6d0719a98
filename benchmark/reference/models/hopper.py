"""hopper: n_frames 20, reset noise ±5e-3, reward torso_x −
0.5·clip(|torso_z − 1|, −1, 1) with the torso's (x, z) = (q0, q1)."""

import torch

N_FRAMES = 20
RESET_NOISE = 5e-3
Z_TARGET = 1.0


def reward(qs: torch.Tensor) -> torch.Tensor:
    """qs [H, nq, N] → [H, N]."""
    return qs[:, 0] - 0.5 * torch.clamp((qs[:, 1] - Z_TARGET).abs(),
                                        -1.0, 1.0)
