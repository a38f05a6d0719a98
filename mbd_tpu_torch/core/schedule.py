"""DDPM-style variance schedule for the MBD planner (port of
``mbd_tpu/core/schedule.py``): linear betas in [beta0, betaT] over
Ndiffuse steps, alphas_bar = cumprod(1 − beta), sigmas = sqrt(1 −
alphas_bar). ``sigmas_cond`` is kept for parity; the reverse update is a
deterministic mean update and never reads it. Everything is float32, the
linspace formed as ``jnp.linspace`` forms it.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..device import DEFAULT, resolve


@dataclass(frozen=True)
class DiffusionSchedule:
    betas: torch.Tensor
    alphas: torch.Tensor
    alphas_bar: torch.Tensor
    sigmas: torch.Tensor
    sigmas_cond: torch.Tensor


def _linspace(start: float, stop: float, num: int,
              device) -> torch.Tensor:
    """float32 ``start·(1 − s) + stop·s`` with s = k/(num − 1), the last
    entry exactly ``stop``."""
    f = dict(dtype=torch.float32, device=device)
    lo, hi = torch.tensor(start, **f), torch.tensor(stop, **f)
    if num == 1:
        return lo[None]
    step = torch.arange(num - 1, **f) / float(num - 1)
    return torch.cat([lo * (1 - step) + hi * step, hi[None]])


def make_schedule(num_steps: int, beta0: float = 1e-4, betaT: float = 1e-2,
                  device=DEFAULT) -> DiffusionSchedule:
    device = resolve(device)
    betas = _linspace(beta0, betaT, num_steps, device)
    alphas = 1.0 - betas
    alphas_bar = torch.cumprod(alphas, dim=0)
    sigmas = torch.sqrt(1.0 - alphas_bar)
    sig2_cond = (1.0 - alphas) * (1.0 - torch.sqrt(
        torch.roll(alphas_bar, 1))) / (1.0 - alphas_bar)
    sigmas_cond = torch.sqrt(sig2_cond)
    sigmas_cond[0] = 0.0
    return DiffusionSchedule(betas, alphas, alphas_bar, sigmas, sigmas_cond)
