"""Each configuration's model for the reference, found by the
configuration's ``env`` name: ``models/<env>.py`` gives ``N_FRAMES``,
``RESET_NOISE`` and ``reward(qs)`` (copies of the port's env of that name
at commit f68a38a); the model itself is read from its snapshot,
``mbd_tpu_torch/assets/<env>.npz``, a raw file that the program reads
too."""

from __future__ import annotations

import importlib
import os
from dataclasses import dataclass
from typing import Callable

import torch

from ..system import System, load_npz

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
SNAPSHOTS = os.path.join(ROOT, "mbd_tpu_torch", "assets")


@dataclass
class Model:
    sys: System
    n_frames: int
    reset_noise: float
    reward: Callable[[torch.Tensor], torch.Tensor]

    def reset(self, generator: torch.Generator):
        """The reset's (q [nq], qd [nv]): uniform noise of ±reset_noise
        on the initial q and on zero velocities, drawn q first."""
        lo, hi = -self.reset_noise, self.reset_noise
        device = self.sys.device

        def uniform(n):
            u = torch.rand(n, generator=generator, device=device)
            return u * (hi - lo) + lo

        q = self.sys.init_q + uniform(self.sys.nq)
        return q, uniform(self.sys.nv)


def load(env: str, device) -> Model:
    spec = importlib.import_module(f"{__name__}.{env}")
    sys = load_npz(os.path.join(SNAPSHOTS, f"{env}.npz"), device)
    return Model(sys, spec.N_FRAMES, spec.RESET_NOISE, spec.reward)
