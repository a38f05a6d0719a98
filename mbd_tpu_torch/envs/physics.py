"""PhysicsEnv: base class for engine-backed environments (port of
``mbd_tpu/envs/physics.py``). ``step`` runs the batch-last engine at N=1.

The envs load their models from compiled snapshots
(``mbd_tpu_torch/assets/<model>.npz``) and humanoidtrack its demo clips
from copies beside them (``<clip>_xref.npz``), so a machine without MuJoCo
runs the port. The snapshots are MuJoCo's compile of the reference
package's MJCF files; rewrite them and the clips after a change with

    python -m mbd_tpu_torch.envs.physics
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from ..device import DEFAULT
from ..sim import batched as BT
from ..sim.system import System, load_mjcf, load_npz, save_npz
from .base import Env, State

# the MJCF assets ship with the reference package
ASSET_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "mbd_tpu",
                         "assets")
SNAPSHOT_DIR = os.path.join(os.path.dirname(__file__), "..", "assets")
MODELS = ("hopper", "walker2d", "halfcheetah", "cartpole", "ant",
          "humanoidrun", "humanoidstandup", "humanoidtrack", "pushT")


def asset_path(name: str) -> str:
    return os.path.join(ASSET_DIR, name)


@dataclass
class X:
    pos: torch.Tensor   # (nlink, 3)
    rot: torch.Tensor   # (nlink, 4)


@dataclass
class Xd:
    vel: torch.Tensor   # (nlink, 3) velocity of the body-frame origin
    ang: torch.Tensor   # (nlink, 3)


@dataclass
class PipelineState:
    q: torch.Tensor     # (nq,)
    qd: torch.Tensor    # (nv,)
    x: X
    xd: Xd


def make_state(sys: System, q: torch.Tensor,
               qd: torch.Tensor) -> PipelineState:
    out = BT.link_out_b(sys, q[:, None], qd[:, None])

    def links(rows):
        return torch.stack([r[:, 0] for r in rows[1:]])

    return PipelineState(q=q, qd=qd,
                         x=X(pos=links(out.xpos), rot=links(out.xquat)),
                         xd=Xd(vel=links(out.vel), ang=links(out.ang)))


class PhysicsEnv(Env):
    # lanes per sample of the CUDA rollout kernel (ops/rollout_cuda.py):
    # 8 was the fastest at every planning path's shape on an H100 but
    # humanoidrun's (PERF.md, PR 5)
    kernel_group = 8

    def __init__(self, sys: System, n_frames: int):
        self.sys = sys
        self.n_frames = n_frames

    @property
    def device(self) -> torch.device:
        return self.sys.device

    @property
    def dt(self) -> float:
        return float(self.sys.host("dt")) * self.n_frames

    @property
    def action_size(self) -> int:
        return self.sys.nu

    def pipeline_init(self, q: torch.Tensor,
                      qd: torch.Tensor) -> PipelineState:
        return make_state(self.sys, q, qd)

    def pipeline_step(self, ps: PipelineState,
                      action: torch.Tensor) -> PipelineState:
        q, qd = BT.env_step_b(self.sys, ps.q[:, None], ps.qd[:, None],
                              action.to(ps.q.dtype)[:, None], self.n_frames)
        return make_state(self.sys, q[:, 0], qd[:, 0])

    def _uniform(self, generator, n, lo, hi) -> torch.Tensor:
        u = torch.rand(n, generator=generator, device=self.device)
        return u * (hi - lo) + lo

    def _state(self, ps: PipelineState, reward=0.0) -> State:
        zero = torch.zeros((), device=self.device)
        return State(ps, self._obs(ps), zero + reward, zero)

    def _obs(self, ps: PipelineState) -> torch.Tensor:
        return torch.cat([ps.q, ps.qd])

    # --- batch-last interface (rollout/fused.py, the CUDA kernel) ---

    def obs_qs_b(self, q: torch.Tensor, qd: torch.Tensor) -> torch.Tensor:
        """Observation [obs, N] from batch-last q [nq, N] / qd [nv, N]."""
        return torch.cat([q, qd], dim=0)


def snapshot_path(model: str) -> str:
    return os.path.join(SNAPSHOT_DIR, f"{model}.npz")


def load(model: str, device=DEFAULT) -> System:
    """The compiled model ``model`` (an MJCF name without ``.xml``)."""
    return load_npz(snapshot_path(model), device=device)


def write_snapshots() -> None:
    """Compile every served model's MJCF with MuJoCo and save it, and copy
    the tracked bodies' positions out of each demo clip."""
    from .humanoidtrack import CLIPS, TRACK_BODIES, clip_path

    os.makedirs(SNAPSHOT_DIR, exist_ok=True)
    for model in MODELS:
        save_npz(load_mjcf(asset_path(f"{model}.xml"), device="cpu"),
                 snapshot_path(model))
    for mode in CLIPS:
        with np.load(asset_path(f"{mode}_xref.npz")) as demo:
            np.savez(clip_path(mode), **{b: demo[b] for b in TRACK_BODIES})


if __name__ == "__main__":
    write_snapshots()
