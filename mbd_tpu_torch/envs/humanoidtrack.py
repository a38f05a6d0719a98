"""HumanoidTrack: the humanoid tracking a motion-capture clip (port of
``mbd_tpu/envs/humanoidtrack.py``): n_frames=5 at the model's timestep
0.006, a 50-step demo (1.5 s) over 5 tracked bodies (torso, thighs,
shins), rew_xref = 1.0 and a deterministic reset (init_q, zero qd).

``xref`` [5, 50, 3] holds the tracked bodies' demo positions: the jog
clip's 46 frames padded with its last, or frames 70:120 of the walk clip;
``xref_frames`` holds them as [50, 5, 3], as the CUDA kernel reads them.
``state.done`` counts the steps, and ``step`` moves the ``*_ref`` marker
bodies to the demo frame (for viewing only). The reward is taken from the
pre-step state: 1 + (−|vx − 1.6| − |torso_z − 1.3| − 0.1·|torso_y|). The
demo log-density of a rollout is −mean((clip(‖x − xref‖, 0, 0.5)/0.5)²)
over bodies and steps.

The model is a forest: the humanoid's free root and the five ``*_ref``
marker bodies, each on a slide along x, are all children of the world.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..device import DEFAULT
from ..sim import batched as BT
from .base import State
from .physics import SNAPSHOT_DIR, PhysicsEnv, load

TRACK_BODIES = ("torso", "left_thigh", "right_thigh", "left_shin",
                "right_shin")
CLIPS = ("jog", "walk")


def clip_path(mode: str) -> str:
    """The port's copy of a demo clip: the tracked bodies' positions per
    frame (written by ``python -m mbd_tpu_torch.envs.physics``)."""
    return os.path.join(SNAPSHOT_DIR, f"{mode}_xref.npz")


class HumanoidTrack(PhysicsEnv):
    model = "humanoidtrack"
    H = 50                  # demo frames, one per env step
    rew_xref = 1.0          # the demo's log-weight bias in the planner
    v_target = 1.6          # torso x velocity the reward centres on
    z_target = 1.3          # torso height the reward centres on

    def __init__(self, mode: str = "jog", device=DEFAULT):
        super().__init__(load(self.model, device), n_frames=5)
        links = self.sys.link_names
        self.track_link_idx = tuple(links.index(n) for n in TRACK_BODIES)
        self.ref_link_idx = tuple(links.index(n + "_ref")
                                  for n in TRACK_BODIES)
        xref = []
        with np.load(clip_path(mode)) as demo:
            for name in TRACK_BODIES:
                x = demo[name]
                if len(x) < self.H:
                    x = np.concatenate(
                        [x, np.tile(x[-1:], (self.H - len(x), 1))], axis=0)
                else:
                    x = x[70:70 + self.H]
                xref.append(x)
        self.xref = torch.from_numpy(np.stack(xref)).to(self.device)
        # the same frames in the rollout kernel's layout [50, 5, 3]
        self.xref_frames = self.xref.transpose(0, 1).contiguous()

    @property
    def track_body_ids(self):
        """The tracked bodies' ids (body 0 is the world)."""
        return tuple(i + 1 for i in self.track_link_idx)

    @property
    def kernel_reward(self):
        # 1 + (−|qd0_prev − v_target| − |q2_prev − z_target| − 0.1·|q1_prev|)
        return ("track", {"z_target": self.z_target,
                          "v_target": self.v_target})

    def reset(self, generator: torch.Generator) -> State:
        del generator  # deterministic
        q = self.sys.init_q.clone()
        qd = torch.zeros(self.sys.nv, device=self.device)
        ps = self.pipeline_init(q, qd)
        zero = torch.zeros((), device=self.device)
        return State(ps, self._obs(ps), zero, zero,
                     metrics={"reward_linup": zero, "reward_quadctrl": zero})

    def step(self, state: State, action: torch.Tensor) -> State:
        ps = self.pipeline_step(state.pipeline_state, action)
        # the marker bodies show the demo frame; past its end, the last
        t = min(int(state.done), self.H - 1)
        pos = ps.x.pos.clone()
        for i, link in enumerate(self.ref_link_idx):
            pos[link] = self.xref[i, t]
        ps = dataclasses.replace(ps, x=dataclasses.replace(ps.x, pos=pos))
        return state.replace(pipeline_state=ps, obs=self._obs(ps),
                             reward=self._reward(state.pipeline_state),
                             done=state.done + 1)

    def _reward(self, ps) -> torch.Tensor:
        return self.torso_reward(ps.xd.vel[0, 0], ps.x.pos[0, 1],
                                 ps.x.pos[0, 2])

    def torso_reward(self, vx, y, z):
        return 1.0 + (-(vx - self.v_target).abs()
                      - (z - self.z_target).abs() - 0.1 * y.abs())

    def reward_qs_b(self, qs, qds, us, q0, qd0):
        """Batch-last reward [H, N] from the pre-step states (free root:
        torso position q[0:3], torso x velocity qd[0])."""
        qp = torch.cat([q0[None], qs[:-1]])
        qdp = torch.cat([qd0[None], qds[:-1]])
        return self.torso_reward(qdp[:, 0], qp[:, 1], qp[:, 2])

    def track_xpos_b(self, q: torch.Tensor) -> torch.Tensor:
        """The tracked bodies' world positions [5, 3, N] from batch-last
        q [nq, N] (one FK pass)."""
        kin = BT.fk_b(self.sys, q)
        return torch.stack([kin.xpos[b] for b in self.track_body_ids])

    def traj_xref_logpd_qs(self, qs: torch.Tensor) -> torch.Tensor:
        """The demo log-density [N] of each sample's position trace
        qs [H, nq, N], through one FK pass over every (sample, step)."""
        H, nq, N = qs.shape
        q_flat = qs.permute(1, 2, 0).reshape(nq, N * H)
        xs = self.track_xpos_b(q_flat).reshape(len(TRACK_BODIES), 3, N, H)
        xs = xs.permute(0, 2, 3, 1)                       # [5, N, H, 3]
        err = torch.linalg.norm(xs - self.xref[:, None, :H], dim=-1)
        return -((torch.clamp(err, 0.0, 0.5) / 0.5) ** 2).mean(dim=(0, 2))
