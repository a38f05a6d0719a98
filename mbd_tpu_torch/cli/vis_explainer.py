"""Explainer animation: model-free vs model-based diffusion (port of
``mbd_tpu/cli/vis_explainer.py``, a matplotlib re-telling of the
reference's manim animation, mbd/scripts/vis_manim.py:6-430), in three
acts:

  1. Standard model-free diffusion: the score field is learned purely from
     demonstrations (trajectories skirting an obstacle); forward noising
     destroys them, the learned field denoises back to the demo manifold.
  2. The model changes (obstacle grows): the learned score cannot adapt —
     denoised trajectories now collide with the larger obstacle.
  3. Model-based diffusion: the score is computed from the *model*
     (dynamics + constraint) by Monte-Carlo rollouts, so samples denoise
     to trajectories that respect the new constraint with no retraining.

The numerics (``demo_traj``, ``noising_path``, ``score_field``,
``_model_traj``) are float64 tensors on a given device, their noise from
an explicit ``torch.Generator`` or given; matplotlib is imported only to
draw. Renders an animated GIF (Pillow writer) or a static three-panel
PNG:

  python -m mbd_tpu_torch.cli.vis_explainer --out results/explainer.gif
  python -m mbd_tpu_torch.cli.vis_explainer --static --out e.png --device cpu
"""

from __future__ import annotations

import argparse
import math
import os
from typing import List, Optional

import numpy as np
import torch

from ..device import DEFAULT, resolve

NPTS = 20          # points per trajectory polyline (vis_manim.py:117)
SCALES = (1.0, 1.3, -1.1, -1.25)   # demo trajectory family (vis_manim.py:116)
R0 = 0.5           # obstacle radius (vis_manim.py:20)
RSCALE = 1.8       # act-2 obstacle growth (vis_manim.py:153)
F64 = torch.float64


def demo_traj(scale: float, r_block: Optional[float] = None,
              device=DEFAULT) -> torch.Tensor:
    """Demo trajectory [NPTS, 2], x = scale·0.5·cos(y/3·π); if ``r_block``
    is given, the segment that would enter the grown obstacle clamped to
    its boundary (the "would hit the obstacle" geometry of
    vis_manim.py:174-183). On ``device``, the card unless the CPU is asked
    for."""
    ys = torch.linspace(-1.5, 1.5, NPTS, dtype=F64, device=resolve(device))
    xs = scale * 0.5 * torch.cos(ys / 3.0 * math.pi)
    if r_block is not None:
        mask = ys > -r_block * math.cos(math.pi / 6)
        edge = r_block * math.sin(math.pi / 6)
        xs = torch.where(mask & (xs > 0), torch.full_like(xs, edge), xs)
        xs = torch.where(mask & (xs < 0), torch.full_like(xs, -edge), xs)
        ys = torch.where(mask, torch.full_like(
            ys, -r_block * math.cos(math.pi / 6)), ys)
    return torch.stack([xs, ys], dim=1)


def noising_path(xys: torch.Tensor, n_steps: int,
                 generator: Optional[torch.Generator] = None,
                 normals: Optional[torch.Tensor] = None
                 ) -> List[torch.Tensor]:
    """Forward DDPM noising of a point cloud, returned reversed so frame 0
    is pure noise and the last frame is the clean trajectory
    (vis_manim.py:112-126). Step k's standard normals are
    ``normals[k]`` [n_steps, *xys.shape] when given, else drawn from
    ``generator``."""
    betas = np.linspace(1e-3, 1e-1, n_steps)
    out = [xys]
    for k, beta in enumerate(betas):
        a = 1.0 - beta
        z = normals[k] if normals is not None else torch.randn(
            xys.shape, generator=generator, dtype=F64, device=xys.device)
        xys = torch.clamp(xys * math.sqrt(a) + z * math.sqrt(1 - a),
                          -1.9, 1.9)
        out.append(xys)
    return out[::-1]


def score_field(grid_xy: torch.Tensor, r_ell: tuple = (0.6, 1.5)
                ) -> torch.Tensor:
    """The demo-manifold score field [..., 2] at grid_xy [..., 2]: points
    inside the ellipse push out, outside push in (vis_manim.py:44-51)."""
    x, y = grid_xy[..., 0], grid_xy[..., 1]
    val = (x / r_ell[0]) ** 2 + (y / r_ell[1]) ** 2 - 1.0
    vec = 0.2 * torch.stack([x / r_ell[0], y / r_ell[1]], dim=-1)
    return torch.where(val[..., None] < 0, vec, -vec)


def _model_traj(scale: float, r: float, device=DEFAULT) -> torch.Tensor:
    """Constraint-respecting trajectory the model-based score finds: the
    demo shape pushed outside the grown obstacle (feasible under ‖x‖≥r)."""
    t = demo_traj(scale, device=device)
    d = torch.linalg.norm(t, dim=1, keepdim=True)
    push = torch.clamp_min((r + 0.08) / torch.clamp_min(d, 1e-6), 1.0)
    return t * push


def build_frames(n_steps: int, generator: torch.Generator):
    """(act, cloud) per animation frame across the three acts, each cloud
    the four noised trajectories [NPTS, 2] on the generator's device."""
    device = generator.device
    grown = R0 * RSCALE
    acts = [
        (1, [noising_path(demo_traj(s, device=device), n_steps, generator)
             for s in SCALES]),
        (2, [noising_path(demo_traj(s, r_block=grown, device=device),
                          n_steps, generator) for s in SCALES]),
        (3, [noising_path(_model_traj(s, grown, device=device), n_steps,
                          generator) for s in SCALES]),
    ]
    frames = []
    for act, paths in acts:
        for t in range(n_steps + 1):
            frames.append((act, [p[t] for p in paths]))
        frames.extend([(act, [p[-1] for p in paths])] * max(n_steps // 6, 2))
    return frames


def _panel(ax, title: str, r_obs: float):
    import matplotlib.patches as mpatches

    ax.set_xlim(-2, 2)
    ax.set_ylim(-2, 2)
    ax.set_aspect("equal")
    ax.set_xticks([])
    ax.set_yticks([])
    ax.set_title(title, fontsize=11)
    ax.add_patch(mpatches.Circle((0, 0), r_obs, color="#4477cc", zorder=3))


def _draw_act(axes, act: int, frame_cloud=None):
    """Draw one act's static content; ``frame_cloud`` is the current
    scatter state of the four noised trajectories (list of [NPTS, 2])."""
    import matplotlib.pyplot as plt

    axL, axR = axes
    axL.clear(), axR.clear()
    r_obs = R0 * (RSCALE if act == 2 else 1.0)
    grown = R0 * RSCALE
    if act < 3:
        _panel(axL, "Demonstrations", r_obs)
        for s in SCALES + tuple(-s for s in SCALES):
            t = demo_traj(s, device="cpu").numpy()
            axL.plot(t[:, 0], t[:, 1], color="#cc3344", lw=1.2, zorder=2)
        _panel(axR, "Diffusion process (learned score)", r_obs)
        g = torch.stack(torch.meshgrid(
            torch.linspace(-1.8, 1.8, 13, dtype=F64),
            torch.linspace(-1.8, 1.8, 13, dtype=F64), indexing="xy"), dim=-1)
        v = score_field(g).numpy()
        g = g.numpy()
        axR.quiver(g[..., 0], g[..., 1], v[..., 0], v[..., 1],
                   color="#cc3344", alpha=0.35, scale=6, width=3e-3)
    else:
        _panel(axL, "Model", r_obs)
        axL.text(0, 0.9, r"$\dot{x} = u$", ha="center", fontsize=16)
        axL.text(0, -1.2, r"s.t. $\|x\|_2 \geq %.1f$" % grown,
                 ha="center", fontsize=14)
        _panel(axR, "Diffusion with model-based score", r_obs)
    caption = {
        1: "Standard diffusion learns the score only from demonstrations.",
        2: "When the model changes (larger obstacle), the learned score\n"
           "cannot adapt: denoised trajectories hit the obstacle.",
        3: "Model-based diffusion computes the score from the model by\n"
           "Monte-Carlo rollouts — no data, adapts to the new constraint.",
    }[act]
    fig = axR.figure
    fig.suptitle("Standard Model-Free Diffusion" if act < 3
                 else "Model-Based Diffusion", fontsize=14)
    for t in list(fig.texts):
        if t is not fig._suptitle:
            t.remove()
    fig.text(0.5, 0.02, caption, ha="center", fontsize=9)
    if frame_cloud is not None:
        colors = plt.cm.Reds(np.linspace(0.25, 1.0, NPTS))
        for xys in frame_cloud:
            xys = xys.cpu().numpy()
            axR.scatter(xys[:, 0], xys[:, 1], c=colors, s=14, zorder=4)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default="results/explainer.gif")
    p.add_argument("--steps", type=int, default=24,
                   help="noising steps per act (frames ≈ 3×(steps+hold))")
    p.add_argument("--fps", type=int, default=12)
    p.add_argument("--static", action="store_true",
                   help="render a 3-panel PNG summary instead of a GIF")
    p.add_argument("--device", default=DEFAULT)
    args = p.parse_args(argv)
    device = resolve(args.device)
    frames = build_frames(args.steps, torch.Generator(device).manual_seed(0))

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)

    if args.static:
        fig, axes = plt.subplots(3, 2, figsize=(8, 12))
        for act in (1, 2, 3):
            cloud = next(c for a, c in reversed(frames) if a == act)
            _draw_act(axes[act - 1], act, cloud)
        fig.suptitle("Model-based diffusion explainer", fontsize=14)
        fig.savefig(args.out, dpi=110)
        print(f"saved {args.out}")
        return args.out

    from matplotlib.animation import FuncAnimation, PillowWriter
    fig, axes = plt.subplots(1, 2, figsize=(9, 5.2))
    fig.subplots_adjust(bottom=0.12)

    def update(i):
        act, cloud = frames[i]
        _draw_act(axes, act, cloud)
        return []

    anim = FuncAnimation(fig, update, frames=len(frames), blit=False)
    anim.save(args.out, writer=PillowWriter(fps=args.fps))
    print(f"saved {args.out} ({len(frames)} frames)")
    return args.out


if __name__ == "__main__":
    main()
