# %% [markdown]
# # Model-Based Diffusion in 1-D
#
# Port of ``mbd_tpu/notebooks/demo_1d.py`` (the reference's
# mbd/notebooks/01_1d_demo.py): a double-well objective, the forward
# noising process evolving the target density toward a Gaussian, and the
# reverse process recovered by Monte-Carlo score ascent — the same update
# the trajectory planner applies per diffusion step. The numerics are
# float64 tensors; matplotlib is imported only to draw.
#
#   python -m mbd_tpu_torch.notebooks.demo_1d [--out results/demo_1d.png]
#       [--device cpu]

# %%
from __future__ import annotations

import argparse
import math
import os

import torch

from ..device import DEFAULT, resolve

F64 = torch.float64


def objective(y):
    """Double well with asymmetric depths: global optimum near y = +0.6."""
    return -(y ** 2 - 0.36) ** 2 + 0.3 * y


def target_density(y: torch.Tensor, temp: float = 0.05) -> torch.Tensor:
    p = torch.exp(objective(y) / temp)
    return p / torch.trapezoid(p, y)


def schedule(n_steps: int, device=DEFAULT):
    """(alphas, alphas_bar, sigmas) of linear betas in [1e-4, 2e-2], on
    ``device`` (the card unless the CPU is asked for)."""
    betas = torch.linspace(1e-4, 2e-2, n_steps, dtype=F64,
                           device=resolve(device))
    alphas = 1 - betas
    alphas_bar = torch.cumprod(alphas, dim=0)
    return alphas, alphas_bar, torch.sqrt(1 - alphas_bar)


# %% forward process: p_i(y) = ∫ N(y; sqrt(ᾱ_i) y0, 1-ᾱ_i) p0(y0) dy0
def forward_densities(y: torch.Tensor, p0: torch.Tensor,
                      alphas_bar: torch.Tensor) -> torch.Tensor:
    """The density p_i on the grid y for each ᾱ_i: [len(alphas_bar),
    len(y)]."""
    out = []
    for ab in alphas_bar:
        mu = torch.sqrt(ab) * y[:, None]
        var = 1.0 - ab
        K = torch.exp(-0.5 * (y[None, :] - mu) ** 2 / var) / torch.sqrt(
            2 * math.pi * var)
        pi = (K * p0[:, None]).sum(0)
        out.append(pi / torch.trapezoid(pi, y))
    return torch.stack(out)


# %% reverse process by MC score ascent (the planner's update rule)
def reverse_mc(normals: torch.Tensor, alphas, alphas_bar, sigmas,
               n_steps: int, temp: float = 0.05) -> torch.Tensor:
    """Ȳ from 0 through the reverse steps n_steps − 1 … 1, [n_steps]:
    step k's n_mc samples are Ȳ + σᵢ·normals[k], normals [n_steps − 1,
    n_mc] standard normal."""
    Ybar = torch.zeros((), dtype=normals.dtype, device=normals.device)
    traj = [Ybar]
    for k, i in enumerate(range(n_steps - 1, 0, -1)):
        Yi = Ybar * torch.sqrt(alphas_bar[i])
        Y0s = Ybar + sigmas[i] * normals[k]
        logp = objective(Y0s) / temp
        w = torch.exp(logp - logp.max())
        w = w / w.sum()
        bary = (w * Y0s).sum()
        score = (-Yi + torch.sqrt(alphas_bar[i]) * bary) / (1 - alphas_bar[i])
        Yim1 = (Yi + (1 - alphas_bar[i]) * score) / torch.sqrt(alphas[i])
        Ybar = Yim1 / torch.sqrt(alphas_bar[i - 1])
        traj.append(Ybar)
    return torch.stack(traj)


# %%
N_SEEDS, N_MC = 8, 512


def compute(n_steps: int = 100, device=DEFAULT):
    """(grid y [400], forward densities [n_steps, 400], the reverse
    trajectories of N_SEEDS seeds [N_SEEDS, n_steps], each of N_MC samples
    a step, seed s's normals from
    ``torch.Generator(device).manual_seed(s)``), on ``device`` (the card
    unless the CPU is asked for)."""
    device = resolve(device)
    y = torch.linspace(-2, 2, 400, dtype=F64, device=device)
    alphas, alphas_bar, sigmas = schedule(n_steps, device)
    dens = forward_densities(y, target_density(y), alphas_bar)
    trajs = torch.stack([reverse_mc(
        torch.randn((n_steps - 1, N_MC), dtype=F64, device=device,
                    generator=torch.Generator(device).manual_seed(s)),
        alphas, alphas_bar, sigmas, n_steps) for s in range(N_SEEDS)])
    return y, dens, trajs


def main(argv=None):
    p = argparse.ArgumentParser(description="MBD in 1-D")
    p.add_argument("--out", default="results/demo_1d.png")
    p.add_argument("--n_steps", type=int, default=100)
    p.add_argument("--device", default=DEFAULT)
    args = p.parse_args(argv)
    y, dens, trajs = compute(args.n_steps, device=args.device)
    y, dens, trajs = y.cpu().numpy(), dens.cpu().numpy(), trajs.cpu().numpy()

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 3, figsize=(12, 3.2))
    axes[0].plot(y, objective(y))
    axes[0].set_title("objective J(y)")
    im = axes[1].imshow(dens.T, aspect="auto", origin="lower",
                        extent=[0, args.n_steps, y[0], y[-1]],
                        cmap="viridis")
    axes[1].set_title("forward density evolution")
    axes[1].set_xlabel("diffusion step i")
    fig.colorbar(im, ax=axes[1])
    for traj in trajs:
        axes[2].plot(range(len(traj))[::-1], traj, alpha=0.7)
    axes[2].axhline(0.6, color="k", ls="--", lw=0.8, label="optimum")
    axes[2].set_title("reverse MC score ascent")
    axes[2].set_xlabel("diffusion step i (reversed)")
    axes[2].legend()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    fig.tight_layout()
    fig.savefig(args.out, dpi=110)
    print(f"wrote {args.out}")
    return args.out


if __name__ == "__main__":
    main()
