"""The explainer (``mbd_tpu_torch/cli/vis_explainer.py``) and the 1-D demo
(``mbd_tpu_torch/notebooks/demo_1d.py``) against the JAX package's numpy
versions, on the CPU: the same normals in, the same numbers out to 1e-6
(both float64; they differ only in the order of their sums and in libm's
last bits), and one GIF and one PNG rendered."""

import os

import numpy as np
import pytest
import torch

from mbd_tpu.cli import vis_explainer as jexp
from mbd_tpu.notebooks import demo_1d as jdemo
from mbd_tpu_torch.cli import vis_explainer as exp
from mbd_tpu_torch.notebooks import demo_1d as demo

TOL = 1e-6


def _close(a, b):
    np.testing.assert_allclose(torch.as_tensor(a).numpy(), b, rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("scale", exp.SCALES)
def test_explainer_numerics_match_jax(scale):
    """demo_traj (plain and blocked), _model_traj and the noising path on
    JAX's normals; the score field on a grid."""
    grown = exp.R0 * exp.RSCALE
    _close(exp.demo_traj(scale, device="cpu"), jexp.demo_traj(scale))
    _close(exp.demo_traj(scale, r_block=grown, device="cpu"),
           jexp.demo_traj(scale, r_block=grown))
    _close(exp._model_traj(scale, grown, device="cpu"),
           jexp._model_traj(scale, grown))
    clean = jexp.demo_traj(scale)
    n = 10
    rng = np.random.default_rng(7)
    normals = np.stack([rng.standard_normal(clean.shape) for _ in range(n)])
    ref = jexp.noising_path(clean, n, np.random.default_rng(7))
    got = exp.noising_path(torch.from_numpy(clean), n,
                           normals=torch.from_numpy(normals))
    assert len(got) == len(ref) == n + 1
    for a, b in zip(got, ref):
        _close(a, b)
    g = np.stack(np.meshgrid(np.linspace(-1.8, 1.8, 13),
                             np.linspace(-1.8, 1.8, 13)), axis=-1)
    _close(exp.score_field(torch.from_numpy(g)), jexp.score_field(g))


def test_demo_1d_numerics_match_jax():
    """The target density, the forward densities and the reverse MC
    ascent on JAX's normals (numpy's ``normal(Ȳ, σ)`` is Ȳ + σ·z)."""
    n_steps, n_mc = 100, 512
    y = np.linspace(-2, 2, 400)
    alphas, alphas_bar, sigmas = demo.schedule(n_steps, device="cpu")
    betas = np.linspace(1e-4, 2e-2, n_steps)
    ref_ab = np.cumprod(1 - betas)
    _close(alphas_bar, ref_ab)
    ty = torch.from_numpy(y)
    p0 = jdemo.target_density(y)
    _close(demo.target_density(ty), p0)
    _close(demo.forward_densities(ty, torch.from_numpy(p0), alphas_bar),
           jdemo.forward_densities(y, p0, ref_ab))
    rng = np.random.default_rng(3)
    z = np.stack([rng.standard_normal(n_mc) for _ in range(n_steps - 1)])
    ref = jdemo.reverse_mc(np.random.default_rng(3), 1 - betas, ref_ab,
                           np.sqrt(1 - ref_ab), n_steps, n_mc=n_mc)
    _close(demo.reverse_mc(torch.from_numpy(z), alphas, alphas_bar, sigmas,
                           n_steps), ref)


def test_renders(tmp_path):
    """One GIF and one PNG of the explainer and the demo's PNG, drawn from
    numerics on the CPU."""
    gif = exp.main(["--steps", "4", "--fps", "5", "--device", "cpu",
                    "--out", str(tmp_path / "e.gif")])
    png = exp.main(["--static", "--steps", "4", "--device", "cpu",
                    "--out", str(tmp_path / "e.png")])
    d1 = demo.main(["--n_steps", "20", "--device", "cpu",
                    "--out", str(tmp_path / "d.png")])
    for out in (gif, png, d1):
        assert os.path.getsize(out) > 10_000
