"""The denoising-process viewer of the port
(``mbd_tpu_torch/cli/vis_diffusion.py``) against the JAX one
(``mbd_tpu/cli/vis_diffusion.py``), on the CPU: the iterates it draws and
the page it writes."""

import json
import re

import numpy as np
import pytest
import torch

from mbd_tpu_torch import envs
from mbd_tpu_torch.cli import vis_diffusion
from mbd_tpu_torch.rollout.rollout import rollout_states


@pytest.mark.parametrize("T, n_ghosts", [(99, 6), (7, 3), (5, 6), (1, 2)])
def test_iterates_are_jax_s(T, n_ghosts):
    """The iterate indices are JAX's expression's
    (mbd_tpu/cli/vis_diffusion.py:46), the last iterate last."""
    idx = vis_diffusion.iterates(T, n_ghosts)
    np.testing.assert_array_equal(
        idx, np.linspace(0, T - 1, n_ghosts + 1).astype(int))
    assert len(idx) == n_ghosts + 1 and idx[-1] == T - 1


def test_page_has_the_ghosts(tmp_path):
    """On a saved stack of 7 cartpole iterates with 3 ghosts: the page
    holds the last iterate's frames, re-simulated from seed 0's reset as
    ``run_mbd --mode single`` draws it, and 3 ghost trajectories of the
    same length."""
    env = envs.get_env("cartpole", device="cpu")
    out = tmp_path / "cartpole"
    out.mkdir()
    mu = np.random.default_rng(0).uniform(-1, 1, (7, 5, 1)).astype(
        np.float32)
    np.save(out / "mu_0ts.npy", mu)
    path = vis_diffusion.main(["--env_name", "cartpole", "--device", "cpu",
                               "--results_dir", str(tmp_path),
                               "--n_ghosts", "3"])
    with open(path) as f:
        page = f.read()
    data = json.loads(re.search(r"const DATA = (.*);\n", page).group(1))
    assert len(data["ghosts"]) == 3
    assert all(len(g) == 5 for g in data["ghosts"])
    state = env.reset(torch.Generator().manual_seed(0))
    last = rollout_states(env, state, torch.from_numpy(mu[-1]))
    np.testing.assert_allclose(
        np.asarray([fr["pos"] for fr in data["frames"]]),
        last.x.pos.numpy(), rtol=0, atol=1e-6)
