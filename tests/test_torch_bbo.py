"""MBD as a black-box optimizer in the port
(``mbd_tpu_torch/blackbox/bbo.py``) against the JAX one
(``mbd_tpu/blackbox/bbo.py``), on the CPU: the objectives on the same
points, and ``optimize`` handed JAX's noise (its initial population's
draw from the key, then per step split(key) → (key, sub), normal(sub)).

The optimizer amplifies rounding: at temperature 1 the weights follow the
standardized objective, and as the population contracts its spread
shrinks, so the last steps magnify any difference. On Rastrigin at dim
32, 20 steps, the port and JAX part by 41 in J (JAX's jitted and eager
programs by 18 at dim 64, 30 steps). So ``optimize`` is held at 10 steps
at dim 16, where JAX's jitted and eager programs agree exactly and the
port differs by at most 1.7e-5 of |J| (Rastrigin) in J and 9.3e-6 in
the population: J at rtol 1e-4, the population at atol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mbd_tpu.blackbox import bbo as jax_bbo
from mbd_tpu_torch.blackbox import bbo

FNS = ("Ackley", "Rastrigin", "Levy")


@pytest.mark.parametrize("fn_name", FNS)
def test_objective_matches_jax(fn_name):
    """0 at the optimum (atol 1e-4, as tests/test_blackbox.py), and 64
    seeded points at dim 800 at rtol 1e-6 (measured 2.2e-7 of |f|: the
    sums over 800 terms run in another order)."""
    dim = 800
    fn, jfn = bbo.make_objective(fn_name, dim), jax_bbo.make_objective(
        fn_name, dim)
    x_min, x_max = (-5.0, 10.0) if fn_name == "Ackley" else (-5.0, 5.0)
    x_opt = 1.0 if fn_name == "Levy" else 0.0
    y_opt = 2.0 * (x_opt - x_min) / (x_max - x_min) - 1.0
    assert float(fn(torch.full((dim,), y_opt))) == pytest.approx(0.0,
                                                                 abs=1e-4)
    Y = np.random.default_rng(0).uniform(-1, 1, (64, dim)).astype(
        np.float32)
    want = np.asarray(jax.vmap(jfn)(jnp.asarray(Y)))
    np.testing.assert_allclose(fn(torch.from_numpy(Y)).numpy(), want,
                               rtol=1e-6, atol=0)


def _jax_noise(cfg, key):
    eps = [np.asarray(jax.random.normal(key, (cfg.Nsample, cfg.dim)))]
    for _ in range(cfg.Ndiffuse - 1):
        key, sub = jax.random.split(key)
        eps.append(np.asarray(jax.random.normal(sub, (cfg.Nsample,
                                                      cfg.dim))))
    return torch.from_numpy(np.stack(eps))


@pytest.mark.parametrize("fn_name", FNS)
def test_optimize_matches_jax(fn_name):
    """dim 16, Nsample 16, Ndiffuse 10 from PRNGKey(1)'s stream: J_trace
    at rtol 1e-4, the final population at atol 1e-4 (module docstring),
    evals equal."""
    cfg = bbo.BBOConfig(fn_name=fn_name, dim=16, Nsample=16, Ndiffuse=10)
    key = jax.random.PRNGKey(1)
    jres = jax_bbo.optimize(jax_bbo.BBOConfig(**vars(cfg)), key)
    res = bbo.optimize(cfg, None, device="cpu", eps=_jax_noise(cfg, key))
    np.testing.assert_allclose(res.J_trace.numpy(), np.asarray(jres.J_trace),
                               rtol=1e-4, atol=0)
    np.testing.assert_allclose(res.mu_final.numpy(),
                               np.asarray(jres.mu_final), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(res.evals.numpy(), np.asarray(jres.evals))


def test_optimize_improves_and_draws_from_the_generator():
    """The port alone, as tests/test_blackbox.py holds JAX's: Rastrigin at
    dim 64 improves by more than 100 and the population collapses; two
    runs from equal seeds agree, and ``eps`` of the wrong shape is
    refused."""
    cfg = bbo.BBOConfig(fn_name="Rastrigin", dim=64, Nsample=64,
                        Ndiffuse=100)
    res = bbo.optimize(cfg, torch.Generator().manual_seed(0), device="cpu")
    J = res.J_trace.numpy()
    assert res.evals.shape == (99,)
    assert J[-1] > J[0] + 100.0
    assert res.mu_final.std(dim=0).max() < 1e-3
    again = bbo.optimize(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    assert torch.equal(res.J_trace, again.J_trace)
    with pytest.raises(ValueError, match="eps"):
        bbo.optimize(cfg, None, device="cpu",
                     eps=torch.zeros((cfg.Ndiffuse - 1, 64, 64)))
