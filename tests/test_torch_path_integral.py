"""The port's MPPI / CMA-ES / CEM baselines
(mbd_tpu_torch/planners/path_integral.py) against the JAX ones
(mbd_tpu/planners/path_integral.py), on the CPU.

Random streams differ between the packages, so the port is handed JAX's
reset state and JAX's noise, rebuilt from JAX's key splits in ``plan``:
split(rng) → (rng, rng_reset); split(rng) → (rng_exp, rng); per step
split(rng) → (rng, key), normal(key). JAX's step size σ is not in its
result, so a wrapper around its update rule reads it out with
``jax.debug.callback``.

One refine step is held at temperature 1, μ and σ to atol 1e-5, for the
reason tests/test_torch_planner.py::test_reverse_step_matches_jax gives:
the softmax multiplies a reward difference by 1/(σ_rews·temperature), and
at the recommended 0.1 the rollouts' float32 differences (XLA's order
against torch's) would move the weights past 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mbd_tpu import envs as jax_envs
from mbd_tpu.planners import path_integral as jax_pi
from mbd_tpu_torch import envs
from mbd_tpu_torch.envs import State
from mbd_tpu_torch.ops.rollout_cuda import rollout_rewards_cuda
from mbd_tpu_torch.planners import mbd
from mbd_tpu_torch.planners import path_integral as pi

METHODS = ("mppi", "cma-es", "cem")
ATOL = 1e-5


def _port_state(env, q, qd):
    ps = env.pipeline_init(torch.tensor(np.asarray(q)),
                           torch.tensor(np.asarray(qd)))
    return State(ps, env._obs(ps), torch.zeros(()), torch.zeros(()))


def _jax_stream(jenv, cfg, seed=0):
    """JAX's reset state and the noise of its refine steps, as ``plan``
    draws them."""
    rng, rng_reset = jax.random.split(jax.random.PRNGKey(seed))
    jstate = jenv.reset(rng_reset).pipeline_state
    rng_exp, _ = jax.random.split(rng)
    eps = []
    for _ in range(cfg.Nrefine - 1):
        rng_exp, key = jax.random.split(rng_exp)
        eps.append(np.asarray(jax.random.normal(
            key, (cfg.Nsample, cfg.Hsample, jenv.action_size))))
    return jstate, np.stack(eps)


@pytest.mark.parametrize("method", METHODS)
def test_refine_step_matches_jax(method, monkeypatch):
    """One refine step on hopper at Nsample 16, H 5, from the same reset
    state and noise: μ, σ and the mean reward to 1e-5."""
    kw = dict(update_method=method, Nsample=16, Hsample=5, Nrefine=2,
              temp_sample=1.0, cem_elite=4)
    jenv, tenv = jax_envs.get_env("hopper"), envs.get_env("hopper",
                                                           device="cpu")
    sigmas = []
    update = jax_pi._UPDATE_FNS[method]

    def recorded(*args, **kwargs):
        mu, sigma = update(*args, **kwargs)
        jax.debug.callback(lambda s: sigmas.append(float(s)), sigma)
        return mu, sigma

    monkeypatch.setitem(jax_pi._UPDATE_FNS, method, recorded)
    jcfg = jax_pi.PathIntegralConfig(**kw)
    jres = jax_pi.plan(jenv, jcfg, jax.random.PRNGKey(0), jit=False,
                       engine="fused")
    jax.effects_barrier()

    tcfg = pi.PathIntegralConfig(**kw)
    jstate, eps = _jax_stream(jenv, tcfg)
    step = pi.make_refine_step(tenv, tcfg, _port_state(
        tenv, jstate.q, jstate.qd))
    mu, sigma, rew = step(torch.zeros((5, tenv.action_size)),
                          torch.ones(()), torch.from_numpy(eps[0]))
    np.testing.assert_allclose(np.asarray(jres.mu_0ts[0]), mu.numpy(),
                               rtol=0, atol=ATOL)
    assert len(sigmas) == 1
    assert abs(sigmas[0] - float(sigma)) <= ATOL
    assert abs(float(jres.rews_trace[0]) - float(rew)) <= ATOL
    if method == "cma-es":
        assert float(sigma) != 1.0            # σ adapted


@pytest.mark.parametrize("method", METHODS)
def test_plan_matches_jax(method):
    """A whole small plan (hopper, Nsample 16, H 5, Nrefine 4, the
    recommended temperature 0.1) from JAX's reset state and noise: finite,
    of JAX's shapes, and the rewards to atol 5e-3, the planner tests'
    tolerance for rollouts through chaotic contacts."""
    kw = dict(update_method=method, Nsample=16, Hsample=5, Nrefine=4,
              cem_elite=4)
    jenv, tenv = jax_envs.get_env("hopper"), envs.get_env("hopper",
                                                           device="cpu")
    jres = jax_pi.plan(jenv, jax_pi.PathIntegralConfig(**kw),
                       jax.random.PRNGKey(0), engine="fused")
    cfg = pi.PathIntegralConfig(**kw)
    jstate, eps = _jax_stream(jenv, cfg)
    res = pi.plan(tenv, cfg, torch.Generator(),
                  state_init=_port_state(tenv, jstate.q, jstate.qd),
                  eps=torch.from_numpy(eps))
    assert res.mu_0ts.shape == (3, 5, tenv.action_size)
    assert res.rews_trace.shape == (3,)
    assert torch.isfinite(res.mu_0ts).all()
    assert torch.isfinite(res.final_reward)
    np.testing.assert_allclose(np.asarray(jres.rews_trace),
                               res.rews_trace.numpy(), rtol=0, atol=5e-3)
    assert abs(float(jres.final_reward) - float(res.final_reward)) <= 5e-3
    assert res.final_diverged is False and not bool(jres.final_diverged)


def _flag_final(monkeypatch, flag_all, iterates):
    """Flag the final plan's own rollout (the last sample of the final
    selection's call, the one that rolls the ``iterates`` refined means
    out) and, with ``flag_all``, every sample of every call."""
    real = mbd.rollout_rewards_cuda

    def flagged(env, state0, Y0s, *args, **kwargs):
        rews, bad = real(env, state0, Y0s, *args, **kwargs)
        if flag_all:
            bad = torch.ones_like(bad)
        elif Y0s.shape[0] == iterates:
            bad = bad.clone()
            bad[-1] = 1
        return rews, bad

    monkeypatch.setattr(mbd, "rollout_rewards_cuda", flagged)


@pytest.mark.parametrize("method", METHODS)
def test_plan_falls_back_to_best_clean_iterate(method, monkeypatch):
    """With the final plan's rollout flagged, the plan returns the best
    clean iterate of the refine trace in its place, and its reward."""
    env = envs.get_env("cartpole", device="cpu")
    cfg = pi.PathIntegralConfig(update_method=method, Nsample=8, Hsample=4,
                                Nrefine=5, cem_elite=3)
    clean = pi.plan(env, cfg, torch.Generator().manual_seed(2))
    _flag_final(monkeypatch, flag_all=False, iterates=cfg.Nrefine - 1)
    res = pi.plan(env, cfg, torch.Generator().manual_seed(2))
    assert torch.equal(res.rews_trace, clean.rews_trace)
    state = env.reset(torch.Generator().manual_seed(2))
    rews, _ = rollout_rewards_cuda(env, state, clean.mu_0ts)
    best = int(torch.argmax(rews[:-1].mean(dim=-1)))
    assert torch.equal(res.mu_0ts[-1], clean.mu_0ts[best])
    assert torch.equal(res.mu_0ts[:-1], clean.mu_0ts[:-1])
    assert float(res.final_reward) == float(rews[best].mean())
    assert res.final_diverged is False


def test_plan_reports_no_clean_iterate(monkeypatch):
    """Every candidate flagged: the flagged final reward, and
    ``final_diverged``."""
    env = envs.get_env("cartpole", device="cpu")
    cfg = pi.PathIntegralConfig(Nsample=8, Hsample=4, Nrefine=3)
    _flag_final(monkeypatch, flag_all=True, iterates=cfg.Nrefine - 1)
    res = pi.plan(env, cfg, torch.Generator().manual_seed(2))
    assert res.final_diverged is True
    assert torch.isfinite(res.final_reward)


def test_cem_ties_pick_jax_elite_set():
    """Tied weights (exact zeros, as underflowed softmax weights are) and
    flagged samples: the port's elite set and mean are JAX's, whose top_k
    takes the lowest index first among ties."""
    rng = np.random.default_rng(4)
    N, H, nu = 32, 3, 2
    w = np.zeros(N, np.float32)
    w[[5, 17, 26]] = [0.5, 0.3, 0.2]
    valid = np.ones(N, bool)
    valid[[0, 1, 9]] = False
    Y0s = rng.uniform(-1, 1, (N, H, nu)).astype(np.float32)
    cfg = pi.PathIntegralConfig(cem_elite=10)
    mu_j, _ = jax_pi.cem_update(jnp.asarray(w), jnp.asarray(Y0s), 1.0, None,
                                cfg, valid=jnp.asarray(valid))
    mu_t, _ = pi.cem_update(torch.from_numpy(w), torch.from_numpy(Y0s),
                            1.0, None, cfg, torch.from_numpy(valid))
    # the elite: the three positive weights, then the first seven clean
    # zeros by index
    elite = [5, 17, 26, 2, 3, 4, 6, 7, 8, 10]
    np.testing.assert_allclose(Y0s[elite].mean(0), mu_t.numpy(), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(mu_j), mu_t.numpy(), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("name", ["pushT", "humanoidrun", "hopper"])
def test_recommended_config_matches_jax(name):
    cfg = pi.recommended_config(name)
    assert cfg == pi.PathIntegralConfig(**vars(
        jax_pi.recommended_config(name)))
    if name == "pushT":
        assert (cfg.Nsample, cfg.Hsample, cfg.Nrefine, cfg.temp_sample) \
            == (2048, 40, 200, 0.2)
