"""car2d and the analytic path of the port (mbd_tpu_torch/envs/car2d.py,
rollout/rollout.py::rollout_us, the analytic branch of planners/mbd.py and
planners/path_integral.py) against the JAX ones (mbd_tpu/envs/car2d.py,
its vmap engine), on the CPU.

The same states and controls, made with numpy from a seed, go through
both packages; the planners are handed JAX's noise, rebuilt from JAX's
key splits (car2d's reset draws nothing, so both start from x0).
Tolerances: one step, its reward and the demo log-density at atol 1e-5
(the engine tests' tolerance; measured 1.5e-8, 2.4e-7 and 1.8e-7: sin
and cos round otherwise in XLA and torch); whole plans at atol 5e-3 on
the rewards, the tolerance tests/test_torch_planner.py uses for a plan.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mbd_tpu import envs as jax_envs
from mbd_tpu.planners import mbd as jax_mbd
from mbd_tpu.planners import path_integral as jax_pi
from mbd_tpu.rollout import rollout_us as jax_rollout_us
from mbd_tpu_torch import envs
from mbd_tpu_torch.planners import mbd
from mbd_tpu_torch.planners import path_integral as pi
from mbd_tpu_torch.rollout.rollout import rollout_us

ATOL = 1e-5
PLAN_ATOL = 5e-3
SMALL = dict(Nsample=64, Hsample=10, Ndiffuse=12)


@pytest.fixture(scope="module")
def pair():
    return jax_envs.get_env("car2d"), envs.get_env("car2d", device="cpu")


def _states_and_controls(n=512, seed=0):
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.uniform(-1.5, 1.5, (n, 2)),
                        rng.uniform(-np.pi, np.pi, (n, 1))], axis=1)
    u = rng.uniform(-1.5, 1.5, (n, 2))
    return x.astype(np.float32), u.astype(np.float32)


def test_step_reward_and_collision_match_jax(pair):
    """One step of 512 seeded states, controls past the ±1 clip among
    them: the next state and reward at atol 1e-5, and the collision branch
    taken by some samples (their state frozen, bit for bit) and not by
    others."""
    jenv, tenv = pair
    x, u = _states_and_controls()
    s0 = jenv.reset(jax.random.PRNGKey(0))
    js = jax.vmap(lambda x, u: jenv.step(s0.replace(pipeline_state=x), u))(
        jnp.asarray(x), jnp.asarray(u))
    ts = tenv.step(tenv.reset(None).replace(
        pipeline_state=torch.from_numpy(x)), torch.from_numpy(u))
    np.testing.assert_allclose(np.asarray(js.pipeline_state),
                               ts.pipeline_state.numpy(), rtol=0, atol=ATOL)
    np.testing.assert_allclose(np.asarray(js.reward), ts.reward.numpy(),
                               rtol=0, atol=ATOL)
    frozen = (ts.pipeline_state.numpy() == x).all(axis=1)
    assert 0 < frozen.sum() < len(x)
    np.testing.assert_array_equal(
        frozen, (np.asarray(js.pipeline_state) == x).all(axis=1))
    assert float(tenv.rew_xref) == pytest.approx(float(jenv.rew_xref),
                                                 abs=ATOL)
    assert tenv.observation_size == jenv.observation_size == 3


def test_xref_logpd_matches_jax(pair):
    """The demo's tracking log-density of 16 seeded trajectories [50, 3],
    at atol 1e-5; the fixed start draws nothing from the generator."""
    jenv, tenv = pair
    xs = np.random.default_rng(1).uniform(-1, 1, (16, 50, 3)).astype(
        np.float32)
    np.testing.assert_allclose(
        np.asarray(jax.vmap(jenv.eval_xref_logpd)(jnp.asarray(xs))),
        tenv.eval_xref_logpd(torch.from_numpy(xs)).numpy(), rtol=0,
        atol=ATOL)
    g = torch.Generator().manual_seed(3)
    state = g.get_state()
    assert torch.equal(tenv.reset(g).pipeline_state, tenv.x0)
    assert torch.equal(g.get_state(), state)


def test_rollout_us_matches_jax(pair):
    """rollout_us of 64 seeded control sequences [50, 2] from x0 against
    JAX's vmapped rollout_us: rewards and states at atol 1e-5 (measured 0
    and 9.5e-7; RK4 is smooth and the samples that collide freeze in
    both)."""
    jenv, tenv = pair
    us = np.random.default_rng(2).uniform(-1, 1, (64, 50, 2)).astype(
        np.float32)
    jr, jx = jax.vmap(functools.partial(jax_rollout_us, jenv.step),
                      in_axes=(None, 0))(jenv.reset(jax.random.PRNGKey(0)),
                                         jnp.asarray(us))
    tr, tx = rollout_us(tenv, tenv.reset(None), torch.from_numpy(us))
    assert tr.shape == (64, 50) and tx.shape == (64, 50, 3)
    np.testing.assert_allclose(np.asarray(jr), tr.numpy(), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(np.asarray(jx), tx.numpy(), rtol=0,
                               atol=ATOL)


def _jax_noise(key, T, N, H, nu):
    """The noise of T steps as JAX's planners draw it from ``key``: per
    step split(key) → (key, sub), normal(sub)."""
    eps = []
    for _ in range(T):
        key, sub = jax.random.split(key)
        eps.append(np.asarray(jax.random.normal(sub, (N, H, nu))))
    return torch.from_numpy(np.stack(eps))


def _serial_noise(cfg, T):
    """``plan``'s stream from PRNGKey(0): split → (rng, rng_reset), split
    → (rng_exp, rng), then the steps (mbd_tpu/planners/mbd.py:668-671)."""
    rng, _ = jax.random.split(jax.random.PRNGKey(0))
    rng_exp, _ = jax.random.split(rng)
    return _jax_noise(rng_exp, T, cfg.Nsample, cfg.Hsample, 2)


@pytest.mark.parametrize("demo", [False, True])
def test_plan_matches_jax(pair, demo):
    """mbd.plan at 64 / 10 / 12 with JAX's noise against JAX's plan on
    its vmap engine: rews_trace and final_reward at atol 5e-3, the flag
    equal, Ȳ at atol 5e-3 (measured: rewards 7.1e-8, where JAX's
    1 − (0.2/0.2)² rounds to −7.1e-8 and torch's to 0; Ȳ 4.5e-8, and
    1.7e-5 with the demo)."""
    jenv, tenv = pair
    cfg = mbd.MBDConfig(enable_demo=demo, **SMALL)
    jres = jax_mbd.plan(jenv, jax_mbd.MBDConfig(**vars(cfg)),
                        jax.random.PRNGKey(0))
    tres = mbd.plan(tenv, cfg, torch.Generator(),
                    eps=_serial_noise(cfg, cfg.Ndiffuse - 1))
    assert tres.Ybars.shape == (cfg.Ndiffuse - 1, cfg.Hsample, 2)
    np.testing.assert_allclose(np.asarray(jres.rews_trace),
                               tres.rews_trace.numpy(), rtol=0,
                               atol=PLAN_ATOL)
    np.testing.assert_allclose(np.asarray(jres.Ybars), tres.Ybars.numpy(),
                               rtol=0, atol=PLAN_ATOL)
    assert abs(float(jres.final_reward) - float(tres.final_reward)) \
        <= PLAN_ATOL
    assert tres.final_diverged is bool(jres.final_diverged) is False


@pytest.mark.parametrize("demo", [False, True])
def test_plan_batch_matches_jax_and_serial(pair, demo):
    """mbd.plan_batch of 2 seeds at 64 / 10 / 12 with JAX's per-seed
    noise against JAX's plan_batch (atol 5e-3), and each seed against the
    port's serial plan on the same noise (bit for bit: car2d steps each
    sample alone and the statistics run per seed)."""
    jenv, tenv = pair
    S = 2
    cfg = mbd.MBDConfig(enable_demo=demo, **SMALL)
    rngs = jnp.stack([jax.random.PRNGKey(s) for s in range(S)])
    jres = jax_mbd.plan_batch(jenv, jax_mbd.MBDConfig(**vars(cfg)), rngs)
    eps = []
    for s in range(S):
        rng_after, _ = jax.random.split(jax.random.PRNGKey(s))
        eps.append(_jax_noise(jax.random.split(rng_after)[0],
                              cfg.Ndiffuse - 1, cfg.Nsample, cfg.Hsample,
                              2))
    eps = torch.stack(eps, dim=1)
    tres = mbd.plan_batch(tenv, cfg, [torch.Generator() for _ in range(S)],
                          eps=eps)
    np.testing.assert_allclose(np.asarray(jres.rews_trace),
                               tres.rews_trace.numpy(), rtol=0,
                               atol=PLAN_ATOL)
    np.testing.assert_allclose(np.asarray(jres.final_reward),
                               tres.final_reward.numpy(), rtol=0,
                               atol=PLAN_ATOL)
    assert not tres.final_diverged.any()
    for s in range(S):
        one = mbd.plan(tenv, cfg, torch.Generator(), eps=eps[:, s])
        assert torch.equal(one.Ybars, tres.Ybars[s])
        assert torch.equal(one.rews_trace, tres.rews_trace[s])


@pytest.mark.parametrize("method", ["mppi", "cem", "cma-es"])
def test_baselines_match_jax(pair, method):
    """path_integral.plan at 64 / 10 / Nrefine 12 with JAX's noise against
    JAX's plan on its vmap engine: rews_trace and final_reward at atol
    5e-3, μ at atol 5e-3 (measured at most 1.2e-7)."""
    jenv, tenv = pair
    cfg = pi.PathIntegralConfig(update_method=method, Nsample=64,
                                Hsample=10, Nrefine=12)
    jres = jax_pi.plan(jenv, jax_pi.PathIntegralConfig(**vars(cfg)),
                       jax.random.PRNGKey(0))
    tres = pi.plan(tenv, cfg, torch.Generator(),
                   eps=_serial_noise(cfg, cfg.Nrefine - 1))
    np.testing.assert_allclose(np.asarray(jres.rews_trace),
                               tres.rews_trace.numpy(), rtol=0,
                               atol=PLAN_ATOL)
    np.testing.assert_allclose(np.asarray(jres.mu_0ts), tres.mu_0ts.numpy(),
                               rtol=0, atol=PLAN_ATOL)
    assert abs(float(jres.final_reward) - float(tres.final_reward)) \
        <= PLAN_ATOL
    assert tres.final_diverged is False


def test_cli_single_writes_rollout_png(tmp_path):
    """``run_mbd --env_name car2d --mode single --device cpu`` writes
    mu_0ts.npy and the matplotlib picture rollout.png."""
    from mbd_tpu_torch.cli import run_mbd

    rew = run_mbd.main(["--env_name", "car2d", "--device", "cpu",
                        "--Nsample", "16", "--Hsample", "8", "--Ndiffuse",
                        "4", "--disable_recommended_params",
                        "--enable_demo", "--results_dir", str(tmp_path)])
    assert np.isfinite(rew)
    out = tmp_path / "car2d"
    assert np.load(out / "mu_0ts.npy").shape == (3, 8, 2)
    with open(out / "rollout.png", "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_get_env_car2d_defaults_to_the_card():
    """car2d builds on ``cuda`` when no device is named: here, without a
    card, it raises."""
    if torch.cuda.is_available():
        assert envs.get_env("car2d").device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        envs.get_env("car2d")
    assert os.path.exists(envs.car2d.XREF_PATH)
