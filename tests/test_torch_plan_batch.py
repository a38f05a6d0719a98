"""The port's seed-batched planners (``plan_batch`` in
mbd_tpu_torch/planners/mbd.py and path_integral.py) against JAX's
(mbd_tpu/planners/mbd.py, path_integral.py) and against the port's own
serial ``plan``, on the CPU.

Random streams differ between the packages, so the port is handed JAX's
per-seed resets and noise, rebuilt from JAX's key splits in
``plan_batch``: per seed, split(key) → (rng_after, rng_reset), reset from
rng_reset, split(rng_after)[0] → rng_exp; per step split(rng) → (rng,
key), normal(key) (mbd_tpu/planners/mbd.py:509-513, :402-405).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mbd_tpu import envs as jax_envs
from mbd_tpu.planners import mbd as jax_mbd
from mbd_tpu.planners import path_integral as jax_pi
from mbd_tpu_torch import envs
from mbd_tpu_torch.envs import State
from mbd_tpu_torch.planners import mbd
from mbd_tpu_torch.planners import path_integral as pi

# Port against port: each seed's statistics reduce the serial plan's
# shapes (mbd.per_seed), so batch and serial agree to the bit (measured
# 0); 1e-5 leaves room for a reassociation, not for a wrong seed.
TIGHT = 1e-5


def _port_state(env, q, qd):
    ps = env.pipeline_init(torch.tensor(np.asarray(q)),
                           torch.tensor(np.asarray(qd)))
    return State(ps, env._obs(ps), torch.zeros(()), torch.zeros(()))


def _jax_batch_stream(jenv, cfg, S):
    """JAX plan_batch's per-seed reset states and noise [T, S, N, H, nu]."""
    resets, eps = [], []
    for s in range(S):
        rng_after, rng_reset = jax.random.split(jax.random.PRNGKey(s))
        resets.append(jenv.reset(rng_reset).pipeline_state)
        rng = jax.random.split(rng_after)[0]
        steps = []
        for _ in range(cfg.Ndiffuse - 1):
            rng, key = jax.random.split(rng)
            steps.append(np.asarray(jax.random.normal(
                key, (cfg.Nsample, cfg.Hsample, jenv.action_size))))
        eps.append(np.stack(steps))
    return resets, torch.tensor(np.stack(eps, axis=1))


def test_plan_batch_matches_jax_hopper():
    """hopper, S = 2, Nsample 16, Hsample 8, Ndiffuse 4 at temperature
    0.1, against JAX's plan_batch on its fused engine (about 30 s to
    compile here). rews_trace and final_reward to atol 5e-3, the
    tolerance of the serial slice (tests/test_torch_planner.py) for the
    same float32 reassociation between XLA and torch; the flags equal."""
    S = 2
    cfg = mbd.MBDConfig(Nsample=16, Hsample=8, Ndiffuse=4)
    jenv, tenv = jax_envs.get_env("hopper"), envs.get_env("hopper",
                                                           device="cpu")
    rngs = jnp.stack([jax.random.PRNGKey(s) for s in range(S)])
    jres = jax_mbd.plan_batch(jenv, jax_mbd.MBDConfig(**vars(cfg)), rngs,
                              engine="fused")
    resets, eps = _jax_batch_stream(jenv, cfg, S)
    tres = mbd.plan_batch(
        tenv, cfg, [torch.Generator() for _ in range(S)],
        states_init=[_port_state(tenv, r.q, r.qd) for r in resets], eps=eps)
    T = cfg.Ndiffuse - 1
    assert tres.Ybars.shape == (S, T, cfg.Hsample, tenv.action_size)
    assert tres.rews_trace.shape == (S, T)
    assert tres.final_diverged.shape == (S,)
    np.testing.assert_allclose(np.asarray(jres.rews_trace),
                               tres.rews_trace.numpy(), rtol=0, atol=5e-3)
    np.testing.assert_allclose(np.asarray(jres.final_reward),
                               tres.final_reward.numpy(), rtol=0, atol=5e-3)
    np.testing.assert_array_equal(np.asarray(jres.final_diverged),
                                  tres.final_diverged.numpy())


def _batch_against_serial(env, cfg, S=2, **kw):
    gens = [torch.Generator().manual_seed(10 + s) for s in range(S)]
    batch = mbd.plan_batch(env, cfg, gens, **kw)
    for s in range(S):
        serial = mbd.plan(env, cfg, torch.Generator().manual_seed(10 + s))
        np.testing.assert_allclose(batch.Ybars[s].numpy(),
                                   serial.Ybars.numpy(), rtol=0, atol=TIGHT)
        np.testing.assert_allclose(batch.rews_trace[s].numpy(),
                                   serial.rews_trace.numpy(), rtol=0,
                                   atol=TIGHT)
        assert abs(float(batch.final_reward[s])
                   - float(serial.final_reward)) <= TIGHT
        assert bool(batch.final_diverged[s]) == serial.final_diverged
    return batch


def test_plan_batch_seed_is_its_serial_plan():
    """Seed s of the batch draws its reset and then every step's noise
    from its own generator: its Ȳ, rewards and final plan are those of
    the serial ``plan`` from the same generator (atol 1e-5). The batch
    reports its mean reward after every ``chunk_size`` steps. pushT at
    Nsample 8, H 4 (its contacts, and 5 substeps a step where hopper
    takes 20)."""
    env = envs.get_env("pushT", device="cpu")
    progress = []
    batch = _batch_against_serial(
        env, mbd.MBDConfig(Nsample=8, Hsample=4, Ndiffuse=4), chunk_size=2,
        progress_fn=lambda *a: progress.append(a))
    assert [p[0] for p in progress] == [2, 3]
    assert progress[-1][1] == pytest.approx(float(batch.rews_trace[:, -1]
                                                  .mean()))


def test_plan_batch_demo_seed_is_its_serial_plan():
    """The demo fusion inside the batch, on humanoidtrack at a tiny size
    (Nsample 4, H 2): each seed's demo maximum is its own, so each seed
    is its serial plan (atol 1e-5)."""
    env = envs.get_env("humanoidtrack", device="cpu")
    _batch_against_serial(env, mbd.MBDConfig(Nsample=4, Hsample=2,
                                             Ndiffuse=3, enable_demo=True))


def test_plan_batch_checks_its_inputs():
    env = envs.get_env("cartpole", device="cpu")
    cfg = mbd.MBDConfig(Nsample=4, Hsample=2, Ndiffuse=2)
    gens = [torch.Generator(), torch.Generator()]
    with pytest.raises(ValueError, match="eps"):
        mbd.plan_batch(env, cfg, gens, eps=torch.zeros((1, 1, 4, 2, 1)))
    with pytest.raises(ValueError, match="initial states"):
        mbd.plan_batch(env, cfg, gens, states_init=[env.reset(gens[0])])


def _jax_seed_stats(rews, bad, logpd, rew_xref, temp, demo, Y0s):
    """JAX plan_batch's per-seed statistics, as written at
    mbd_tpu/planners/mbd.py:409-438, on [S, N] arrays."""
    valid = jnp.isfinite(rews) & (bad == 0)
    worst = jnp.min(jnp.where(valid, rews, jnp.inf), axis=1, keepdims=True)
    worst = jnp.where(jnp.isfinite(worst), worst, 0.0)
    rews = jnp.where(valid, rews, worst)
    rew_mean = rews.mean(axis=1, keepdims=True)
    rew_std = rews.std(axis=1, keepdims=True)
    rew_std = jnp.where(rew_std < 1e-4, 1.0, rew_std)
    logp0 = (rews - rew_mean) / rew_std / temp
    if demo:
        logpd = logpd - logpd.max(axis=1, keepdims=True)
        logpdemo = (logpd + rew_xref - rew_mean) / rew_std / temp
        logp0 = jnp.where(logpdemo > logp0, logpdemo, logp0)
        lstd = logp0.std(axis=1, keepdims=True)
        lstd = jnp.where(lstd < 1e-4, 1.0, lstd)
        logp0 = (logp0 - logp0.mean(axis=1, keepdims=True)) / lstd / temp
    n_valid = valid.sum(axis=1, keepdims=True)
    logp0 = jnp.where(valid, logp0, -jnp.inf)
    weights = jax.nn.softmax(logp0, axis=1)
    weights = jnp.where(n_valid > 0, weights,
                        jnp.full_like(weights, 1.0 / weights.shape[1]))
    return (weights, jnp.einsum("sn,snij->sij", weights, Y0s),
            rews.mean(axis=1))


@pytest.mark.parametrize("demo", [False, True])
def test_seed_statistics_match_jax(demo):
    """Each seed's statistics (standardized_rewards, fuse_demo,
    masked_softmax, barycenter, applied per seed by ``mbd.per_seed`` as
    the batched reverse step applies them) on synthetic [S, N] arrays
    against JAX's formulas over axis 1: flagged and non-finite samples, a
    seed with every sample flagged (uniform weights for it alone), a seed
    with a flat reward (std under 1e-4), and demo log-densities whose
    maxima differ per seed. Weights, barycenters and mean rewards to atol
    1e-6."""
    rng = np.random.default_rng(0)
    S, N, H, nu = 4, 16, 5, 3
    rewss = rng.normal(size=(S, N, H)).astype(np.float32)
    rewss[1] = 0.25                                     # a flat seed
    rewss[2, 3, 1] = np.nan                              # non-finite
    bad = (rng.random((S, N)) < 0.3).astype(np.float32)
    bad[3] = 1.0                                         # all flagged
    logpd = (rng.normal(size=(S, N)) - 3.0 * np.arange(S)[:, None]
             ).astype(np.float32)
    Y0s = rng.uniform(-1, 1, (S, N, H, nu)).astype(np.float32)
    temp, rew_xref = 0.1, 1.0

    jw, jY, jmean = _jax_seed_stats(
        jnp.asarray(rewss).mean(axis=-1), jnp.asarray(bad),
        jnp.asarray(logpd), rew_xref, temp, demo, jnp.asarray(Y0s))

    def one_seed(rewss, bad, logpd, Y0s):
        logp0, valid, mean, std = mbd.standardized_rewards(rewss, bad, temp)
        if demo:
            logp0 = mbd.fuse_demo(logp0, logpd, mean, std, rew_xref, temp)
        w = mbd.masked_softmax(logp0, valid)
        return w, mbd.barycenter(w, Y0s), mean

    tw, tY, tmean = mbd.per_seed(one_seed, *map(
        torch.tensor, (rewss, bad, logpd, Y0s)))
    for a, b in ((jw, tw), (jY, tY), (jmean, tmean)):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=0,
                                   atol=1e-6)
    np.testing.assert_allclose(tw[3].numpy(), 1.0 / N)


@pytest.mark.parametrize("method", ["mppi", "cem", "cma-es"])
def test_path_integral_plan_batch_seed_is_its_serial_plan(method):
    """path_integral.plan_batch's seed s is the serial ``plan`` from the
    same generator: μ, σ's effect, the rewards and the final plan to atol
    1e-5, on cartpole at Nsample 8, H 4, Nrefine 4."""
    env = envs.get_env("cartpole", device="cpu")
    cfg = pi.PathIntegralConfig(update_method=method, Nsample=8, Hsample=4,
                                Nrefine=4, cem_elite=3)
    gens = [torch.Generator().manual_seed(20 + s) for s in range(2)]
    batch = pi.plan_batch(env, cfg, gens)
    assert batch.mu_0ts.shape == (2, 3, 4, env.action_size)
    assert batch.final_diverged.shape == (2,)
    for s in range(2):
        serial = pi.plan(env, cfg, torch.Generator().manual_seed(20 + s))
        np.testing.assert_allclose(batch.mu_0ts[s].numpy(),
                                   serial.mu_0ts.numpy(), rtol=0, atol=TIGHT)
        np.testing.assert_allclose(batch.rews_trace[s].numpy(),
                                   serial.rews_trace.numpy(), rtol=0,
                                   atol=TIGHT)
        assert abs(float(batch.final_reward[s])
                   - float(serial.final_reward)) <= TIGHT


@pytest.mark.parametrize("method", ["mppi", "cem", "cma-es"])
def test_path_integral_batched_updates_match_jax(method):
    """The port's update rules applied per seed (``mbd.per_seed``, as
    path_integral.plan_batch applies them) against JAX's
    jax.vmap(update_fn) with the valid mask riding along (port of
    tests/test_plan_batch.py::test_path_integral_batched_updates_match_loop,
    held against JAX's functions): μ and σ to atol 1e-6."""
    rng = np.random.RandomState(0)
    S, N, H, nu = 3, 16, 5, 2
    kw = dict(update_method=method, Nsample=N, Hsample=H, cem_elite=4)
    jfn, tfn = jax_pi._UPDATE_FNS[method], pi.UPDATE_FNS[method]
    jcfg, tcfg = jax_pi.PathIntegralConfig(**kw), pi.PathIntegralConfig(**kw)
    weights = np.asarray(jax.nn.softmax(jnp.asarray(rng.randn(S, N)),
                                        axis=1), np.float32)
    Y0s = rng.randn(S, N, H, nu).astype(np.float32)
    sigma = np.abs(rng.randn(S)).astype(np.float32)
    mu = rng.randn(S, H, nu).astype(np.float32)
    valid = rng.rand(S, N) > 0.3
    valid[2] = False                    # a seed with no clean sample

    jmu, jsig = jax.vmap(lambda w, y, s, m, v: jfn(w, y, s, m, jcfg,
                                                   valid=v))(
        *map(jnp.asarray, (weights, Y0s, sigma, mu, valid)))
    tmu, tsig = mbd.per_seed(
        lambda w, y, s, m, v: tfn(w, y, s, m, tcfg, v),
        *map(torch.tensor, (weights, Y0s, sigma, mu, valid)))
    np.testing.assert_allclose(np.asarray(jmu), tmu.numpy(), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(jsig), tsig.numpy(), rtol=0,
                               atol=1e-6)
