"""The port's planner (mbd_tpu_torch/planners/mbd.py) and schedule against
the JAX ones (mbd_tpu/planners/mbd.py, mbd_tpu/core/schedule.py), on the
CPU. Random streams differ between the packages, so the port is handed
JAX's reset state and JAX's noise, reproduced from JAX's key splits."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mbd_tpu import envs as jax_envs
from mbd_tpu.core.schedule import make_schedule as jax_schedule
from mbd_tpu.planners import mbd as jax_mbd
from mbd_tpu_torch import envs
from mbd_tpu_torch.core.schedule import DiffusionSchedule, make_schedule
from mbd_tpu_torch.envs import State
from mbd_tpu_torch.planners import mbd

SCHED_FIELDS = ("betas", "alphas", "alphas_bar", "sigmas", "sigmas_cond")


@pytest.mark.parametrize("n", [6, 100, 300])
def test_schedule_matches_jax(n):
    """atol 2e-6: XLA forms the cumprod as a reduce_window and the
    linspace's quotient in its own order, so float32 last bits differ
    (measured at most 1.1e-6, on sigmas at n = 300)."""
    js, ts = jax_schedule(n), make_schedule(n, device="cpu")
    for k in SCHED_FIELDS:
        a, b = np.asarray(getattr(js, k)), getattr(ts, k).numpy()
        assert b.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-6, err_msg=k)


def _port_state(env, q, qd):
    ps = env.pipeline_init(torch.tensor(np.asarray(q)),
                           torch.tensor(np.asarray(qd)))
    return State(ps, env._obs(ps), torch.zeros(()), torch.zeros(()))


def test_reverse_step_matches_jax():
    """One reverse step from the same Ȳ, noise, schedule and reset state:
    Ȳᵢ₋₁ and the mean reward to atol 1e-5.

    At temperature 1: the softmax multiplies a reward difference by
    1/(σ·temp), and with 16 samples at H = 5 the rewards' σ is 0.022, so
    at the recommended 0.1 the rollouts' float32 differences (3.7e-7,
    XLA's reassociation against the torch order) would move the weights
    by 1.7e-4 and Ȳ by 1.4e-5. The update's formula is the same at any
    temperature; the slice below runs at 0.1."""
    name = "hopper"
    cfg = dict(Nsample=16, Hsample=5, Ndiffuse=8, temp_sample=1.0)
    i = cfg["Ndiffuse"] - 1
    jenv, tenv = jax_envs.get_env(name), envs.get_env(name, device="cpu")
    jstate = jenv.reset(jax.random.PRNGKey(0))
    jsched = jax_schedule(cfg["Ndiffuse"])
    Ybar = np.random.default_rng(0).uniform(
        -0.5, 0.5, (cfg["Hsample"], jenv.action_size)).astype(np.float32)
    rng = jax.random.PRNGKey(3)

    step = jax_mbd.make_reverse_once(jenv, jax_mbd.MBDConfig(**cfg), jstate,
                                     jsched, engine="fused")
    (_, jY), (_, jrew) = jax.jit(step)((rng, jnp.asarray(Ybar)), i)

    _, key = jax.random.split(rng)                 # mbd.py:224-225
    eps = np.asarray(jax.random.normal(
        key, (cfg["Nsample"], cfg["Hsample"], jenv.action_size)))
    tsched = DiffusionSchedule(*(torch.tensor(np.asarray(getattr(jsched, k)))
                                 for k in SCHED_FIELDS))
    tstep = mbd.make_reverse_once(
        tenv, mbd.MBDConfig(**cfg),
        _port_state(tenv, jstate.pipeline_state.q, jstate.pipeline_state.qd),
        tsched)
    tY, trew = tstep(torch.from_numpy(Ybar), i, torch.tensor(eps))
    np.testing.assert_allclose(np.asarray(jY), tY.numpy(), rtol=0, atol=1e-5)
    assert abs(float(jrew) - float(trew)) <= 1e-5


def _plan_matches_jax(name, cfg):
    """Plan ``name`` in both packages from JAX's reset state and JAX's
    noise stream; returns (JAX result, port result, progress calls)."""
    jenv, tenv = jax_envs.get_env(name), envs.get_env(name, device="cpu")
    jres = jax_mbd.plan(jenv, jax_mbd.MBDConfig(**cfg),
                        jax.random.PRNGKey(0), engine="fused")

    rng, rng_reset = jax.random.split(jax.random.PRNGKey(0))   # mbd.py:668
    jstate = jenv.reset(rng_reset).pipeline_state
    rng_exp, _ = jax.random.split(rng)                          # mbd.py:671
    eps = []
    for _ in range(cfg["Ndiffuse"] - 1):
        rng_exp, key = jax.random.split(rng_exp)                # mbd.py:224
        eps.append(np.asarray(jax.random.normal(
            key, (cfg["Nsample"], cfg["Hsample"], jenv.action_size))))
    progress = []
    tres = mbd.plan(tenv, mbd.MBDConfig(**cfg), torch.Generator(),
                    state_init=_port_state(tenv, jstate.q, jstate.qd),
                    chunk_size=2, progress_fn=lambda *a: progress.append(a),
                    eps=torch.tensor(np.stack(eps)))

    T = cfg["Ndiffuse"] - 1
    assert tres.Ybars.shape == (T, cfg["Hsample"], tenv.action_size)
    np.testing.assert_allclose(np.asarray(jres.rews_trace),
                               tres.rews_trace.numpy(), rtol=0, atol=5e-3)
    assert abs(float(jres.final_reward) - float(tres.final_reward)) <= 5e-3
    assert tres.final_diverged == bool(jres.final_diverged)
    return jres, tres, progress


def test_plan_matches_jax_hopper():
    """The slice as a whole: hopper at Nsample=16, Hsample=10, Ndiffuse=6
    from JAX's reset state and JAX's noise stream. rews_trace and
    final_reward to atol 5e-3, the tolerance tests/test_fused_planner.py
    :20-21 states for the same chaos (measured 1.4e-7)."""
    _, tres, progress = _plan_matches_jax(
        "hopper", dict(Nsample=16, Hsample=10, Ndiffuse=6))
    assert [p[0] for p in progress] == [2, 4, 5]
    assert progress[-1][1] == pytest.approx(float(tres.rews_trace[-1]))


def test_plan_matches_jax_ant():
    """A free-root model through the same slice: ant at Nsample=16,
    Hsample=10, Ndiffuse=6, to the same atol 5e-3."""
    _plan_matches_jax("ant", dict(Nsample=16, Hsample=10, Ndiffuse=6))


def test_plan_humanoidrun_on_cpu():
    """The flagship model's plan at a tiny size on the CPU (JAX cannot
    compile a humanoid engine here in reasonable time, so this one is
    torch only): shapes, finite outputs, and a clean final plan."""
    env = envs.get_env("humanoidrun", device="cpu")
    cfg = mbd.MBDConfig(Nsample=8, Hsample=3, Ndiffuse=3,
                        temp_sample=mbd.TEMP_RECOMMEND["humanoidrun"])
    res = mbd.plan(env, cfg, torch.Generator().manual_seed(0))
    assert res.Ybars.shape == (2, 3, env.action_size)
    assert res.rews_trace.shape == (2,)
    assert torch.isfinite(res.Ybars).all()
    assert torch.isfinite(res.rews_trace).all()
    assert torch.isfinite(res.final_reward)
    assert res.final_diverged is False


def test_plan_draws_from_generator_and_refuses_demo():
    """Without ``eps`` the noise comes from the generator: two plans from
    equal seeds agree; ``enable_demo`` on an env without a demo (cartpole)
    is refused."""
    env = envs.get_env("cartpole", device="cpu")
    cfg = mbd.MBDConfig(Nsample=8, Hsample=4, Ndiffuse=3)
    r1 = mbd.plan(env, cfg, torch.Generator().manual_seed(5))
    r2 = mbd.plan(env, cfg, torch.Generator().manual_seed(5))
    assert torch.equal(r1.Ybars, r2.Ybars)
    assert torch.isfinite(r1.rews_trace).all()
    with pytest.raises(ValueError, match="demo"):
        mbd.plan(env, mbd.MBDConfig(Nsample=8, Hsample=4, Ndiffuse=3,
                                    enable_demo=True),
                 torch.Generator().manual_seed(5))


def test_recommended_config():
    cfg = mbd.recommended_config("hopper")
    assert (cfg.Nsample, cfg.Hsample, cfg.Ndiffuse, cfg.temp_sample) == (
        2048, 50, 100, 0.1)
    for name in ("halfcheetah", "pushT", "humanoidrun"):
        assert mbd.recommended_config(name) == mbd.MBDConfig(
            **vars(jax_mbd.recommended_config(name)))
