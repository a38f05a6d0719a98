"""The port's RL envs (``mbd_tpu_torch/rl/batched_env.py`` and
``rl/wrappers.py``) against the JAX package's on the same states and
actions, as ``tests/test_rl_batched_env.py`` holds JAX's two paths.

``BatchedTrainEnv.step`` (the rollout kernel's state-out mode on the card,
its plain version here) from JAX's resets, at B = 4 over 6 steps with an
episode of 4, so that the truncation and the auto-reset are crossed: the
first step at 1e-5, the later ones by the drift ROADMAP.md Queue 3 states
for chaotic rollouts (observations within 2e-4 and rewards within 2e-3,
the tolerances of ``tests/test_rl_batched_env.py``, which holds JAX's own
two engines to each other); done and truncation equal. The wrappers on
car2d, an analytic env, at 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mbd_tpu import envs as jax_envs
from mbd_tpu.rl import wrappers as jw
from mbd_tpu.rl.batched_env import BatchedEnvState as JState
from mbd_tpu.rl.batched_env import BatchedTrainEnv as JTrainEnv
from mbd_tpu_torch import envs
from mbd_tpu_torch.ops import rollout_cuda
from mbd_tpu_torch.rl import wrappers
from mbd_tpu_torch.rl.batched_env import BatchedTrainEnv, TrainEnv

B = 4
EP_LEN = 4
N_STEPS = 6      # crosses the truncation boundary


def t(x):
    return torch.tensor(np.asarray(x))


@pytest.mark.parametrize("env_name", ["hopper", "ant", "pushT"])
def test_batched_train_env_matches_jax(env_name):
    jenv = jax_envs.get_env(env_name)
    env = envs.get_env(env_name, device="cpu")
    keys = jax.random.split(jax.random.PRNGKey(7), B)
    acts = 0.3 * jax.random.normal(jax.random.PRNGKey(3),
                                   (N_STEPS, B, env.action_size))
    states = jax.vmap(jenv.reset)(keys)
    q = jnp.transpose(states.pipeline_state.q)
    qd = jnp.transpose(states.pipeline_state.qd)
    jstate = JState(q=q, qd=qd, obs=jnp.transpose(jenv.obs_qs_b(q, qd)),
                    steps=jnp.zeros(B, q.dtype))
    jfirst, jstep = jstate, jax.jit(JTrainEnv(jenv, EP_LEN).step)
    benv = BatchedTrainEnv(env, EP_LEN)
    state = benv.from_states(t(q), t(qd))
    first = state
    np.testing.assert_allclose(state.obs, jstate.obs, rtol=0, atol=1e-6)
    for step in range(N_STEPS):
        jnxt, jrew, jdone, jtrunc = jstep(jstate, jfirst, acts[step])
        nxt, rew, done, trunc = benv.step(state, first, t(acts[step]))
        atol_obs, atol_rew = (1e-5, 1e-5) if step == 0 else (2e-4, 2e-3)
        np.testing.assert_allclose(nxt.obs, jnxt.obs, rtol=atol_obs,
                                   atol=atol_obs,
                                   err_msg=f"{env_name} obs, step {step}")
        np.testing.assert_allclose(rew, jrew, rtol=atol_rew, atol=atol_rew,
                                   err_msg=f"{env_name} reward, step {step}")
        np.testing.assert_array_equal(done, jdone)
        np.testing.assert_array_equal(trunc, jtrunc)
        np.testing.assert_array_equal(nxt.steps, jnxt.steps)
        state, jstate = nxt, jnxt


def test_truncation_and_autoreset_bookkeeping():
    """Done and truncation at the episode's limit, then the cached first
    state (the port's counterpart of JAX's test of the same name)."""
    env = envs.get_env("hopper", device="cpu")
    benv = BatchedTrainEnv(env, EP_LEN)
    state = benv.reset(torch.Generator().manual_seed(0), B)
    first = state
    acts = torch.zeros((B, env.action_size))
    for _ in range(EP_LEN - 1):
        state, _, done, trunc = benv.step(state, first, acts)
        assert not done.any() and not trunc.any()
    state, _, done, trunc = benv.step(state, first, acts)
    assert done.all() and trunc.all()
    assert torch.equal(state.q, first.q) and torch.equal(state.obs, first.obs)
    assert not state.steps.any()


def test_guard_rolls_back_flagged_samples():
    """A sample whose joint speed passes the envelope is rolled back to
    its pre-step state with the penalty, done and no truncation, and the
    step is one call of the state-out wrapper (no launch on the CPU)."""
    env = envs.get_env("hopper", device="cpu")
    benv = BatchedTrainEnv(env, EP_LEN)
    state = benv.reset(torch.Generator().manual_seed(1), B)
    state.qd[0, 1] = 150.0
    launches = rollout_cuda.LAUNCHES
    nxt, rew, done, trunc = benv.step(state, state,
                                      torch.zeros((B, env.action_size)))
    assert rollout_cuda.LAUNCHES == launches
    assert float(rew[1]) == -10.0 and float(done[1]) == 1.0
    assert float(trunc[1]) == 0.0
    assert not done[[0, 2, 3]].any()
    # done → auto-reset to the first state, which here is the flagged one
    assert torch.equal(nxt.qd[:, 1], state.qd[:, 1])


def test_wrappers_match_jax_on_car2d():
    """``wrap_for_training`` on car2d, 3 envs over 5 steps with an episode
    of 2 (truncation, then the auto-reset), and one action NaN so that the
    guard rolls a step back: observations, rewards, done, truncation and
    steps at 1e-6 against JAX's vmapped wrappers."""
    jenv = jax_envs.get_env("car2d")
    env = envs.get_env("car2d", device="cpu")
    acts = np.random.default_rng(0).uniform(-1, 1, (5, 3, 2)).astype(
        np.float32)
    acts[1, 2] = np.nan
    jwrapped = jw.wrap_for_training(jenv, 2)
    jstate = jax.vmap(jwrapped.reset)(jax.random.split(jax.random.PRNGKey(0),
                                                       3))
    jstep = jax.jit(jax.vmap(jwrapped.step))
    wrapped = wrappers.wrap_for_training(env, 2)
    state = wrappers.batched_reset(wrapped, torch.Generator(), 3)
    for a in acts:
        jstate, state = jstep(jstate, a), wrapped.step(state, t(a))
        for k in ("obs", "reward", "done", "pipeline_state"):
            np.testing.assert_allclose(getattr(state, k),
                                       getattr(jstate, k), rtol=0,
                                       atol=1e-6, err_msg=k)
        for k in ("steps", "truncation"):
            np.testing.assert_array_equal(state.metrics[k],
                                          jstate.metrics[k])


def test_guard_penalises_a_nan_step_on_car2d():
    """The guard on car2d: a NaN action's step is rolled back with the
    penalty −10 and done, in both packages."""
    jenv = jw.DivergenceGuardWrapper(jax_envs.get_env("car2d"))
    env = wrappers.DivergenceGuardWrapper(envs.get_env("car2d",
                                                       device="cpu"))
    js = jenv.reset(jax.random.PRNGKey(0))
    s = env.reset(torch.Generator())
    a = np.array([np.nan, 0.5], np.float32)
    jn, n = jenv.step(js, jnp.asarray(a)), env.step(s, t(a))
    assert float(n.reward) == float(jn.reward) == -10.0
    assert float(n.done) == float(jn.done) == 1.0
    np.testing.assert_array_equal(n.pipeline_state, jn.pipeline_state)


def test_train_env_takes_the_kernel_path_for_physics_envs():
    """``TrainEnv``: a physics env steps through ``BatchedTrainEnv`` (the
    state-out mode), car2d through the wrappers."""
    assert TrainEnv(envs.get_env("hopper", device="cpu"), 5).batch_last
    assert not TrainEnv(envs.get_env("car2d", device="cpu"), 5).batch_last
    with pytest.raises(ValueError):
        TrainEnv(envs.get_env("hopper", device="cpu"), 5, action_repeat=2)
