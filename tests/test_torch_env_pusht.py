"""The port's pushT env (mbd_tpu_torch/envs/pushT.py) against the JAX one
(mbd_tpu/envs/pushT.py) on the CPU: the batch-last reward and done, the
per-state reward, observation and step, the reset and the pipeline state
it builds, and the recommended planner config, from the same inputs made
with numpy from a seed.

Tolerance 1e-6: the reward is a few float32 operations on the same
values, and one env step from the reset touches no contact (the pusher
starts 0.05 clear of the slider), so the two engines' substeps agree to
their last bits.
"""

import jax
import numpy as np
import pytest
import torch

from mbd_tpu import envs as jax_envs
from mbd_tpu.planners import mbd as jax_mbd
from mbd_tpu_torch import envs
from mbd_tpu_torch.planners import mbd

ATOL = 1e-6


@pytest.fixture(scope="module")
def pair():
    return jax_envs.get_env("pushT"), envs.get_env("pushT", device="cpu")


def _qs(rng, shape, near_goal=False):
    """q [*shape[:-1], nq, N]: pusher, slider and goal poses; with
    ``near_goal`` the slider within a few cm and degrees of the goal and
    the pusher beside it, so that some rewards pass 0.95."""
    q = np.empty(shape[:-1] + (8, shape[-1]), np.float32)
    q[..., 2:4, :] = rng.uniform(-0.6, 0.6, q[..., 2:4, :].shape)
    q[..., 4, :] = rng.uniform(-4.0, 4.0, q[..., 4, :].shape)
    if near_goal:
        q[..., 5:8, :] = q[..., 2:5, :] + rng.normal(
            size=q[..., 2:5, :].shape) * 0.03
        q[..., 0:2, :] = q[..., 2:4, :] + rng.uniform(
            -0.15, 0.15, q[..., 0:2, :].shape)
    else:
        q[..., 5:7, :] = rng.uniform(-0.6, 0.4, q[..., 5:7, :].shape)
        q[..., 7, :] = rng.uniform(2.3, 4.0, q[..., 7, :].shape)
        q[..., 0:2, :] = rng.uniform(-1.0, 1.0, q[..., 0:2, :].shape)
    return q


def test_reward_qs_b_matches_jax(pair):
    jenv, tenv = pair
    H, N = 6, 32
    rng = np.random.default_rng(7)
    qs = _qs(rng, (H, N))
    qds = rng.normal(size=(H, 8, N)).astype(np.float32)
    us = rng.uniform(-1, 1, (H, 2, N)).astype(np.float32)
    q0, qd0 = qs[0], qds[0]
    r_j = np.asarray(jenv.reward_qs_b(qs, qds, us, q0, qd0))
    r_t = tenv.reward_qs_b(*map(torch.from_numpy, (qs, qds, us, q0, qd0)))
    assert r_t.shape == (H, N)
    np.testing.assert_allclose(r_j, r_t.numpy(), rtol=0, atol=ATOL)


def test_rl_done_qs_b_matches_jax(pair):
    """Done on success (reward > 0.95), with samples on both sides."""
    jenv, tenv = pair
    rng = np.random.default_rng(3)
    q = _qs(rng, (64,), near_goal=True)
    qd = rng.normal(size=(8, 64)).astype(np.float32)
    d_j = np.asarray(jenv.rl_done_qs_b(q, qd))
    d_t = tenv.rl_done_qs_b(torch.from_numpy(q), torch.from_numpy(qd))
    np.testing.assert_array_equal(d_j, d_t.numpy())
    assert 0 < d_t.sum() < 64


@pytest.mark.parametrize("seed", [0, 1])
def test_reward_obs_done_match_jax(pair, seed):
    """``_reward``, ``_obs`` and ``_done`` of the pipeline state each
    package builds from the same q, qd."""
    jenv, tenv = pair
    rng = np.random.default_rng(seed)
    q = _qs(rng, (1,), near_goal=seed == 1)[:, 0]
    qd = rng.normal(size=8).astype(np.float32)
    jps = jenv.pipeline_init(q, qd)
    tps = tenv.pipeline_init(torch.from_numpy(q), torch.from_numpy(qd))
    np.testing.assert_allclose(float(jenv._reward(jps)),
                               float(tenv._reward(tps)), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(np.asarray(jenv._obs(jps)),
                                  tenv._obs(tps).numpy())
    assert float(jenv._done(jps)) == float(tenv._done(tps))
    assert tenv._obs(tps).shape == (tenv.observation_size,) == (16,)


def test_reset(pair):
    """The pusher pinned at (0.1, −0.15), the slider at its init pose, qd
    0, the goal inside its box around (−0.4, 0.4, π), and the reward and
    done of that state."""
    _, tenv = pair
    for seed in range(4):
        s = tenv.reset(torch.Generator().manual_seed(seed))
        q = s.pipeline_state.q
        assert q[:2].tolist() == pytest.approx([0.1, -0.15])
        assert q[2:5].tolist() == [0.0, 0.0, 0.0]
        lo = torch.tensor([-0.6, 0.2, np.pi * 3 / 4])
        hi = torch.tensor([-0.2, 0.6, np.pi * 5 / 4])
        assert bool(((q[5:] >= lo) & (q[5:] <= hi)).all())
        assert bool((s.pipeline_state.qd == 0).all())
        assert float(s.reward) == float(tenv._reward(s.pipeline_state))
        assert float(s.done) == 0.0
    assert tenv.action_size == 2


def test_pipeline_init_matches_jax(pair):
    """JAX's reset q through the port's ``pipeline_init``: link poses and
    velocities, observation and reward against JAX's reset state."""
    jenv, tenv = pair
    js = jenv.reset(jax.random.PRNGKey(0))
    jp = js.pipeline_state
    tp = tenv.pipeline_init(torch.tensor(np.asarray(jp.q)),
                            torch.tensor(np.asarray(jp.qd)))
    for a, b in ((jp.x.pos, tp.x.pos), (jp.x.rot, tp.x.rot),
                 (jp.xd.vel, tp.xd.vel), (jp.xd.ang, tp.xd.ang)):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=0,
                                   atol=ATOL)
    np.testing.assert_allclose(float(js.reward), float(tenv._reward(tp)),
                               rtol=0, atol=ATOL)


def test_step_matches_jax(pair):
    """One env step from JAX's reset state with the same action: q, qd,
    the reward, the observation and done."""
    jenv, tenv = pair
    js = jenv.reset(jax.random.PRNGKey(1))
    a = np.array([0.7, -0.4], np.float32)
    js1 = jax.jit(jenv.step)(js, a)
    jp = js.pipeline_state
    ts = tenv.reset(torch.Generator())
    ts = ts.replace(pipeline_state=tenv.pipeline_init(
        torch.tensor(np.asarray(jp.q)), torch.tensor(np.asarray(jp.qd))))
    ts1 = tenv.step(ts, torch.from_numpy(a))
    for x, y in ((js1.pipeline_state.q, ts1.pipeline_state.q),
                 (js1.pipeline_state.qd, ts1.pipeline_state.qd),
                 (js1.obs, ts1.obs), (js1.reward, ts1.reward)):
        np.testing.assert_allclose(np.asarray(x), y.numpy(), rtol=0,
                                   atol=ATOL)
    assert float(js1.done) == float(ts1.done)
    # the pusher moved under the action
    assert float((ts1.pipeline_state.q[:2] - ts.pipeline_state.q[:2]
                  ).abs().max()) > 1e-3


def test_recommended_config_matches_jax():
    """pushT's MBD config: Nsample 2048, Hsample 40, Ndiffuse 200,
    temperature 0.2, as JAX's."""
    cfg = mbd.recommended_config("pushT")
    assert cfg == mbd.MBDConfig(**vars(jax_mbd.recommended_config("pushT")))
    assert (cfg.Nsample, cfg.Hsample, cfg.Ndiffuse, cfg.temp_sample) == (
        2048, 40, 200, 0.2)
