"""The port's humanoidtrack env (mbd_tpu_torch/envs/humanoidtrack.py)
against the JAX one (mbd_tpu/envs/humanoidtrack.py) on the CPU: the demo
clips, the reset, the batch-last reward, the tracked bodies' positions and
the demo log-density, from the same inputs made with numpy from a seed.

The JAX functions run op by op (``jax.disable_jit``), as in
tests/test_torch_engine.py: no humanoid program is compiled here.
Tolerances: the reward to 1e-6 (a few float32 operations on the same
values); positions and the log-density to 1e-5, the engine tests' atol,
since both go through the forward kinematics' sin and cos, whose last bit
XLA's CPU and torch round differently.
"""

import jax
import numpy as np
import pytest
import torch

from mbd_tpu import envs as jax_envs
from mbd_tpu_torch import envs
from mbd_tpu_torch.sim import batched as TB

NAMES = ("humanoidtrack", "humanoidtrack_walk")


@pytest.fixture(scope="module")
def pair():
    return (jax_envs.get_env("humanoidtrack"),
            envs.get_env("humanoidtrack", device="cpu"))


def _near_init(sys, rng, shape, scale=0.1):
    """q [nq, *shape] near init_q, with a unit root quaternion."""
    q = np.asarray(sys.init_q).reshape((-1,) + (1,) * len(shape)) \
        + rng.normal(size=(sys.nq,) + shape) * scale
    q[3:7] /= np.linalg.norm(q[3:7], axis=0)
    return q.astype(np.float32)


@pytest.mark.parametrize("name", NAMES)
def test_xref_matches_jax(name):
    """The jog clip padded to 50 frames, the walk clip's frames 70:120,
    read from the port's own copies: equal to JAX's, bit for bit, also in
    the kernel's [50, 5, 3] layout."""
    jenv, tenv = jax_envs.get_env(name), envs.get_env(name, device="cpu")
    assert tenv.xref.shape == (5, 50, 3)
    np.testing.assert_array_equal(np.asarray(jenv.xref), tenv.xref.numpy())
    np.testing.assert_array_equal(                   # the kernel's layout
        np.asarray(jenv.xref).transpose(1, 0, 2), tenv.xref_frames.numpy())
    assert tenv.rew_xref == jenv.rew_xref == 1.0
    assert tenv.track_body_ids == tuple(
        int(i) + 1 for i in np.asarray(jenv.track_body_idx))


def test_reset_matches_jax(pair):
    jenv, tenv = pair
    with jax.disable_jit():
        js = jenv.reset(jax.random.PRNGKey(0))
    ts = tenv.reset(torch.Generator().manual_seed(3))
    jp, tp = js.pipeline_state, ts.pipeline_state
    np.testing.assert_array_equal(np.asarray(jp.q), tp.q.numpy())
    np.testing.assert_array_equal(np.asarray(jp.qd), tp.qd.numpy())
    for a, b in ((jp.x.pos, tp.x.pos), (jp.x.rot, tp.x.rot),
                 (jp.xd.vel, tp.xd.vel), (jp.xd.ang, tp.xd.ang),
                 (js.obs, ts.obs)):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=0,
                                   atol=1e-6)
    assert float(ts.done) == 0.0 and float(ts.reward) == 0.0


def test_reward_qs_b_matches_jax(pair):
    """The reward from the pre-step states: step t scores the state after
    step t − 1 (q0, qd0 for the first)."""
    jenv, tenv = pair
    sys = tenv.sys
    H, N = 6, 16
    rng = np.random.default_rng(7)
    qs = (np.asarray(sys.init_q)[None, :, None]
          + rng.normal(size=(H, sys.nq, N)) * 0.5).astype(np.float32)
    qds = rng.normal(size=(H, sys.nv, N)).astype(np.float32)
    us = rng.uniform(-1, 1, (H, sys.nu, N)).astype(np.float32)
    q0 = _near_init(sys, rng, (N,), 0.5)
    qd0 = rng.normal(size=(sys.nv, N)).astype(np.float32)
    r_j = np.asarray(jenv.reward_qs_b(qs, qds, us, q0, qd0))
    r_t = tenv.reward_qs_b(*map(torch.from_numpy, (qs, qds, us, q0, qd0)))
    assert r_t.shape == (H, N)
    np.testing.assert_allclose(r_j, r_t.numpy(), rtol=0, atol=1e-6)
    first = tenv.reward_qs_b(*map(torch.from_numpy, (qs[:1], qds[:1],
                                                     us[:1], q0, qd0)))
    torch.testing.assert_close(first[0], r_t[0], rtol=0, atol=0)


def test_track_xpos_b_matches_jax(pair):
    jenv, tenv = pair
    q = _near_init(tenv.sys, np.random.default_rng(8), (12,))
    with jax.disable_jit():
        x_j = np.asarray(jenv.track_xpos_b(q))
    x_t = tenv.track_xpos_b(torch.from_numpy(q))
    assert x_t.shape == (5, 3, 12)
    np.testing.assert_allclose(x_j, x_t.numpy(), rtol=0, atol=1e-5)


def test_traj_xref_logpd_qs_matches_jax(pair):
    """The demo log-density of position traces [H, nq, N] near the
    initial pose, where the tracked bodies sit within the clip's 0.5 m
    (so the clip is not saturated and the score varies per sample)."""
    jenv, tenv = pair
    qs = _near_init(tenv.sys, np.random.default_rng(9), (4, 6)
                    ).transpose(1, 0, 2)                   # [H, nq, N]
    with jax.disable_jit():
        l_j = np.asarray(jenv.traj_xref_logpd_qs(qs))
    l_t = tenv.traj_xref_logpd_qs(torch.from_numpy(np.ascontiguousarray(qs)))
    assert l_t.shape == (6,) and float(l_t.std()) > 0
    np.testing.assert_allclose(l_j, l_t.numpy(), rtol=0, atol=1e-5)


def test_step_counts_and_moves_markers(pair):
    """Two eager steps: ``done`` counts them, the ``*_ref`` marker bodies
    sit on demo frames 0 and 1, the reward is the pre-step state's (JAX's
    reward function on the same state), and q is the engine's env step."""
    jenv, tenv = pair
    with jax.disable_jit():
        js = jenv.reset(jax.random.PRNGKey(0))
    state = tenv.reset(torch.Generator())
    u = torch.from_numpy(np.random.default_rng(10).uniform(
        -1, 1, tenv.action_size).astype(np.float32))
    for t in range(2):
        prev = state.pipeline_state
        state = tenv.step(state, u)
        assert float(state.done) == t + 1
        for i, link in enumerate(tenv.ref_link_idx):
            assert torch.equal(state.pipeline_state.x.pos[link],
                               tenv.xref[i, t])
        q, qd = TB.env_step_b(tenv.sys, prev.q[:, None], prev.qd[:, None],
                              u[:, None], tenv.n_frames)
        assert torch.equal(state.pipeline_state.q, q[:, 0])
        assert torch.equal(state.pipeline_state.qd, qd[:, 0])
        assert torch.equal(state.reward, tenv._reward(prev))
    with jax.disable_jit():
        r_j = float(jenv._reward_ps(js.pipeline_state))
    first = tenv.step(tenv.reset(torch.Generator()), u)
    assert float(first.reward) == pytest.approx(r_j, abs=1e-6)
