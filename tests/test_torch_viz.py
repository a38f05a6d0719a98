"""The port's viewer (mbd_tpu_torch/viz/html.py) and the link poses it
draws (rollout/fused.py::states_from_qs, rollout/rollout.py::
rollout_states) against the JAX package's (mbd_tpu/viz/html.py,
mbd_tpu/rollout/fused.py), on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mbd_tpu import envs as jax_envs
from mbd_tpu.rollout.fused import states_from_qs as jax_states_from_qs
from mbd_tpu.viz import html as jax_html
from mbd_tpu_torch import envs
from mbd_tpu_torch.rollout.fused import states_from_qs
from mbd_tpu_torch.rollout.rollout import rollout_states
from mbd_tpu_torch.viz import html


def _poses(sys, T, seed=0):
    rng = np.random.default_rng(seed)
    nlink = sys.nbody - 1
    pos = rng.normal(size=(T, nlink, 3)).astype(np.float32)
    rot = rng.normal(size=(T, nlink, 4)).astype(np.float32)
    return pos, rot / np.linalg.norm(rot, axis=-1, keepdims=True)


@pytest.mark.parametrize("name", ["hopper", "pushT", "ant", "humanoidtrack"])
def test_render_is_byte_identical_to_jax(name):
    """The same link poses (and a ghost trajectory) render to the same
    page, byte for byte, from each package's own model: capsules
    (hopper), boxes and spheres (pushT), a free root (ant), and the
    marker bodies of the demo (humanoidtrack)."""
    jsys = jax_envs.get_env(name).sys
    tsys = envs.get_env(name, device="cpu").sys
    pos, rot = _poses(tsys, 5)
    ghost = _poses(tsys, 3, seed=1)
    kw = dict(dt=0.04, title=f"{name} (mbd)")
    page = html.render(tsys, pos, rot, ghost_trajs=[ghost], **kw)
    assert page == jax_html.render(jsys, pos, rot, ghost_trajs=[ghost], **kw)
    # torch tensors are copied to the host
    assert html.render(tsys, torch.from_numpy(pos), torch.from_numpy(rot),
                       ghost_trajs=[ghost], **kw) == page


def test_states_from_qs_matches_jax():
    """A hopper trace [H = 3, nq, B = 4] with its velocities: q, qd, the
    link poses and velocities to atol 1e-5 (float32 forward kinematics in
    two orders); without the velocities the same poses, and qd and xd
    None."""
    env = envs.get_env("hopper", device="cpu")
    sys = env.sys
    rng = np.random.default_rng(0)
    H, B = 3, 4
    qs = (sys.host("init_q")[None, :, None]
          + 0.3 * rng.normal(size=(H, sys.nq, B))).astype(np.float32)
    qds = rng.normal(size=(H, sys.nv, B)).astype(np.float32)
    ref = jax_states_from_qs(jax_envs.get_env("hopper").sys,
                             jnp.asarray(qs), jnp.asarray(qds))
    out = states_from_qs(sys, torch.from_numpy(qs), torch.from_numpy(qds))
    for a, b in ((ref.q, out.q), (ref.qd, out.qd), (ref.x.pos, out.x.pos),
                 (ref.x.rot, out.x.rot), (ref.xd.vel, out.xd.vel),
                 (ref.xd.ang, out.xd.ang)):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=0,
                                   atol=1e-5)
    poses = states_from_qs(sys, torch.from_numpy(qs))
    assert poses.qd is None and poses.xd is None
    assert torch.equal(poses.x.pos, out.x.pos)
    assert torch.equal(poses.x.rot, out.x.rot)


def test_rollout_states_are_the_env_steps():
    """rollout_states of a plan equals stepping the env through it: q and
    the link poses after each step, to atol 1e-6 (the same engine, one
    sample, the poses by one folded forward-kinematics pass)."""
    env = envs.get_env("cartpole", device="cpu")
    state = env.reset(torch.Generator().manual_seed(0))
    us = torch.rand((4, env.action_size),
                    generator=torch.Generator().manual_seed(1)) * 2 - 1
    states = rollout_states(env, state, us)
    assert states.q.shape == (4, env.sys.nq)
    assert states.x.pos.shape == (4, env.sys.nbody - 1, 3)
    for t in range(4):
        state = env.step(state, us[t])
        ps = state.pipeline_state
        for a, b in ((ps.q, states.q[t]), (ps.x.pos, states.x.pos[t]),
                     (ps.x.rot, states.x.rot[t])):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=1e-6)
