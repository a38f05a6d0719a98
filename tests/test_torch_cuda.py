"""The CUDA rollout kernel against its plain version on the card.

These tests need a CUDA card and ``nvcc`` (the kernel is built from
``mbd_tpu_torch/csrc/rollout.cu`` at first use) and skip without them.
They import neither JAX nor MuJoCo, so they run on a machine that has
only PyTorch for CUDA; there, skip the repository's conftest (it sets up
JAX):

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerance: rewards, position traces and demo log-densities to atol 1e-5,
the CPU tests' tolerance (tests/test_torch_rollout.py); the kernel, built
with ``--fmad=false``, agrees with the plain version bit for bit on rewards
and traces. Validity flags equal.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mbd_tpu_torch import envs
from mbd_tpu_torch.ops import rollout_cuda
from mbd_tpu_torch.rollout.fused import rollout_outputs, rollout_rewards

ATOL = 1e-5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _state(env, gen, N, per_sample):
    """The env's reset state, or per sample with 0.01 noise on q; for
    pushT, per sample with the pusher within 0.25 of the slider's centre,
    in, beside or clear of its bars, so the sphere–box contacts are
    live."""
    state0 = env.reset(gen)
    if not per_sample:
        return state0
    ps = state0.pipeline_state
    q = ps.q[:, None] + 0.01 * torch.randn((env.sys.nq, N), generator=gen,
                                           device=ps.q.device)
    if env.sys.nq == 8:                         # pushT
        q[0:2] = q[2:4] + 0.5 * torch.rand(
            (2, N), generator=gen, device=ps.q.device) - 0.25
    return SimpleNamespace(pipeline_state=SimpleNamespace(
        q=q.contiguous(),
        qd=ps.qd[:, None].expand(env.sys.nv, N).contiguous()))


@pytest.mark.cuda
@pytest.mark.parametrize("name,N,per_sample", [
    ("hopper", 256, False), ("walker2d", 256, False),
    ("halfcheetah", 256, False), ("cartpole", 256, False),
    ("hopper", 257, False), ("walker2d", 64, True), ("ant", 256, False),
    ("humanoidrun", 256, False), ("humanoidstandup", 256, False),
    ("humanoidrun", 64, True), ("humanoidtrack", 256, False),
    ("humanoidtrack", 64, True), ("pushT", 256, False),
    ("pushT", 256, True)])
def test_kernel_matches_plain_version(card, name, N, per_sample):
    env = envs.get_env(name, device=card)
    gen = torch.Generator(card).manual_seed(0)
    state0 = _state(env, gen, N, per_sample)
    Y0s = 2 * torch.rand((N, 5, env.action_size), generator=gen,
                         device=card) - 1
    launches = rollout_cuda.LAUNCHES
    r_k, bad_k = rollout_cuda.rollout_rewards_cuda(env, state0, Y0s)
    torch.cuda.synchronize()
    assert rollout_cuda.LAUNCHES == launches + 1
    r_p, _, bad_p = rollout_rewards(env, state0, Y0s)
    assert r_k.shape == (N, 5) and bad_k.shape == (N,)
    np.testing.assert_allclose(r_k.cpu().numpy(), r_p.cpu().numpy(),
                               rtol=0, atol=ATOL)
    assert torch.equal(bad_k, bad_p)


@pytest.mark.cuda
def test_kernel_rejects_bad_inputs(card):
    env = envs.get_env("cartpole", device=card)
    state0 = env.reset(torch.Generator(card).manual_seed(0))
    with pytest.raises(TypeError):
        rollout_cuda.rollout_rewards_cuda(
            env, state0, torch.zeros((4, 3, 1), dtype=torch.float64,
                                     device=card))
    with pytest.raises(ValueError):
        rollout_cuda.rollout_rewards_cuda(
            env, state0, torch.zeros((4, 3, 2), device=card))


@pytest.mark.cuda
@pytest.mark.parametrize("name,N,need_qs,demo,per_sample", [
    ("hopper", 256, True, False, False),
    ("humanoidtrack", 255, True, True, False),
    ("humanoidtrack", 64, False, True, True),
    ("humanoidtrack_walk", 128, False, True, False),
    ("pushT", 256, True, False, True)])
def test_kernel_trace_and_demo_match_plain_version(card, name, N, need_qs,
                                                   demo, per_sample):
    """need_qs: the position trace equals the plain version's; demo: the
    log-density within 1e-5 of ``traj_xref_logpd_qs`` of the plain
    trace."""
    env = envs.get_env(name, device=card)
    gen = torch.Generator(card).manual_seed(1)
    state0 = _state(env, gen, N, per_sample)
    Y0s = 2 * torch.rand((N, 5, env.action_size), generator=gen,
                         device=card) - 1
    demos = rollout_cuda.DEMO_LAUNCHES
    out_k = rollout_cuda.rollout_rewards_cuda(env, state0, Y0s,
                                              need_qs=need_qs, demo=demo)
    torch.cuda.synchronize()
    assert rollout_cuda.DEMO_LAUNCHES == demos + int(demo)
    out_p = rollout_outputs(env, state0, Y0s, need_qs=need_qs, demo=demo)
    assert len(out_k) == len(out_p) == 2 + int(need_qs) + int(demo)
    assert torch.equal(out_k[1], out_p[1])
    for k, p in zip(out_k[:1] + out_k[2:], out_p[:1] + out_p[2:]):
        assert k.shape == p.shape
        np.testing.assert_allclose(k.cpu().numpy(), p.cpu().numpy(),
                                   rtol=0, atol=ATOL)
    if need_qs:
        assert torch.equal(out_k[2], out_p[2])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["hopper", "humanoidrun"])
@pytest.mark.parametrize("N", [1, 33, 2047, 8191])
def test_kernel_groups_match_plain_version_at_edges(card, name, N):
    """The env's G, at sample counts that leave a ragged last block (its
    groups past N roll the last sample out again and write nothing):
    rewards and the trace equal the plain version's bit for bit, flags
    equal."""
    env = envs.get_env(name, device=card)
    gen = torch.Generator(card).manual_seed(2)
    state0 = _state(env, gen, N, True)
    Y0s = 2 * torch.rand((N, 2, env.action_size), generator=gen,
                         device=card) - 1
    plain = rollout_outputs(env, state0, Y0s, need_qs=True)
    out = rollout_cuda.rollout_rewards_cuda(env, state0, Y0s, need_qs=True)
    torch.cuda.synchronize()
    for k, p in zip(out, plain):
        assert torch.equal(k, p), N


@pytest.mark.cuda
def test_kernel_layout_reported(card):
    """Built.attrs: the env's G, positive shared bytes per block, at
    least one block per SM."""
    env = envs.get_env("humanoidtrack", device=card)
    built = rollout_cuda.build(env)
    G = env.kernel_group
    for N in (2048, 8192):
        a = built.attrs(N)
        assert a["G"] == G and a["threads_per_block"] % G == 0
        assert a["shared_bytes"] > 0 and a["blocks_per_sm"] >= 1
        assert a["warps_per_sm"] == (a["blocks_per_sm"]
                                     * a["threads_per_block"] // 32)
        assert 1 <= a["sms_used"] <= torch.cuda.get_device_properties(
            card).multi_processor_count
