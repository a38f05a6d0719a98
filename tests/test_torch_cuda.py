"""The CUDA rollout kernel against its plain version on the card.

These tests need a CUDA card and ``nvcc`` (the kernel is built from
``mbd_tpu_torch/csrc/rollout.cu`` at first use) and skip without them.
They import neither JAX nor MuJoCo, so they run on a machine that has
only PyTorch for CUDA; there, skip the repository's conftest (it sets up
JAX):

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerance: rewards to atol 1e-5, the CPU tests' tolerance
(tests/test_torch_rollout.py); the kernel, built with ``--fmad=false``,
agrees with the plain version bit for bit. Validity flags equal.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mbd_tpu_torch import envs
from mbd_tpu_torch.ops import rollout_cuda
from mbd_tpu_torch.rollout.fused import rollout_rewards

ATOL = 1e-5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name,N,per_sample", [
    ("hopper", 256, False), ("walker2d", 256, False),
    ("halfcheetah", 256, False), ("cartpole", 256, False),
    ("hopper", 257, False), ("walker2d", 64, True), ("ant", 256, False),
    ("humanoidrun", 256, False), ("humanoidstandup", 256, False),
    ("humanoidrun", 64, True)])
def test_kernel_matches_plain_version(card, name, N, per_sample):
    env = envs.get_env(name, device=card)
    gen = torch.Generator(card).manual_seed(0)
    state0 = env.reset(gen)
    if per_sample:
        ps = state0.pipeline_state
        q = ps.q[:, None] + 0.01 * torch.randn(
            (env.sys.nq, N), generator=gen, device=card)
        state0 = SimpleNamespace(pipeline_state=SimpleNamespace(
            q=q.contiguous(),
            qd=ps.qd[:, None].expand(env.sys.nv, N).contiguous()))
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
