"""PPO on the port's sample mesh, on the CPU: the counterpart of
``tests/test_rl_mesh.py``.

Each of two gloo ranks steps half of the envs and the unroll is gathered
onto both; the update runs on the whole batch on every rank. Held, as
JAX holds its meshed PPO, at rtol / atol 1e-4 against one process, and
every rank's parameters must equal every other's.
"""

import pytest
import torch

import torch_mesh_ranks as R
from mbd_tpu_torch import envs
from mbd_tpu_torch.parallel import SampleMesh, start_ranks
from mbd_tpu_torch.rl import ppo


def test_meshed_ppo_matches_one_process():
    ranks = start_ranks(R.ppo_case, 2, device="cpu")
    with R.one_thread():
        single = R.ppo_case(None)
    outs = ranks.wait()
    torch.testing.assert_close(outs[0]["eval"], single["eval"], rtol=1e-4,
                               atol=1e-4)
    for k, v in single["params"].items():
        torch.testing.assert_close(outs[0]["params"][k], v, rtol=1e-4,
                                   atol=1e-4)
        assert torch.equal(outs[1]["params"][k], outs[0]["params"][k]), k
    assert outs[1]["eval"] == outs[0]["eval"]


def test_meshed_ppo_rejects_bad_config():
    mesh = SampleMesh(group=None, rank=0, size=2, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="num_envs=3"):
        ppo.train(envs.get_env("hopper", device="cpu"),
                  ppo.PPOConfig(num_envs=3), mesh=mesh)
    with pytest.raises(ValueError, match="batch-last"):
        ppo.train(envs.get_env("car2d", device="cpu"),
                  ppo.PPOConfig(num_envs=2), mesh=mesh)
