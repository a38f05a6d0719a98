"""The port's sample mesh (``mbd_tpu_torch/parallel/mesh.py``) on the CPU:
two gloo ranks against one process.

The counterpart of ``tests/test_mesh_engines.py``. JAX's meshed plans
agree with the unsharded ones to 5e-3 (GSPMD may reassociate the
reductions); the port's agree bit for bit, because every rank draws the
full noise, rolls out only its shard, and runs the statistics on the
gathered per-sample outputs exactly as one process does. The ranks run
``torch_mesh_ranks.planner_cases`` (one spawn for the module), while this
process runs the same cases without a mesh, both with one CPU thread. One
case starts from JAX's reset state and noise, so that the sharded plan
also meets JAX's plan on the same inputs.
"""

import jax
import numpy as np
import pytest
import torch

import torch_mesh_ranks as R
from mbd_tpu import envs as jax_envs
from mbd_tpu.planners import mbd as jax_mbd
from mbd_tpu_torch import envs
from mbd_tpu_torch.parallel import SampleMesh, start_ranks
from mbd_tpu_torch.planners import mbd
from mbd_tpu_torch.planners import path_integral as pi
from mbd_tpu_torch.rl import ppo

CASES = ("mbd", "jax_inputs", "plan_batch", "mppi", "car2d_demo",
         "checkpoint")


def _jax_inputs():
    """JAX's hopper reset state and noise stream for ``R.JAX_CFG``,
    reproduced from its key splits as tests/test_torch_planner.py does."""
    cfg, jenv = R.JAX_CFG, jax_envs.get_env("hopper")
    rng, rng_reset = jax.random.split(jax.random.PRNGKey(0))   # mbd.py:668
    jstate = jenv.reset(rng_reset).pipeline_state
    rng_exp, _ = jax.random.split(rng)                          # mbd.py:671
    eps = []
    for _ in range(cfg["Ndiffuse"] - 1):
        rng_exp, key = jax.random.split(rng_exp)                # mbd.py:224
        eps.append(np.asarray(jax.random.normal(
            key, (cfg["Nsample"], cfg["Hsample"], jenv.action_size))))
    return dict(q=torch.tensor(np.asarray(jstate.q)),
                qd=torch.tensor(np.asarray(jstate.qd)),
                eps=torch.tensor(np.stack(eps)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(one process's results, [each rank's], JAX's plan of
    ``R.JAX_CFG``)."""
    d = tmp_path_factory.mktemp("mesh")
    jax_inputs = _jax_inputs()
    ranks = start_ranks(R.planner_cases, 2, str(d / "mesh"), jax_inputs,
                        device="cpu")
    jres = jax_mbd.plan(jax_envs.get_env("hopper"),
                        jax_mbd.MBDConfig(**R.JAX_CFG),
                        jax.random.PRNGKey(0), engine="fused")
    with R.one_thread():
        single = R.planner_cases(None, str(d / "single"), jax_inputs)
    return single, ranks.wait(), jres


@pytest.mark.parametrize("case", CASES)
def test_sharded_plan_equals_one_process(runs, case):
    """Ybars (or mu_0ts), rews_trace, final_reward and final_diverged of
    every rank equal one process's bit for bit; the resumed checkpoint
    ran the same steps."""
    single, ranks, _ = runs
    for rank, out in enumerate(ranks):
        assert out[case].keys() == single[case].keys()
        for k, v in single[case].items():
            assert torch.equal(out[case][k], v), (case, rank, k)


def test_sharded_plan_matches_jax(runs):
    """Every rank's hopper plan from JAX's reset state and noise against
    JAX's unsharded plan of the same inputs: rews_trace and final_reward
    to atol 5e-3, final_diverged equal, as tests/test_torch_planner.py
    holds the single process."""
    _, ranks, jres = runs
    for out in ranks:
        res = out["jax_inputs"]
        np.testing.assert_allclose(np.asarray(jres.rews_trace),
                                   res["rews_trace"].numpy(), rtol=0,
                                   atol=5e-3)
        assert abs(float(jres.final_reward)
                   - float(res["final_reward"])) <= 5e-3
        assert bool(res["final_diverged"]) == bool(jres.final_diverged)


def test_ranks_refuse_a_checkpoint_they_do_not_share(runs):
    """A resume whose checkpoint path names an existing checkpoint on
    rank 0 and no file on rank 1 raises on both ranks before any step,
    rather than gather shards of different steps."""
    _, ranks, _ = runs
    for out in ranks:
        assert "the ranks disagree on the step a checkpointed plan " \
            "resumes at" in out["unshared"], out["unshared"]


def test_reverse_step_collectives_are_smaller_than_y0s(runs):
    """The port's counterpart of
    ``test_meshed_reverse_step_moves_no_rollout_tensors``: every
    collective of every reverse step is smaller than Y0s [N, H, nu], and
    there is at least one a step."""
    _, ranks, _ = runs
    cfg = mbd.MBDConfig(**R.CFG)
    y0s = cfg.Nsample * cfg.Hsample * 3                # hopper: nu = 3
    for out in ranks:
        steps = out["collectives"]
        assert len(steps) == cfg.Ndiffuse - 1
        for step in steps:
            assert step, "a reverse step issued no collective"
            assert all(n < y0s for _, n in step), step


def test_shard_must_divide():
    """A sample or env count that does not divide over the mesh raises
    before any collective, in every entry point that takes ``mesh``."""
    mesh = SampleMesh(group=None, rank=0, size=2, device=torch.device("cpu"))
    assert mesh.shard(64) == (0, 32)
    assert mesh.split(5) == (0, 3)
    with pytest.raises(ValueError, match="Nsample=63 must be divisible"):
        mesh.shard(63)
    with pytest.raises(ValueError):
        mesh.split(1)
    hopper = envs.get_env("hopper", device="cpu")
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="Nsample=63"):
        mbd.plan(hopper, mbd.MBDConfig(Nsample=63, Hsample=2, Ndiffuse=2),
                 gen, mesh=mesh)
    with pytest.raises(ValueError, match="S·Nsample=9"):
        mbd.plan_batch(hopper, mbd.MBDConfig(Nsample=3, Hsample=2,
                                             Ndiffuse=2), [gen] * 3,
                       mesh=mesh)
    with pytest.raises(ValueError, match="Nsample=63"):
        pi.plan(hopper, pi.PathIntegralConfig(Nsample=63, Hsample=2,
                                              Nrefine=2), gen, mesh=mesh)
    with pytest.raises(ValueError, match="num_envs=3"):
        ppo.train(hopper, ppo.PPOConfig(num_envs=3), mesh=mesh)
