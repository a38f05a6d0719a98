"""The humanoidstandup cell on the CPU: the reference's model of it
(``reference/models/humanoidstandup.py``) equals the port bit for bit,
the reset's draws and a rollout's rewards, flags and work from states
with the body's capsules in the floor, so that contact rows act; and a
run of the cell cut to a CPU size comes out ``correct``."""

from types import SimpleNamespace

import torch

from benchmark.reference import models
from benchmark.reference import planner as P
from benchmark.reference.rollout import rollout
from benchmark.tests import tiny


def _bits(a, b):
    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


def test_reset_equals_the_port():
    from mbd_tpu_torch import envs

    env = envs.get_env("humanoidstandup", device="cpu")
    model = models.load("humanoidstandup", "cpu")
    assert model.n_frames == env.n_frames == 7
    for seed in (0, 2 ** 40 + 3):
        state = env.reset(torch.Generator().manual_seed(seed))
        q, qd = model.reset(torch.Generator().manual_seed(seed))
        assert _bits(state.pipeline_state.q, q)
        assert _bits(state.pipeline_state.qd, qd)


def test_rollout_with_capsules_in_the_floor_equals_the_port():
    """Six samples from two seeds' resets, the free root lowered by 0 to
    0.1 and turned a little per sample, under uniform controls for 2 env
    steps: the rewards and flags bit for bit, and the reference's
    recorder counts the contact rows that acted as the port's plain
    version does, sample by sample, more than the supine reset's few."""
    from mbd_tpu_torch import envs
    from mbd_tpu_torch.planners import mbd
    from mbd_tpu_torch.rollout import fused

    env = envs.get_env("humanoidstandup", device="cpu")
    model = models.load("humanoidstandup", "cpu")
    gen = torch.Generator().manual_seed(5)
    seeds, N, H = [1, 2 ** 33 + 9], 3, 2
    q0 = P.seed_major(torch.stack([model.reset(
        torch.Generator().manual_seed(s))[0] for s in seeds]), N)
    qd0 = P.seed_major(torch.stack([model.reset(
        torch.Generator().manual_seed(s))[1] for s in seeds]), N)
    q0[2] -= 0.1 * torch.rand(2 * N, generator=gen)
    quat = q0[3:7] + 0.05 * torch.randn((4, 2 * N), generator=gen)
    q0[3:7] = quat / quat.norm(dim=0)
    q0, qd0 = q0.contiguous(), qd0.contiguous()
    Y0s = torch.rand((2 * N, H, env.action_size), generator=gen) * 2 - 1
    state0 = SimpleNamespace(pipeline_state=SimpleNamespace(q=q0, qd=qd0))
    rews, bad, first, rows = fused.rollout_outputs(env, state0, Y0s,
                                                   first=True, rows=True)
    ref, ref_bad, work = rollout(model, q0, qd0, Y0s, record=True)
    assert _bits(ref, rews) and ref.stride() == rews.stride()
    assert _bits(ref_bad, bad)
    assert work.n_contacts == 15 and work.n_limits == 34
    assert torch.equal(work.contacts, rows.float())
    assert torch.equal(work.live_steps,
                       torch.where(first >= 0, first + 1, H).float())
    reset = mbd.batch_states(env, [env.reset(
        torch.Generator().manual_seed(s)) for s in seeds], N)
    supine = fused.rollout_outputs(env, reset, Y0s, rows=True)[-1]
    assert int(rows.sum()) > int(supine.sum()) > 0


def test_tiny_cell_is_correct():
    line = tiny.run(tiny.tiny_cell("humanoidstandup"))
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["metrics"]) == {"plan_s", "setup_s"}
