"""The reference equals the port's plain engine and planner at a CPU
size, bit for bit: the reset draws, the schedule, a rollout's rewards and
flags from per-sample states (hopper and humanoidrun), the reverse step of
two seeds, and the final selection."""

import pytest
import torch

from benchmark.reference import models
from benchmark.reference import planner as P
from benchmark.reference.rollout import rollout


def _bits(a, b):
    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


@pytest.mark.parametrize("env_name", ["hopper", "humanoidrun"])
def test_reset_and_rollout_equal_the_port(env_name):
    from mbd_tpu_torch import envs
    from mbd_tpu_torch.planners import mbd
    from mbd_tpu_torch.rollout import fused

    env = envs.get_env(env_name, device="cpu")
    model = models.load(env_name, "cpu")
    seeds = [7, 2 ** 40 + 3]
    states = [env.reset(torch.Generator().manual_seed(s)) for s in seeds]
    ref = [model.reset(torch.Generator().manual_seed(s)) for s in seeds]
    for st, (q, qd) in zip(states, ref):
        assert _bits(st.pipeline_state.q, q)
        assert _bits(st.pipeline_state.qd, qd)
    N, H = 3, 2
    Y0s = torch.rand((2 * N, H, env.action_size),
                     generator=torch.Generator().manual_seed(1)) * 2 - 1
    state0 = mbd.batch_states(env, states, N)
    want = fused.rollout_outputs(env, state0, Y0s)
    q0 = P.seed_major(torch.stack([q for q, _ in ref]), N)
    qd0 = P.seed_major(torch.stack([qd for _, qd in ref]), N)
    rews, bad, work = rollout(model, q0, qd0, Y0s, record=True)
    assert _bits(rews, want[0]) and rews.stride() == want[0].stride()
    assert _bits(bad, want[1])
    assert work.live_steps.tolist() == [float(H)] * (2 * N)


def test_reverse_step_and_selection_equal_the_port():
    from mbd_tpu_torch import envs
    from mbd_tpu_torch.core.schedule import make_schedule
    from mbd_tpu_torch.planners import mbd

    env = envs.get_env("hopper", device="cpu")
    cfg = mbd.MBDConfig(Nsample=6, Hsample=2, Ndiffuse=4)
    states = [env.reset(torch.Generator().manual_seed(s)) for s in (0, 1)]
    sched = make_schedule(4, cfg.beta0, cfg.betaT, device="cpu")
    ref_sched = P.schedule(4, cfg.beta0, cfg.betaT, "cpu")
    for a, b in zip((sched.alphas, sched.alphas_bar, sched.sigmas),
                    ref_sched):
        assert _bits(a, b)
    step = mbd.make_reverse_once_batch(env, cfg, states, sched)
    gen = torch.Generator().manual_seed(3)
    Ybar = torch.rand((2, 2, env.action_size), generator=gen) - 0.5
    eps = torch.randn((2, 6, 2, env.action_size), generator=gen)
    want, _ = step(Ybar, 2, eps)
    Y0s = P.samples(ref_sched, 2, Ybar, eps)
    out = mbd.rollout_batch(env, mbd.batch_states(env, states, 6),
                            Y0s.reshape(12, 2, -1))
    got = P.step(ref_sched, 2, Ybar, Y0s, out[0].reshape(2, 6, 2),
                 out[1].reshape(2, 6), cfg.temp_sample)
    assert _bits(got, want)

    plans = torch.rand((2, 3, 2, env.action_size), generator=gen) - 0.5
    kept = plans.clone()
    reward, diverged = mbd.evaluate_final(env, states, plans)
    rews, bad = mbd.rollout_batch(env, mbd.seed_major(states, 3),
                                  kept.reshape(6, 2, -1))
    sel = P.select(rews, bad, 2)
    assert _bits(sel.reward, reward)
    assert torch.equal(sel.diverged, diverged)
    assert torch.equal(plans[:, -1], kept[torch.arange(2), sel.choose])
