"""The validity flags' records (``replay.first_flags``) and the card's
humanoid states held against the reference's engine, on the CPU.

``first_flags`` steps the plain engine one substep at a time and records
where each sample first leaves the validity envelope; its flags must be
``rollout_outputs``' and each sample's record the one it gets alone.
``mbd_tpu_torch/assets/humanoid_flags.npz`` holds flagged and clean states
of the last reverse step of ``torch_flag_check``'s humanoidrun and
humanoidtrack_demo cells on the card, each with the card's margins after
one substep (``tests/torch_flag_check.py --card``): one substep of the
port's engine here and one eager substep of JAX's, batched over a model's
states, must give the card's verdict (``torch_flag_check.judge``: |qd|
within 0.2, the root within 1e-4 m; a state that close to its limit on
the card is an edge state, not judged). The last step it rebuilds from a
plan (``torch_flag_check.last_step``) is the plan's own.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import torch_flag_check as F
from mbd_tpu_torch import envs
from mbd_tpu_torch.rollout import replay
from mbd_tpu_torch.planners import mbd
from mbd_tpu_torch.rollout.fused import rollout_outputs

FIELDS = ("first", "root", "speed", "low", "dof", "peak", "peak_at",
          "peak_dof", "lowest", "lowest_at", "bad")


def per_sample(q, qd):
    return SimpleNamespace(pipeline_state=SimpleNamespace(
        q=torch.from_numpy(np.ascontiguousarray(q)),
        qd=torch.from_numpy(np.ascontiguousarray(qd))))


def case(name):
    """(env, per-sample state, Y0s): hopper from 8 perturbed resets under
    random controls, N = 8, H = 10; humanoidrun from the card's states
    before a first flag by |qd| and before one by the root (each the
    fixture's widest margin of its check), before a clean sample's closest
    approach and before another flag, their recorded controls first,
    N = 4, H = 3."""
    env = envs.get_env(name, device="cpu")
    rng = np.random.default_rng(0)
    if name == "hopper":
        N, H = 8, 10
        ps = env.reset(torch.Generator().manual_seed(0)).pipeline_state
        q = ps.q.numpy()[:, None] + 0.05 * rng.standard_normal(
            (env.sys.nq, N)).astype(np.float32)
        qd = np.repeat(ps.qd.numpy()[:, None], N, axis=1)
        Y = rng.uniform(-1, 1, (N, H, env.action_size)).astype(np.float32)
        return env, per_sample(q, qd), torch.from_numpy(Y)
    d = F.fixture(name)
    rows = [int(np.argmax(np.where(d["flagged"] & (d["check"] == c),
                                   d[f"{c}_margin"], -np.inf)))
            for c in ("qd", "root")]
    rows += [int(np.flatnonzero(~d["flagged"])[0])]
    rows += [int(np.flatnonzero(d["flagged"])[-1])]
    Y = rng.uniform(-1, 1, (len(rows), 3, env.action_size)).astype(
        np.float32)
    Y[:, 0] = d["u"][rows]
    return env, per_sample(d["q"][rows].T, d["qd"][rows].T), \
        torch.from_numpy(Y)


@pytest.mark.parametrize("name", ["hopper", "humanoidrun"])
def test_first_flags_are_the_rollouts_and_each_samples_own(name):
    """``first_flags``' flags and rewards equal ``rollout_outputs``' bit for
    bit, and a sample's record (first flag, check, margins, closest
    approach, the states before them) is the one it gets at a batch of 1,
    as ``first_flag`` runs it, for the first, middle and last sample. On humanoidrun the card's flagged states
    flag here at their first substep."""
    env, state0, Y = case(name)
    rec = replay.first_flags(env, state0, Y, states=True, trace=True)
    rews, bad = rollout_outputs(env, state0, Y)
    assert torch.equal(rec.rews, rews)
    assert torch.equal(rec.bad, bad)
    ps = state0.pipeline_state
    N = Y.shape[0]
    for n in sorted({0, N // 2, N - 1}):
        one = replay.first_flags(env, SimpleNamespace(
            pipeline_state=SimpleNamespace(q=ps.q[:, n:n + 1],
                                           qd=ps.qd[:, n:n + 1])),
            Y[n:n + 1], states=True)
        for field in FIELDS:
            assert torch.equal(getattr(one, field),
                               getattr(rec, field)[n:n + 1]), (n, field)
        for kind, arrays in one.pre.items():
            for a, b in zip(arrays, rec.pre[kind]):
                assert torch.equal(a[:, 0], b[:, n]), (n, kind)
        hit = replay.flag_of(rec, n)
        assert (hit is None) == (int(rec.first[n]) < 0)
    if name == "humanoidrun":
        assert rec.first[:2].tolist() == [0, 0]
        assert rec.root[:2].tolist() == [False, True]
        assert replay.summary(rec)["flagged"] >= 2


def test_summary_counts_the_checks_and_the_tail():
    """``summary``: the flagged samples by check and by the env step of
    their first flag, and the tail share, the sample-substeps after each
    first flagged substep over N · H · n_frames."""
    rec = SimpleNamespace(first=torch.tensor([-1, 0, 13, 20]),
                          root=torch.tensor([False, True, False, False]),
                          H=3, n_frames=7)
    assert replay.summary(rec) == dict(
        samples=4, flagged=3, by_check={"qd": 2, "root": 1},
        first_steps=[1, 1, 1], tail_share=(20 + 7 + 0) / (4 * 21))


def test_first_flag_keeps_the_edge_seeds_margin():
    """``first_flag``, ``first_flags`` at a batch of 1, finds humanoidrun
    seed 1's first flag on the CPU where ``replay.EDGE`` logs it: |qd|
    above the limit by 1.791351 (dof 16), the root clear of its limit."""
    hit = replay.first_flag(envs.get_env("humanoidrun", device="cpu"),
                            "humanoidrun", 1)
    assert (hit["step"], hit["substep"], hit["check"], hit["dof"]) == (
        41, 3, "qd", 16)
    assert round(hit["qd_margin"], 6) == \
        replay.EDGE["humanoidrun", 1]["cpu"]
    assert hit["root_margin"] < 0


@pytest.mark.parametrize("engine", ["port", "jax"])
@pytest.mark.parametrize("model", sorted(F.FIXTURE_CELLS))
def test_card_states_flag_alike_in_both_engines(model, engine):
    """From every fixture state, one substep of ``engine`` (the port's
    plain engine on this CPU, or JAX's eagerly) gives the card's verdict:
    a flagged state trips the same check, a clean one stays clean, each
    margin within ``torch_flag_check``'s tolerances of the card's, unless
    the card's margin lies that close to its limit (an edge state). The
    fixture holds each model's flags by every check its cell tripped, and
    clean states."""
    d, got, edge, agree = F.judge_fixture(model, engine)
    assert int(d["flagged"].sum()) == F.N_FLAGGED
    # humanoidtrack's last step flags by the root only
    checks = {"qd", "root"} if model == "humanoidrun" else {"root"}
    assert set(d["check"][d["flagged"]]) == checks
    assert (~d["flagged"]).sum() >= F.N_CLEAN // 2
    bad = np.flatnonzero(~edge & ~agree)
    assert bad.size == 0, [(int(d["sample"][j]), d["qd_margin"][j],
                            got[0][j], d["root_margin"][j], got[1][j])
                           for j in bad]


@pytest.mark.parametrize("name", ["car2d", "cartpole"])
def test_last_step_samples_are_the_plans(name):
    """The samples ``torch_flag_check`` rebuilds are the plan's last
    step's: their mean reward, as the planner forms it, is the plan's last
    trace entry, bit for bit (car2d's reset draws nothing, cartpole's
    draws first)."""
    env = envs.get_env(name, device="cpu")
    cfg = mbd.MBDConfig(Nsample=8, Hsample=4, Ndiffuse=4,
                        enable_demo=name == "car2d")
    res = mbd.plan(env, cfg, torch.Generator().manual_seed(3))
    samples = F.last_step_samples(env, cfg, 3, res.Ybars)
    assert samples.shape == (8, 4, env.action_size)
    state = env.reset(torch.Generator().manual_seed(3))
    out = mbd.rollout_batch(env, mbd.batch_states(env, [state], 8), samples)
    rew_mean = mbd.standardized_rewards(out[0], out[1], cfg.temp_sample)[2]
    assert torch.equal(rew_mean, res.rews_trace[-1])


def test_last_step_is_the_plan_batch_launch():
    """``last_step`` of a 2-seed ``plan_batch``: each seed's samples of
    the last step from its own reset state, its final plan in place of
    its sample 0; with sample 0 put back, each seed's mean reward is the
    plan's last trace entry, bit for bit."""
    env = envs.get_env("cartpole", device="cpu")
    cfg = mbd.MBDConfig(Nsample=8, Hsample=4, Ndiffuse=4)
    gens = [torch.Generator().manual_seed(5 + s) for s in range(2)]
    res = mbd.plan_batch(env, cfg, gens)
    state0, Y0s = F.last_step(env, cfg, 5, res.Ybars)
    assert Y0s.shape == (16, 4, env.action_size)
    Y0s = Y0s.reshape(2, 8, 4, -1)
    for s in range(2):
        assert torch.equal(Y0s[s, 0], res.Ybars[s, -1])
        Y0s[s, 0] = F.last_step_samples(env, cfg, 5 + s, res.Ybars[s])[0]
    out = mbd.rollout_batch(env, state0, Y0s.reshape(16, 4, -1))
    for s in range(2):
        rew_mean = mbd.standardized_rewards(
            out[0][8 * s:8 * s + 8], out[1][8 * s:8 * s + 8],
            cfg.temp_sample)[2]
        assert torch.equal(rew_mean, res.rews_trace[s, -1])
