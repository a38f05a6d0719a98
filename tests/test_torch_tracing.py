"""The port's recorder (``mbd_tpu_torch/utils/profiling.py``) on the CPU:
the planner's spans and the rollout's counters, recorded only while a
``torch.profiler`` records (or inside ``recording()``, the counters only
with ``counters=True``), the plan the same bit for bit either way; the
recorder's bounds; the mesh's ranks handing theirs back; and the plain
engine's first flagged env step, the counterpart of the kernel's
first-flag buffer, against its flags and against shorter rollouts.

The tiny plan is ``torch_mesh_ranks.TRACE_CFG``: hopper, 2 seeds, 16
samples, H 4, 4 diffusion steps (T = 3 reverse steps)."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import torch_flag_check as F
import torch_mesh_ranks as R
from mbd_tpu_torch import envs
from mbd_tpu_torch.ops import rollout_cuda
from mbd_tpu_torch.parallel import start_ranks
from mbd_tpu_torch.planners import mbd
from mbd_tpu_torch.rollout.fused import rollout_outputs, rollout_qs
from mbd_tpu_torch.utils import profiling

T = R.TRACE_CFG["Ndiffuse"] - 1
STEP_PARTS = ["mbd.noise", "mbd.rollout", "mbd.weigh", "mbd.update"]


def _plan():
    env = envs.get_env("hopper", device="cpu")
    gens = [torch.Generator().manual_seed(s) for s in R.TRACE_SEEDS]
    return mbd.plan_batch(env, mbd.MBDConfig(**R.TRACE_CFG), gens)


def _stand_in(env, state0, Y0s, demo=False, retire=False):
    """A rollout of few host operations in the plain engine's place:
    under a profiler the engine's millions of operations would each be an
    event."""
    return Y0s.sum(dim=-1), torch.zeros_like(Y0s[:, 0, 0])


@pytest.fixture(scope="module")
def plans():
    """The tiny plan with recording off and inside ``recording(counters=
    True)``, with one CPU thread; then, its rollouts stood in for, under a
    profiler of the host: (both results, what was recorded inside
    ``recording``, under the profiler, the profiler's event names)."""
    profiling.clear()
    with R.one_thread():
        off = _plan()
        assert profiling.recorded().spans == []
        with profiling.recording(counters=True):
            on = _plan()
        rec = profiling.recorded()
        profiling.clear()
        real = mbd.rollout_rewards_cuda
        mbd.rollout_rewards_cuda = _stand_in
        try:
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU]) as prof:
                _plan()
        finally:
            mbd.rollout_rewards_cuda = real
    traced = profiling.recorded()
    profiling.clear()
    return off, on, rec, traced, {e.name for e in prof.events()}


def test_nothing_is_recorded_outside_a_profiler():
    """Off, a span is one shared no-op context and a count nothing."""
    profiling.clear()
    assert not profiling.on()
    assert profiling.span("mbd.step", t=0) is profiling.span("mesh.gather",
                                                            device=True)
    with profiling.span("mbd.step", t=0) as rec:
        profiling.count("rollout.sample_steps", 5)
    assert rec is None
    assert profiling.recorded() == profiling.Recorded([], {})
    with profiling.recording():
        assert profiling.on()
    assert not profiling.on()


def test_counters_only_when_asked():
    """``recording()`` records spans and no counter, and the rollout
    then fills no first-flag or rows buffer; ``recording(counters=True)``
    and a profiler keep the counters too."""
    profiling.clear()
    env = envs.get_env("hopper", device="cpu")
    state0 = env.reset(torch.Generator().manual_seed(0))
    Y = torch.zeros((4, 2, env.action_size))
    with profiling.recording():
        assert profiling.on() and not profiling.counting()
        with profiling.span("mbd.step", t=0):
            out = rollout_cuda.rollout_rewards_cuda(env, state0, Y)
            profiling.count("c", 1)
    rec = profiling.recorded()
    assert len(out) == 2 and rec.counts == {}
    assert [s.name for s in rec.spans] == ["mbd.step"]
    with profiling.recording(counters=True):
        assert profiling.counting()
        assert len(rollout_cuda.rollout_rewards_cuda(env, state0, Y)) == 2
    rows = rollout_outputs(env, state0, Y, rows=True)[-1]
    assert profiling.recorded().counts == {0: {
        "rollout.sample_steps": 8, "rollout.tail_sample_steps": 0,
        "rollout.live_substeps": 8 * env.n_frames,
        "rollout.fk_stage_substeps": 8 * env.n_frames * 4,
        "rollout.contact_row_substeps": int(rows.sum())}}
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        assert profiling.on() and profiling.counting()
    assert not profiling.counting()
    profiling.clear()


def test_recorder_is_bounded(monkeypatch):
    """Past ``MAX_SPANS`` a span records nothing and is counted as
    dropped, a merge keeps what fits; a counter's device values fold into
    one running sum."""
    profiling.clear()
    monkeypatch.setattr(profiling, "MAX_SPANS", 3)
    with profiling.recording(counters=True):
        for t in range(5):
            with profiling.span("mbd.step", t=t):
                profiling.count("c", torch.tensor(t))
        assert len(profiling.RECORDER.counts[(0, "c")][1]) == 1
    rec = profiling.recorded()
    assert [s.attrs["t"] for s in rec.spans] == [0, 1, 2]
    assert rec.dropped == 2 and rec.counts == {0: {"c": 10}}
    profiling.clear()
    profiling.merge(rec, 1)
    profiling.merge(rec, 2)
    both = profiling.recorded()
    profiling.clear()
    assert [s.rank for s in both.spans] == [1, 1, 1]
    assert both.dropped == 2 + 2 + 3
    assert both.counts == {1: {"c": 10}, 2: {"c": 10}}


@pytest.mark.parametrize("under", ["recording", "profiler"])
def test_plan_records_its_phases(plans, under):
    """One ``mbd.plan`` (with S, Nsample and T), its prologue, T steps in
    order, each tiled by its four parts in order, and the final
    selection; every span in the plan, of one plan id, on rank 0; under
    the profiler, the same spans and their names among its events."""
    _, _, rec, traced, names = plans
    spans = (rec if under == "recording" else traced).spans
    top = [s for s in spans if s.parent is None]
    assert [s.name for s in top] == ["mbd.plan"]
    plan = top[0]
    assert plan.attrs == dict(S=2, Nsample=R.TRACE_CFG["Nsample"], T=T)
    kids = [s for s in spans if s.parent == 0]
    assert [s.name for s in kids] == (["mbd.prologue"] + ["mbd.step"] * T
                                      + ["mbd.final"])
    steps = [i for i, s in enumerate(spans) if s.name == "mbd.step"]
    assert [spans[i].attrs["t"] for i in steps] == list(range(T))
    for i in steps:
        parts = [s for s in spans if s.parent == i]
        assert [s.name for s in parts] == STEP_PARTS
        assert all(spans[i].start <= s.start <= s.end <= spans[i].end
                   for s in parts)
        assert all(a.end <= b.start for a, b in zip(parts, parts[1:]))
    assert len(spans) == 3 + T * 5
    assert {s.plan for s in spans} == {plan.plan}
    assert {s.rank for s in spans} == {0}
    assert all(s.end is not None and s.device_ms is None for s in spans)
    if under == "profiler":
        assert {s.name for s in spans} <= names
        assert [(s.name, s.parent, s.attrs) for s in spans] == [
            (s.name, s.parent, s.attrs) for s in rec.spans]


def test_plan_is_the_same_recorded_or_not(plans):
    off, on = plans[:2]
    for field in R.PLAN_FIELDS:
        a, b = torch.as_tensor(getattr(off, field)), torch.as_tensor(
            getattr(on, field))
        assert torch.equal(a, b), field


def test_plan_counts_its_sample_steps_and_tail(plans):
    """The rollout's counters over the plan: T launches of S·N samples
    and the final selection's S·T, H steps each, the T retiring; hopper
    at these sizes flags nothing, so nothing is retired and every substep
    is live; contact rows act in some of them."""
    rec = plans[2]
    S, N, H = 2, R.TRACE_CFG["Nsample"], R.TRACE_CFG["Hsample"]
    steps = (T * S * N + S * T) * H
    rows = rec.counts[0].pop("rollout.contact_row_substeps")
    assert rec.counts == {0: {"rollout.sample_steps": steps,
                              "rollout.tail_sample_steps": 0,
                              "rollout.retired_sample_steps": 0,
                              "rollout.live_substeps": steps * 20,
                              "rollout.fk_stage_substeps": steps * 20 * 4}}
    assert 0 < rows < steps * 20 * 4


def test_ranks_hand_back_their_records():
    """Two gloo ranks on the CPU plan the tiny plan over the mesh; their
    records come back through ``Ranks.wait()`` into this process's
    recorder, tagged by rank: each rank's spans of one plan id, with T + 1
    ``mesh.gather`` spans (T steps and the final selection), each inside
    its step's ``mbd.rollout`` or the final selection, with its bytes."""
    profiling.clear()
    outs = start_ranks(R.traced_plan, 2, backend="gloo",
                       device="cpu").wait()
    rec = profiling.recorded()
    profiling.clear()
    for k in R.PLAN_FIELDS:
        assert torch.equal(outs[0][k], outs[1][k]), k
    assert {s.rank for s in rec.spans} == {0, 1}
    plan_ids = set()
    for rank in (0, 1):
        mine = [s for s in rec.spans if s.rank == rank]
        plan_ids |= {s.plan for s in mine}
        gathers = [s for s in mine if s.name == "mesh.gather"]
        assert len(gathers) == T + 1
        assert [rec.spans[s.parent].name for s in gathers] == \
            ["mbd.rollout"] * T + ["mbd.final"]
        assert all(s.attrs["bytes"] > 0 and s.device_ms is None
                   for s in gathers)
        assert [s.name for s in mine if s.name.startswith("mbd.plan")] \
            == ["mbd.plan"]
        assert sum(c for c in rec.counts[rank].values()) > 0
    assert len(plan_ids) == 1


def test_recorder_nests_spans_and_sums_counts():
    """Parents follow the nesting, plan ids start at a span opened with
    ``plan=True``, a span outside any plan has none; a counter sums host
    ints and device tensors; ``merge`` tags another process's records
    with its rank and offsets their parents."""
    profiling.clear()
    with profiling.recording(counters=True):
        with profiling.span("mesh.gather", bytes=4):
            pass
        with profiling.span("mbd.plan", plan=True):
            with profiling.span("mbd.step", t=0):
                profiling.count("c", 2)
                profiling.count("c", torch.tensor(3))
    rec = profiling.recorded()
    assert [(s.name, s.parent) for s in rec.spans] == [
        ("mesh.gather", None), ("mbd.plan", None), ("mbd.step", 1)]
    assert rec.spans[0].plan is None
    assert rec.spans[1].plan == rec.spans[2].plan is not None
    assert all(s.start <= s.end for s in rec.spans)
    assert rec.counts == {0: {"c": 5}}
    profiling.merge(rec, 3)
    both = profiling.recorded()
    profiling.clear()
    assert [(s.rank, s.parent) for s in both.spans[3:]] == [
        (3, None), (3, None), (3, 4)]
    assert both.counts == {0: {"c": 5}, 3: {"c": 5}}


def _fixture_rollout(model, H=4):
    """The fixture's states of ``model`` one substep an env step
    (``n_frames`` 1), so that the first env step is the substep the card
    recorded: their recorded controls first, then uniform ones."""
    env = envs.get_env(model, device="cpu")
    d = F.fixture(model)
    q = torch.from_numpy(np.ascontiguousarray(d["q"].T))
    qd = torch.from_numpy(np.ascontiguousarray(d["qd"].T))
    U = np.random.default_rng(0).uniform(
        -1, 1, (H, env.action_size, q.shape[1])).astype(np.float32)
    U[0] = d["u"].T
    return env, d, q, qd, torch.from_numpy(U)


@pytest.mark.parametrize("model", sorted(F.FIXTURE_CELLS))
def test_plain_first_flag_from_the_card_states(model):
    """From the card's humanoid states (``assets/humanoid_flags.npz``),
    one substep an env step: the flagged ones flag at their first env
    step and the clean ones not there; each sample's first flag agrees
    with its flag and with the flags of every shorter rollout."""
    env, d, q, qd, U = _fixture_rollout(model)
    _, _, bad, first = rollout_qs(env.sys, 1, q, qd, U, first=True)
    flagged = torch.from_numpy(d["flagged"])
    assert torch.equal(first[flagged], torch.zeros_like(first[flagged]))
    assert bool((first[~flagged] != 0).all())
    assert torch.equal(first >= 0, bad != 0)
    for h in range(1, U.shape[0]):
        bad_h = rollout_qs(env.sys, 1, q, qd, U[:h])[2]
        assert torch.equal(bad_h != 0, (first >= 0) & (first < h)), h


def test_plain_first_flag_of_whole_env_steps():
    """At the env's own substeps (humanoidrun, the fixture's states, H 3):
    ``rollout_outputs``' first flag agrees with its flag and with shorter
    rollouts, its other outputs are those without it, and the wrapper
    counts N·H sample-steps and Σ H − 1 − first over the flagged samples,
    only while counting."""
    env, _, q, qd, U = _fixture_rollout("humanoidrun", H=3)
    state0 = SimpleNamespace(pipeline_state=SimpleNamespace(q=q, qd=qd))
    Y = U.permute(2, 0, 1).contiguous()
    N, H = Y.shape[:2]
    rews, bad, first = rollout_outputs(env, state0, Y, first=True)
    plain = rollout_outputs(env, state0, Y)
    assert torch.equal(rews, plain[0]) and torch.equal(bad, plain[1])
    assert torch.equal(first >= 0, bad != 0)
    assert bool((first >= 0).any()) and bool((first < 0).any())
    for h in range(1, H):
        bad_h = rollout_outputs(env, state0, Y[:, :h])[1]
        assert torch.equal(bad_h != 0, (first >= 0) & (first < h)), h
    profiling.clear()
    rollout_cuda.rollout_rewards_cuda(env, state0, Y)
    assert profiling.recorded().counts == {}
    with profiling.recording(counters=True):
        out = rollout_cuda.rollout_rewards_cuda(env, state0, Y)
    counts = profiling.recorded().counts[0]
    profiling.clear()
    assert len(out) == 2 and torch.equal(out[0], rews)
    tail = int(((H - 1) - first[first >= 0]).sum())
    rows = rollout_outputs(env, state0, Y, rows=True)[-1]
    live = int(torch.where(first >= 0, first + 1, H).sum()) * env.n_frames
    assert counts == {"rollout.sample_steps": N * H,
                      "rollout.tail_sample_steps": tail,
                      "rollout.live_substeps": live,
                      "rollout.fk_stage_substeps": live * 6,
                      "rollout.contact_row_substeps": int(rows.sum())}


@pytest.mark.parametrize("k", [1, 2])
def test_plan_is_the_same_retired_or_whole(k, monkeypatch):
    """A small humanoidrun plan (16 samples, H 4, 3 reverse steps, one
    substep an env step) from the fixture's flagged state k: its reverse
    steps ask for retiring rollouts and the final selection for a whole
    one; samples flag (k = 1: some, from step 1 on; k = 2: all, at step
    0), and the plan's iterates, rewards and final reward are bit for bit
    those of the plan whose rollouts all run whole, so no reader of a
    flagged sample's rewards is left. Counted, the retired sample-steps
    are the NaN rewards of the retiring rollouts, and the live substeps
    and acting contact rows are the same either way."""
    env = envs.get_env("humanoidrun", device="cpu")
    env.n_frames = 1
    d = F.fixture("humanoidrun")
    assert d["flagged"][k]
    state = SimpleNamespace(pipeline_state=SimpleNamespace(
        q=torch.from_numpy(d["q"][k]), qd=torch.from_numpy(d["qd"][k])))
    cfg = mbd.MBDConfig(Nsample=16, Hsample=4, Ndiffuse=4)
    real = mbd.rollout_rewards_cuda
    calls = []

    def spy(env, state0, Y0s, demo=False, retire=False):
        out = real(env, state0, Y0s, demo=demo, retire=retire and honour)
        calls.append((retire, int(out[1].sum()),
                      int(torch.isnan(out[0]).sum())))
        return out

    monkeypatch.setattr(mbd, "rollout_rewards_cuda", spy)
    results, counts = [], []
    for honour in (True, False):
        profiling.clear()
        with profiling.recording(counters=True):
            results.append(mbd.plan(env, cfg, torch.Generator().manual_seed(0),
                                    state_init=state))
        counts.append(profiling.recorded().counts[0])
    profiling.clear()
    steps = cfg.Ndiffuse - 1
    retired, whole = calls[:steps + 1], calls[steps + 1:]
    assert [c[0] for c in retired] == [True] * steps + [False]
    assert sum(c[1] for c in retired[:steps]) > 0
    nans = sum(c[2] for c in retired)
    assert nans > 0 and all(c[2] == 0 for c in whole)
    assert counts[0]["rollout.retired_sample_steps"] == nans
    assert "rollout.retired_sample_steps" not in counts[1]
    for key in ("rollout.live_substeps", "rollout.contact_row_substeps"):
        assert counts[0][key] == counts[1][key], key
    for field in R.PLAN_FIELDS:
        a, b = (torch.as_tensor(getattr(r, field)) for r in results)
        assert torch.equal(a, b), field


def test_plan_counts_its_live_substeps_and_acting_contact_rows(
        monkeypatch):
    """The small humanoidrun plan above from the fixture's flagged state
    1, counted: ``rollout.live_substeps`` is Σ over its rollouts and
    samples of (first flagged env step + 1, or H) × n_frames, fewer than
    all, and ``rollout.contact_row_substeps`` the Σ of the plain version's
    rows count, each rollout redone with its first flags and rows."""
    env = envs.get_env("humanoidrun", device="cpu")
    env.n_frames = 1
    d = F.fixture("humanoidrun")
    state = SimpleNamespace(pipeline_state=SimpleNamespace(
        q=torch.from_numpy(d["q"][1]), qd=torch.from_numpy(d["qd"][1])))
    cfg = mbd.MBDConfig(Nsample=16, Hsample=4, Ndiffuse=4)
    real = mbd.rollout_rewards_cuda
    want = dict(live=0, rows=0)

    def spy(env, state0, Y0s, demo=False, retire=False):
        _, _, first, rows = rollout_outputs(env, state0, Y0s, first=True,
                                            rows=True)
        want["live"] += int(torch.where(first >= 0, first + 1,
                                        Y0s.shape[1]).sum()) * env.n_frames
        want["rows"] += int(rows.sum())
        return real(env, state0, Y0s, demo=demo, retire=retire)

    monkeypatch.setattr(mbd, "rollout_rewards_cuda", spy)
    profiling.clear()
    with profiling.recording(counters=True):
        mbd.plan(env, cfg, torch.Generator().manual_seed(0),
                 state_init=state)
    counts = profiling.recorded().counts[0]
    profiling.clear()
    assert counts["rollout.live_substeps"] == want["live"]
    assert want["live"] < counts["rollout.sample_steps"] * env.n_frames
    assert counts["rollout.contact_row_substeps"] == want["rows"] > 0


@pytest.mark.parametrize("name,stages", [("humanoidrun", 6), ("hopper", 4)])
def test_wrapper_counts_fk_stages_only_while_recording(name, stages):
    """``rollout.fk_stage_substeps``: nothing outside the recorder, and
    with it the live substeps times the serial steps of the model's forward
    kinematics, the humanoid's 6 tree levels and hopper's 4 bodies along
    its chain, from the fixture's humanoid states, some of which flag."""
    env = envs.get_env(name, device="cpu")
    env.n_frames = 1
    if name == "humanoidrun":
        d = F.fixture(name)
        state0 = SimpleNamespace(pipeline_state=SimpleNamespace(
            q=torch.from_numpy(np.ascontiguousarray(d["q"][:8].T)),
            qd=torch.from_numpy(np.ascontiguousarray(d["qd"][:8].T))))
    else:
        state0 = env.reset(torch.Generator().manual_seed(0))
    Y = torch.rand((8, 2, env.action_size),
                   generator=torch.Generator().manual_seed(1)) * 2 - 1
    profiling.clear()
    rollout_cuda.rollout_rewards_cuda(env, state0, Y)
    with profiling.recording():
        rollout_cuda.rollout_rewards_cuda(env, state0, Y)
    assert profiling.recorded().counts == {}
    with profiling.recording(counters=True):
        rollout_cuda.rollout_rewards_cuda(env, state0, Y)
    counts = profiling.recorded().counts[0]
    profiling.clear()
    live = counts["rollout.live_substeps"]
    assert counts["rollout.fk_stage_substeps"] == live * stages
    if name == "humanoidrun":
        assert 0 < live < 8 * 2
    else:
        assert live == 8 * 2


def test_wrapper_refuses_retire_past_the_flag():
    """The retiring form with the trace or the demo, which read past a
    sample's first flag, is refused before anything runs."""
    env = envs.get_env("humanoidtrack", device="cpu")
    state0 = env.reset(torch.Generator().manual_seed(0))
    Y = torch.zeros((4, 2, env.action_size))
    for kw in (dict(need_qs=True), dict(demo=True)):
        with pytest.raises(ValueError, match="first flag"):
            rollout_cuda.rollout_rewards_cuda(env, state0, Y, retire=True,
                                              **kw)
