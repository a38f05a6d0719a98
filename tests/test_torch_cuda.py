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


@pytest.mark.cuda
def test_kernel_refuses_32_bit_index_overflow(card):
    """An N·H whose trace index would pass 2³¹ is refused before any
    launch (a stride-0 view: nothing is allocated)."""
    env = envs.get_env("hopper", device=card)
    state0 = env.reset(torch.Generator(card).manual_seed(0))
    N = rollout_cuda.MAX_INDEX // (50 * env.sys.nq) + 1
    Y0s = torch.zeros((1, 50, env.action_size), device=card).expand(
        N, 50, env.action_size)
    launches = rollout_cuda.LAUNCHES
    with pytest.raises(ValueError, match="32-bit"):
        rollout_cuda.rollout_rewards_cuda(env, state0, Y0s)
    assert rollout_cuda.LAUNCHES == launches


@pytest.mark.cuda
@pytest.mark.parametrize("name,demo", [("hopper", False),
                                       ("humanoidtrack", True)])
def test_batch_samples_are_their_own_launch(card, name, demo):
    """Seeds folded into one launch with per-sample initial states: each
    seed's rewards, flags (and demo log-densities) equal those of its own
    launch from its shared state, bit for bit."""
    from mbd_tpu_torch.planners import mbd

    env = envs.get_env(name, device=card)
    gens = [torch.Generator(card).manual_seed(s) for s in range(3)]
    states = [env.reset(g) for g in gens]
    Y0s = 2 * torch.rand((3, 40, 4, env.action_size), generator=gens[0],
                         device=card) - 1
    batch = rollout_cuda.rollout_rewards_cuda(
        env, mbd.seed_major(states, 40), Y0s.reshape(120, 4, -1), demo=demo)
    for s in range(3):
        own = rollout_cuda.rollout_rewards_cuda(env, states[s], Y0s[s],
                                                demo=demo)
        for a, b in zip(batch, own):
            assert torch.equal(a[40 * s:40 * (s + 1)], b), (name, s)


@pytest.mark.cuda
@pytest.mark.parametrize("planner", ["mbd", "mppi", "cem", "cma-es"])
def test_plan_batch_one_launch_per_step(card, planner):
    """plan_batch launches the kernel once per step for all seeds and once
    for the final selection, never the plain engine; seed 0's iterates are
    its serial plan's bit for bit (each seed's statistics reduce the
    serial shapes), its final reward to 1e-6 (the mean over H of one row
    of the selection's [S·T, H] against the serial plan's [H])."""
    from mbd_tpu_torch.planners import mbd
    from mbd_tpu_torch.planners import path_integral as pi
    from mbd_tpu_torch.rollout import fused

    env = envs.get_env("hopper", device=card)
    if planner == "mbd":
        mod, cfg = mbd, mbd.MBDConfig(Nsample=256, Hsample=8, Ndiffuse=6)
    else:
        mod, cfg = pi, pi.PathIntegralConfig(update_method=planner,
                                             Nsample=256, Hsample=8,
                                             Nrefine=6)
    rollout_cuda.LAUNCHES, fused.CUDA_CALLS = 0, 0
    res = mod.plan_batch(env, cfg, [torch.Generator(card).manual_seed(s)
                                    for s in range(4)])
    torch.cuda.synchronize()
    assert rollout_cuda.LAUNCHES == 5 + 1 and fused.CUDA_CALLS == 0
    assert res.final_reward.shape == (4,)
    serial = mod.plan(env, cfg, torch.Generator(card).manual_seed(0))
    plans = res.Ybars if planner == "mbd" else res.mu_0ts
    assert torch.equal(plans[0], serial.Ybars if planner == "mbd"
                       else serial.mu_0ts)
    assert abs(float(res.final_reward[0])
               - float(serial.final_reward)) <= 1e-6


def _flagged_states(env, gen, B):
    """Per-sample states around the env's reset, 0.01 noise on q and 0.5 on
    qd, with every fourth sample's qd at 95 in its first dof, so that the
    step's checks flag some samples (|qd| > 100 or a root sunk below the
    floor)."""
    state = _state(env, gen, B, per_sample=True).pipeline_state
    qd = state.qd + 0.5 * torch.randn(state.qd.shape, generator=gen,
                                       device=state.qd.device)
    qd[0, ::4] = 95.0
    return state.q, qd.contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["hopper", "pushT", "humanoidrun"])
@pytest.mark.parametrize("B", [1, 8, 128])
def test_state_out_matches_plain_version(card, name, B):
    """The state-out mode (``env_step_cuda``, one launch) against its plain
    version (``rollout_qs`` at H = 1 and ``reward_qs_b``): q', qd',
    rewards and flags bit for bit, from per-sample states that include
    flagged samples, at the small B of SAC (128) and of the eval (8)."""
    from mbd_tpu_torch.rollout.fused import env_step_outputs

    env = envs.get_env(name, device=card)
    gen = torch.Generator(card).manual_seed(B)
    q, qd = _flagged_states(env, gen, B)
    u = 2 * torch.rand((env.action_size, B), generator=gen,
                       device=card) - 1
    launches = rollout_cuda.STATE_LAUNCHES
    out = rollout_cuda.env_step_cuda(env, q, qd, u)
    torch.cuda.synchronize()
    assert rollout_cuda.STATE_LAUNCHES == launches + 1
    plain = env_step_outputs(env, q, qd, u)
    for k, p in zip(out, plain):
        assert k.shape == p.shape
        assert torch.equal(k, p)


@pytest.mark.cuda
def test_mesh_gloo_two_ranks_on_one_card(card):
    """Two gloo ranks on the one card (CUDA tensors) plan hopper equal to
    one process bit for bit, each rank with its own launches (4 reverse
    steps and the final selection)."""
    import torch_mesh_ranks as R
    from mbd_tpu_torch.parallel import start_ranks

    ranks = start_ranks(R.card_plan, 2, backend="gloo", device="cuda")
    single = R.card_plan(None)
    for out in ranks.wait():
        assert int(out["launches"]) == 5
        for k in R.PLAN_FIELDS:
            assert torch.equal(out[k], single[k]), k


@pytest.mark.cuda
def test_mesh_nccl_world_of_one(card, tmp_path):
    """The NCCL backend at world size 1 in this process: the same plan as
    without a mesh, bit for bit."""
    import torch.distributed as dist

    import torch_mesh_ranks as R
    from mbd_tpu_torch.parallel import sample_mesh

    single = R.card_plan(None)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = sample_mesh()
        out = R.card_plan(mesh)
    finally:
        dist.destroy_process_group()
    assert mesh.collectives and mesh.device == torch.device("cuda:0")
    for k in R.PLAN_FIELDS:
        assert torch.equal(out[k], single[k]), k


@pytest.mark.cuda
def test_multichip_dryrun_and_exact_gather(card):
    """``parallel.multichip``'s case ``dryrun`` (one reverse step of
    humanoidrun at 8192 × 50) and its exact gather over min(4, count)
    cards, one NCCL rank a card: the gather bit for bit at every shape
    the plans gather, NaN, ±inf, ±0.0 and subnormals included; the step
    bit for bit with one card on every rank, each rank launching once on
    its own card at its share of the 8192 samples."""
    count = torch.cuda.device_count()
    if count < 2:
        pytest.skip(f"needs at least 2 CUDA cards, the machine has {count}")
    from mbd_tpu_torch.parallel import multichip

    K = min(4, count)
    report = multichip.run(K, ["dryrun"], repeat=1, nccl_algos=())
    assert all(c["ok"] for c in report["exact"][str(K)])
    row = report["cases"]["dryrun"][str(K)]
    assert row["ok"], row["checks"]
    assert row["exact"] and row["launches"] == [1] * K
    assert row["samples_per_launch"] == [[8192 // K]] * K
    assert report["ok"]


def _first_flag_case(card, name, N, H=10):
    """(env, per-sample state, Y0s) whose rollouts flag: humanoidrun from
    the card's humanoid states of ``assets/humanoid_flags.npz`` (their
    recorded controls first, the flagged ones flag at once), hopper from
    ``_flagged_states`` with every fourth sample's slide at 150 and a
    hinge of others from 60 to 99 (some flag, some not); uniform controls
    after that."""
    env = envs.get_env(name, device=card)
    gen = torch.Generator(card).manual_seed(0)
    Y0s = 2 * torch.rand((N, H, env.action_size), generator=gen,
                         device=card) - 1
    if name == "humanoidrun":
        from mbd_tpu_torch.rollout import replay

        with np.load(replay.FLAG_STATES) as d:
            q, qd, u = (torch.from_numpy(d[f"humanoidrun/{k}"]).to(card)
                        for k in ("q", "qd", "u"))
        k = N // q.shape[0]
        q, qd = q.repeat(k, 1).T.contiguous(), qd.repeat(k, 1).T.contiguous()
        Y0s[:, 0] = u.repeat(k, 1)
    else:
        q, qd = _flagged_states(env, gen, N)
        qd[0, ::4] = 150.0
        qd[3, 2::4] = torch.linspace(60.0, 99.0, len(qd[3, 2::4]),
                                     device=card)
    return env, SimpleNamespace(pipeline_state=SimpleNamespace(q=q, qd=qd)), \
        Y0s


@pytest.mark.cuda
@pytest.mark.parametrize("name,N", [("humanoidrun", 1024), ("hopper", 256)])
def test_kernel_first_flag_matches_plain_version(card, name, N):
    """The kernel's first flagged env step and its acting contact-row
    substeps equal the plain version's, sample by sample, and some samples
    flag; while the recorder counts, the wrapper counts N·H sample-steps,
    Σ H − 1 − first over the flagged samples, the live substeps, those
    times the serial steps of forward kinematics, and the acting contact
    rows, summed on the card."""
    from mbd_tpu_torch.utils import profiling

    env, state0, Y0s = _first_flag_case(card, name, N)
    H = Y0s.shape[1]
    out = rollout_cuda.library(env).run(env, state0, Y0s, first=True,
                                        rows=True)
    plain = rollout_outputs(env, state0, Y0s, first=True, rows=True)
    torch.cuda.synchronize()
    assert torch.equal(out[-2], plain[-2])
    assert torch.equal(out[-1], plain[-1])
    assert torch.equal(out[1], plain[1])
    first = out[-2]
    assert bool((first >= 0).any())
    profiling.clear()
    with profiling.recording(counters=True):
        rollout_cuda.rollout_rewards_cuda(env, state0, Y0s)
    counts = profiling.recorded().counts[0]
    profiling.clear()
    live = int(torch.where(first >= 0, first + 1, H).sum()) * env.n_frames
    stages = rollout_cuda.fk_serial_stages(env.sys)
    assert counts == {"rollout.sample_steps": N * H,
                      "rollout.tail_sample_steps":
                      int(((H - 1) - first[first >= 0]).sum()),
                      "rollout.live_substeps": live,
                      "rollout.fk_stage_substeps": live * stages,
                      "rollout.contact_row_substeps": int(out[-1].sum())}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["humanoidrun", "hopper"])
def test_counting_form_leaves_rewards_and_flags(card, name):
    """Rewards and flags bit for bit the same with the first-flag and rows
    buffers and without them (one kernel: the buffers only add their
    count and writes)."""
    env, state0, Y0s = _first_flag_case(card, name, 512)
    built = rollout_cuda.library(env)
    plain = built.run(env, state0, Y0s)
    counted = built.run(env, state0, Y0s, first=True, rows=True)
    torch.cuda.synchronize()
    assert len(counted) == len(plain) + 2
    for a, b in zip(plain, counted):
        assert torch.equal(a.contiguous().view(torch.int32),
                           b.contiguous().view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("name,N", [("humanoidrun", 1024),
                                    ("humanoidrun", 8192), ("hopper", 16384)])
def test_retiring_form_matches_whole_form(card, name, N):
    """The retiring form against the whole form and against the plain
    version's ``retire`` output: flags and first flags equal; each
    sample's rewards up to and including its first flagged step, and
    every reward of a clean sample, bit for bit; the rest the NaN of bits
    0x7fffffff; every sample asked the queue once, and the kernel ran
    each sample's steps up to its first flag, all H of a clean one. The
    samples past those that reside at once are refills: none for
    humanoidrun at 1 024 (the whole form's grid), some at 8 192 and for
    hopper at 16 384. Counted, the retired sample-steps are the tail, and
    the live substeps and acting contact rows are the whole form's."""
    from mbd_tpu_torch.utils import profiling

    env, state0, Y0s = _first_flag_case(card, name, N)
    H = Y0s.shape[1]
    built = rollout_cuda.library(env)
    rews, bad, first, rows = built.run(env, state0, Y0s, first=True,
                                       rows=True)
    rews_r, bad_r, first_r, rows_r, queue = built.run(
        env, state0, Y0s, first=True, retire=True, rows=True)
    plain = rollout_outputs(env, state0, Y0s, first=True, retire=True)
    torch.cuda.synchronize()
    ran = int(torch.where(first >= 0, first + 1, H).sum())
    assert queue.tolist() == [N, ran]
    assert torch.equal(bad_r, bad) and torch.equal(first_r, first)
    assert torch.equal(rows_r, rows)
    assert bool((first >= 0).any())
    after = (torch.arange(H, device=card)[None] > first[:, None]) & \
        (first >= 0)[:, None]
    bits, bits_r = (r.contiguous().view(torch.int32) for r in (rews, rews_r))
    assert torch.equal(bits_r[~after], bits[~after])
    assert bool((bits_r[after] == 0x7FFFFFFF).all())
    assert torch.equal(plain[0].contiguous().view(torch.int32), bits_r)
    assert torch.equal(plain[1], bad_r) and torch.equal(plain[2], first_r)
    a = built.attrs(N, retire=True)
    resident = a["blocks_per_sm"] * a["threads_per_block"] // a["G"] * \
        torch.cuda.get_device_properties(card).multi_processor_count
    assert (N > resident) == ((name, N) != ("humanoidrun", 1024))
    profiling.clear()
    with profiling.recording(counters=True):
        rollout_cuda.rollout_rewards_cuda(env, state0, Y0s, retire=True)
    counts = profiling.recorded().counts[0]
    profiling.clear()
    tail = int(((H - 1) - first[first >= 0]).sum())
    stages = rollout_cuda.fk_serial_stages(env.sys)
    assert counts == {"rollout.sample_steps": N * H,
                      "rollout.tail_sample_steps": tail,
                      "rollout.retired_sample_steps": tail,
                      "rollout.live_substeps": ran * env.n_frames,
                      "rollout.fk_stage_substeps":
                      ran * env.n_frames * stages,
                      "rollout.contact_row_substeps": int(rows.sum())}


@pytest.mark.cuda
@pytest.mark.parametrize("name,blocks", [("humanoidrun", 4), ("hopper", 5)])
def test_retiring_form_keeps_residency(card, name, blocks):
    """The retiring form resides as the whole form does: 4 blocks an SM
    on humanoidrun, 5 on hopper; its grid stops at the blocks that reside
    at once."""
    env = envs.get_env(name, device=card)
    built = rollout_cuda.library(env)
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    for N in (1024, 65536):
        whole, retire = built.attrs(N), built.attrs(N, retire=True)
        assert whole["blocks_per_sm"] == retire["blocks_per_sm"] == blocks
        assert retire["shared_bytes"] > whole["shared_bytes"]
        assert retire["sms_used"] == whole["sms_used"] == min(
            sms, -(-N // (whole["threads_per_block"] // whole["G"])))


@pytest.mark.cuda
def test_kernel_counts_the_reference_contact_rows_at_a_plan_step(card):
    """humanoidstandup at its planning shape, 2048 × 50: the samples of a
    plan's reverse step 0 (around the zero iterate, from the reset of
    seed 2⁴⁰ + 17), rolled out by the retiring and the whole form while
    the recorder counts; each form's acting contact-row substeps and live
    substeps are the plain reference's (``benchmark/reference``'s
    ``Work``) for that launch."""
    from benchmark.reference import models
    from benchmark.reference import planner as P
    from benchmark.reference.rollout import rollout
    from mbd_tpu_torch.planners import mbd
    from mbd_tpu_torch.utils import profiling

    seed, N, H, T = 2 ** 40 + 17, 2048, 50, 100
    env = envs.get_env("humanoidstandup", device=card)
    model = models.load("humanoidstandup", card)
    sched = P.schedule(T, 1e-4, 1e-2, card)
    d = P.draws(model, [seed], [0], (N, H, env.action_size), card)
    Y0s = P.samples(sched, T - 1, torch.zeros((1, H, env.action_size),
                                              device=card), d.eps[0])[0]
    state0 = mbd.batch_states(
        env, [env.reset(torch.Generator(card).manual_seed(seed))], N)
    counts = []
    for retire in (True, False):
        profiling.clear()
        with profiling.recording(counters=True):
            rollout_cuda.rollout_rewards_cuda(env, state0, Y0s,
                                              retire=retire)
        counts.append(profiling.recorded().counts[0])
    profiling.clear()
    _, _, work = rollout(model, P.seed_major(d.q0, N), P.seed_major(d.qd0, N),
                         Y0s, record=True)
    for c in counts:
        assert c["rollout.contact_row_substeps"] == int(work.contacts.sum())
        assert c["rollout.live_substeps"] == \
            int(work.live_steps.sum()) * env.n_frames
    assert counts[0]["rollout.contact_row_substeps"] > 0
