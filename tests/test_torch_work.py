"""The fixed work count (``mbd_tpu_torch/utils/work.py``): ``WORK``
equals the live count of the plain version for every model the kernel
builds, its demo mode and car2d's analytic step, exactly, and
``ROW_WORK`` the live count of an idle row's work; the bounds it gives
are the digits the smoke printed before the table existed; the rows the
plain engine records and the work they leave out add up; and the rollout
wrapper counts the sample-steps it rolls out on the CPU too."""

import pytest
import torch

from mbd_tpu_torch import envs
from mbd_tpu_torch.ops import rollout_cuda
from mbd_tpu_torch.utils import work


@pytest.mark.parametrize("key", sorted(work.WORK),
                         ids=lambda k: k[0] + "+demo" * k[1])
def test_work_is_the_live_count(key):
    """A change to the plain engine or to torch's dispatch that moves the
    count must update the table in the open."""
    assert work.ops_per_sample_step(*key) == work.WORK[key]


@pytest.mark.parametrize("name", sorted(work.ROW_WORK))
def test_row_work_is_the_live_count(name):
    assert work.row_ops(name) == work.ROW_WORK[name]


def test_work_holds_the_published_counts():
    assert work.WORK["hopper", False] == 229_745
    assert work.WORK["pushT", False] == 37_035
    assert work.WORK["humanoidrun", False] == 412_475
    assert work.WORK["humanoidtrack", False] == 390_205
    assert work.WORK["humanoidtrack", True] == 394_014


@pytest.mark.parametrize("name,N,H,demo,ms", [
    ("hopper", 2048, 50, False, "0.3511"),
    ("humanoidrun", 8192, 50, False, "2.5216"),
    ("humanoidtrack", 2048, 50, True, "0.6022"),
    ("pushT", 2048, 40, False, "0.0453")])
def test_bound_digits(name, N, H, demo, ms):
    """The smoke's bound lines at the paths' shapes (operations bound
    them)."""
    env = envs.get_env(name, device="cpu")
    bound, by = work.rollout_bound(env, name, N, H, demo=demo)
    assert (f"{bound:.4f}", by) == (ms, "operations")


def test_bound_by_bytes():
    assert work.bound_ms(1.0, work.PEAK_BYTES / 1e3) == (1.0, "bytes")
    assert work.bound_ms(work.PEAK_FLOPS / 1e3, 1.0) == (1.0, "operations")


def test_wrapper_counts_sample_steps_on_the_cpu():
    """``SAMPLE_STEPS`` gains N·H a rollout on a CPU tensor
    (``DEMO_SAMPLE_STEPS`` N·H with the demo); ``LAUNCHES`` stays the
    card's."""
    env = envs.get_env("cartpole", device="cpu")
    state0 = env.reset(torch.Generator().manual_seed(0))
    before = (rollout_cuda.SAMPLE_STEPS, rollout_cuda.DEMO_SAMPLE_STEPS,
              rollout_cuda.LAUNCHES)
    rollout_cuda.rollout_rewards_cuda(env, state0, torch.zeros((3, 2, 1)))
    track = envs.get_env("humanoidtrack", device="cpu")
    rollout_cuda.rollout_rewards_cuda(
        track, track.reset(None), torch.zeros((2, 1, track.action_size)),
        demo=True)
    assert (rollout_cuda.SAMPLE_STEPS, rollout_cuda.DEMO_SAMPLE_STEPS,
            rollout_cuda.LAUNCHES) == (before[0] + 6 + 2, before[1] + 2,
                                       before[2])


def test_acting_rows_of_a_rollout():
    """The rows recorded over a hopper rollout: every row of every substep
    and sample, the acting ones among them; the record is off again
    after; and the work they leave out is ``ROW_WORK`` per idle row."""
    from mbd_tpu_torch.rollout.fused import rollout_outputs
    from mbd_tpu_torch.sim import batched

    env = envs.get_env("hopper", device="cpu")
    gen = torch.Generator().manual_seed(0)
    state0 = env.reset(gen)
    N, H = 3, 4
    Y0s = 2.0 * torch.rand((N, H, env.action_size), generator=gen) - 1.0
    (rews, _), rows = work.acting_rows(rollout_outputs, env, state0, Y0s)
    assert batched.ROW_LOG is None
    assert torch.equal(rews, rollout_outputs(env, state0, Y0s)[0])
    # hopper: 11 contact rows and 6 limit rows a substep
    steps = env.n_frames * N * H
    assert (rows.contacts, rows.limits) == (11 * steps, 6 * steps)
    assert 0 < rows.contacts_acting < rows.contacts
    assert 0 <= rows.limits_acting < rows.limits
    need = work.needed_per_sample_step("hopper", False, rows, N * H)
    idle = (rows.contacts - rows.contacts_acting) * 393 + \
        (rows.limits - rows.limits_acting) * 209
    assert need == pytest.approx(229_745 - idle / (N * H), rel=1e-12)
    every = work.Rows(5, 5, 7, 7)
    assert work.needed_per_sample_step("hopper", False, every, 1) == 229_745
    none = work.Rows(0, 11 * env.n_frames, 0, 6 * env.n_frames)
    assert work.needed_per_sample_step("hopper", False, none, 1) == \
        229_745 - env.n_frames * (11 * 393 + 6 * 209)
