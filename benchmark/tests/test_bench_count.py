"""The work count: a sample counts only up to and including its first
flagged env step, and only the rows that acted while it was live; a demo
launch counts every sample-step."""

import pytest
import torch

from benchmark.reference import models
from benchmark.reference.rollout import Work, rollout
from benchmark.work import count


def test_flagged_sample_counts_up_to_its_first_flag():
    model = models.load("humanoidrun", "cpu")
    N, H = 3, 3
    q0 = model.sys.init_q[:, None].repeat(1, N).clone()
    q0[2, 0] = -1.0                    # sample 0's root under the floor
    qd0 = torch.zeros((model.sys.nv, N))
    Y0s = torch.zeros((N, H, model.sys.nu))
    _, bad, work = rollout(model, q0, qd0, Y0s, record=True)
    assert bad.tolist() == [1.0, 0.0, 0.0]
    assert work.live_steps.tolist() == [1.0, 3.0, 3.0]
    # rows that acted are counted while the sample is live only
    assert work.n_contacts > 0 and work.n_limits > 0
    full = model.n_frames * (work.n_contacts + work.n_limits)
    assert float(work.contacts[0] + work.limits[0]) <= full
    t = count.tally(work)
    assert t.steps == 7.0
    demo = count.tally(work, demo=True, H=H)
    assert demo.steps == float(N * H)


def test_needed_ops_by_hand():
    work = Work(live_steps=torch.tensor([2.0, 5.0]),
                contacts=torch.tensor([3.0, 0.0]),
                limits=torch.tensor([1.0, 4.0]), n_contacts=2, n_limits=3)
    t = count.tally(work)
    steps, frames = 7.0, 20
    idle_c = steps * frames * 2 - 3.0
    idle_l = steps * frames * 3 - 5.0
    c, l = count.ROW_WORK["hopper"]
    want = steps * count.WORK["hopper", False] - idle_c * c - idle_l * l
    assert count.needed_ops("hopper", frames, t) == pytest.approx(want)
    pw = count.plan_work("hopper", (6, 6, 3), frames, S=1, N=2, H=5, T=1,
                         steps={0: t}, final=t)
    assert pw.ops == pytest.approx(2 * want)
    assert pw.least_s > 0


def _steps(n: float) -> count.Tally:
    """A launch whose n sample-steps had every row acting."""
    return count.Tally(n, n * 20 * 2, n * 20 * 3, 2, 3)


def test_untallied_steps_are_interpolated():
    assert count.tallied_steps(299) == [0, 1, 149, 298]
    assert count.tallied_steps(4) == [0, 1, 2, 3]
    per = count.WORK["hopper", False]
    steps = {0: _steps(10.0), 1: _steps(10.0), 3: _steps(40.0)}
    pw = count.plan_work("hopper", (6, 6, 3), 20, S=1, N=2, H=5, T=4,
                         steps=steps, final=_steps(0.0))
    assert pw.ops == pytest.approx(per * (10 + 10 + 25 + 40))
    with pytest.raises(ValueError):
        count.plan_work("hopper", (6, 6, 3), 20, S=1, N=2, H=5, T=4,
                        steps={0: _steps(1.0)}, final=_steps(0.0))


def test_least_time_takes_the_larger_bound():
    assert count.least_s(67e12, 0) == pytest.approx(1.0)
    assert count.least_s(0, 3.35e12) == pytest.approx(1.0)
    assert count.launch_bytes(6, 6, 3, 2, 5) == 4 * (30 + 24 + 10 + 2)
