"""The window's rule with a fake plan and a fake clock: the first plan
always runs, another only while the last plan's wall fits in what is
left, no plan is cut, and plan_s is the span over the plans."""

import pytest

from benchmark.harness import window
from benchmark.metrics import plan_s


class Clock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def fake(clock, walls):
    def plan(k):
        clock.now += walls[k]
        return k
    return plan


@pytest.mark.parametrize("walls, seconds, plans", [
    ([27.7, 27.7], 30, 1),            # the first always runs
    ([40.0], 30, 1),                  # longer than the window, not cut
    ([3.7] * 10, 30, 8),              # 8 × 3.7 = 29.6; a 9th would not fit
    ([3.0] * 12, 30, 10),             # ends exactly at 30
    ([11.45] * 3, 30, 2),
])
def test_plans_fit_whole(walls, seconds, plans):
    clock = Clock()
    w = window.run(fake(clock, walls), seconds, clock=clock)
    assert w.plans == plans
    assert w.results == list(range(plans))
    assert w.walls == pytest.approx(walls[:plans])
    assert w.span_s == pytest.approx(sum(walls[:plans]))
    record = dict(span_s=w.span_s, plans=w.plans)
    assert plan_s.read(record) == pytest.approx(sum(walls[:plans]) / plans)


def test_agree_and_end():
    clock = Clock()
    asked, ended = [], []

    def agree(go):
        asked.append(go)
        return len(asked) < 3         # rank 0 says: three plans

    def end():
        ended.append(clock.now)
        clock.now += 0.5              # a barrier's wait is in the span

    w = window.run(fake(clock, [1.0] * 5), 100, clock=clock, agree=agree,
                   end=end)
    assert w.plans == 3 and asked == [True] * 3
    assert ended == [3.0] and w.span_s == pytest.approx(3.5)
