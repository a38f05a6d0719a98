"""The measured window: whole plans back to back.

The first plan always runs; another starts only while the last plan's
wall still fits in what is left of the window's seconds; no plan is ever
cut. ``plan(k)`` runs plan k to its end (a ``torch.cuda.synchronize()``
on the card). ``agree(go)`` lets ranks that plan together take one
decision (rank 0's); ``end()`` runs before the window's last clock
reading (a barrier across ranks).
"""

from __future__ import annotations

import time
from typing import Any, Callable, List, NamedTuple, Optional


class Window(NamedTuple):
    span_s: float          # from the first plan's start to the last's end
    walls: List[float]     # each plan's wall
    results: List[Any]     # each plan's result

    @property
    def plans(self) -> int:
        return len(self.walls)


def run(plan: Callable[[int], Any], seconds: float,
        clock: Callable[[], float] = time.perf_counter,
        agree: Optional[Callable[[bool], bool]] = None,
        end: Optional[Callable[[], None]] = None) -> Window:
    walls, results = [], []
    t0 = clock()
    while True:
        start = clock()
        results.append(plan(len(walls)))
        stop = clock()
        walls.append(stop - start)
        go = walls[-1] <= seconds - (stop - t0)
        if agree is not None:
            go = agree(go)
        if not go:
            break
    if end is not None:
        end()
    return Window(clock() - t0, walls, results)
