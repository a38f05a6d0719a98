"""Tracing and profiling hooks (port of ``mbd_tpu/utils/profiling.py``):
a ``torch.profiler`` trace of a block, exported as a Chrome trace, and a
phase timer that waits for the card before it reads the clock.

  with trace("results/trace"):          # writes results/trace/trace.json
      mbd.plan(env, cfg, gen)

  t = Timer()
  with t.phase("rollout"):
      ...
  print(t.report())
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """``torch.profiler`` over the block, the card's activity included
    when CUDA has a card, exported to ``<log_dir>/trace.json`` (open it in
    chrome://tracing or Perfetto). Yields the profiler, whose
    ``key_averages()`` summarise the block."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


class Timer:
    """Accumulating wall-clock phase timer. With ``sync``, a phase ends
    with ``torch.cuda.synchronize()`` once CUDA is in use, so that it
    counts the card's work it queued."""

    def __init__(self, sync: bool = True):
        self._acc: Dict[str, float] = defaultdict(float)
        self._count: Dict[str, int] = defaultdict(int)
        self._sync = sync

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self._sync and torch.cuda.is_initialized():
                torch.cuda.synchronize()
            self._acc[name] += time.perf_counter() - t0
            self._count[name] += 1

    def report(self) -> str:
        total = sum(self._acc.values()) or 1.0
        lines = []
        for name, t in sorted(self._acc.items(), key=lambda kv: -kv[1]):
            lines.append(f"{name:24s} {t:8.3f}s  {100 * t / total:5.1f}%  "
                         f"(x{self._count[name]})")
        return "\n".join(lines)

    def as_dict(self) -> Dict[str, float]:
        return dict(self._acc)
