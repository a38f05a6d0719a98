"""Tracing and profiling hooks (port of ``mbd_tpu/utils/profiling.py``):
a ``torch.profiler`` trace of a block, exported as a Chrome trace, a
phase timer that waits for the card before it reads the clock, and what
a trace says of the card: its busy time and its kernels' device time.

  with trace("results/trace"):          # writes results/trace/trace.json
      mbd.plan(env, cfg, gen)

  t = Timer()
  with t.phase("rollout"):
      ...
  print(t.report())

  kernels = device_events(prof)         # prof: a finished torch.profiler
  busy = busy_us([(e.time_range.start, e.time_range.end) for e in kernels])
  count, us = named(kernel_totals(kernels), "rollout_kernel")
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import time
from collections import defaultdict
from typing import Dict, Iterable, Iterator, List, Tuple

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


def card() -> str:
    """The first card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them, e.g.
    "NVIDIA H100 80GB HBM3, 700.00 W": a card may be set below its
    maximum power and then runs slower, so every measurement names it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


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


def device_events(prof) -> list:
    """The card's events of a finished ``torch.profiler`` trace: kernels,
    copies and sets, each with its device time range."""
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def busy_us(spans: Iterable[Tuple[float, float]]) -> float:
    """The length of the union of the intervals (start, end): the time in
    which at least one of them ran (0 without any)."""
    spans = sorted(spans)
    if not spans:
        return 0.0
    busy, cur_lo, cur_hi = 0.0, *spans[0]
    for lo, hi in spans[1:]:
        if lo > cur_hi:
            busy += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    return busy + cur_hi - cur_lo


def kernel_totals(events) -> Dict[str, List[float]]:
    """Per event name, [count, device µs summed]."""
    per_name: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    for e in events:
        per_name[e.name][0] += 1
        per_name[e.name][1] += e.time_range.elapsed_us()
    return per_name


def named(per_name: Dict[str, List[float]], part: str) -> Tuple[int, float]:
    """The count and device µs of ``kernel_totals``'s names that hold
    ``part`` (the profiler names a kernel by its C symbol, with a prefix
    and arguments around it)."""
    return tuple(sum(v[i] for k, v in per_name.items() if part in k)
                 for i in (0, 1))
