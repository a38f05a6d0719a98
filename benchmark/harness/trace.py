"""What a ``torch.profiler`` trace of the window says: the device's busy
time (the union of its operations' intervals), the device operations that
took most of it, the longest idle gaps with the host operation that ran
during each, and the device time of operations by name (``nccl`` ones
among them). The events stay in memory; nothing is written to disk.

Reductions after ``mbd_tpu_torch/utils/profiling.py`` at commit f68a38a
(``device_events``, ``busy_us``, ``kernel_totals``).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, List, Tuple

import torch

TOP = 10
# the harness's own spans around the window and each plan
WINDOW, PLAN = "benchmark.window", "benchmark.plan"


def merged(spans: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of the intervals as disjoint sorted intervals."""
    out: List[Tuple[float, float]] = []
    for lo, hi in sorted(spans):
        if out and lo <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return out


def totals(events) -> Dict[str, List[float]]:
    """Per device event name, [count, seconds summed]."""
    per: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    for e in events:
        per[e.name][0] += 1
        per[e.name][1] += e.time_range.elapsed_us() / 1e6
    return dict(per)


def gaps(busy: List[Tuple[float, float]], lo: float, hi: float
         ) -> List[Tuple[float, float]]:
    """The idle intervals of [lo, hi] between the busy ones."""
    out, cur = [], lo
    for b0, b1 in busy:
        if b0 > cur:
            out.append((cur, min(b0, hi)))
        cur = max(cur, b1)
    if cur < hi:
        out.append((cur, hi))
    return [(a, b) for a, b in out if b > a]


def host_op(cpu, gap: Tuple[float, float]) -> str:
    """The host operation that ran during most of ``gap``: of the host
    events that overlap it, the one overlapping longest, the shortest of
    those; the harness's own spans do not count."""
    best, key = "host, between operations", None
    for e in cpu:
        lo, hi = e.time_range.start, e.time_range.end
        overlap = min(hi, gap[1]) - max(lo, gap[0])
        if overlap <= 0:
            continue
        k = (overlap, -(hi - lo))
        if key is None or k > key:
            best, key = e.name, k
    return best


def reduce(prof) -> dict:
    """The window's summary from a finished profiler: ``busy_s``,
    ``window_s`` (the harness's window span as traced), ``device_ops``
    and ``idle_gaps`` ([[name, seconds]], at most ``TOP`` each) and
    ``ops`` (every device name: [count, seconds])."""
    events = prof.events()
    # the device's operations; spans (the harness's, or any the program
    # records) are annotations on the device's timeline, not operations
    device = [e for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)
              and e.name not in (WINDOW, PLAN)]
    cpu = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CPU
           and e.name not in (WINDOW, PLAN)]
    windows = [e for e in events if e.name == WINDOW]
    busy = merged((e.time_range.start, e.time_range.end) for e in device)
    if windows:
        lo, hi = windows[0].time_range.start, windows[0].time_range.end
    else:
        lo = busy[0][0] if busy else 0.0
        hi = busy[-1][1] if busy else 0.0
    clipped = [(max(a, lo), min(b, hi)) for a, b in busy if b > lo and a < hi]
    idle = sorted(gaps(clipped, lo, hi), key=lambda g: g[0] - g[1])[:TOP]
    ops = totals(device)
    top = sorted(ops.items(), key=lambda kv: -kv[1][1])[:TOP]
    return dict(
        busy_s=sum(b - a for a, b in clipped) / 1e6,
        window_s=(hi - lo) / 1e6,
        device_ops=[[name, v[1]] for name, v in top],
        idle_gaps=[[host_op(cpu, g), (g[1] - g[0]) / 1e6] for g in idle],
        ops=ops)


def named_s(ops: Dict[str, List[float]], part: str) -> float:
    """The device seconds of the operations whose name holds ``part``
    (any case)."""
    part = part.lower()
    return sum(v[1] for k, v in ops.items() if part in k.lower())
