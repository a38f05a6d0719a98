"""The port's one recorder, and its tracing and profiling hooks (port of
``mbd_tpu/utils/profiling.py``).

The recorder keeps spans and counters of the program's own phases.
Spans are recorded while a ``torch.profiler`` records in this process (the
benchmark's ``--trace 1``) and inside a ``recording()`` block; counters
under the profiler and inside ``recording(counters=True)``, since feeding
them adds work on the card (the rollout's first-flag buffer and its sum).
Otherwise a span costs one check and is a shared no-op context, and a
count nothing. A recorded span is also a
``torch.profiler.record_function`` range, so it lands in the profiler's
trace on the clock of the card's operations. The recorder keeps at most
``MAX_SPANS`` spans (past them a span records nothing and is counted in
``dropped``) and one running sum a counter and device.

  with span("mbd.step", t=t):           # host start and end, parent, plan
      ...
  with span("mesh.gather", device=True):  # and CUDA events around it
      ...
  count("rollout.sample_steps", N * H)  # a host int or a device tensor
  rec = recorded()                      # rec.spans, rec.counts[rank][name]
  clear()

Besides: a ``torch.profiler`` trace of a block exported as a Chrome
trace, a phase timer that waits for the card before it reads the clock,
and what a trace says of the card: its busy time and its kernels' device
time.

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
import dataclasses
import os
import subprocess
import time
from collections import defaultdict
from typing import Any, Dict, Iterable, Iterator, List, NamedTuple, \
    Optional, Tuple

import torch

TRACE_FILE = "trace.json"
# the program's span names start so (the recorder's namespaces)
SPAN_PREFIXES = ("mbd.", "mesh.")
# the most spans the recorder keeps (a profiled plan records about 5 a
# reverse step)
MAX_SPANS = 1 << 18
# whether a torch.profiler records in this process
_profiler_enabled = torch._C._autograd._profiler_enabled


@dataclasses.dataclass
class Span:
    """One recorded span: ``parent`` is the index of the span it ran in
    within ``recorded().spans``, ``plan`` the id of the ``mbd.plan`` it
    belongs to (a per-process count, the same on every rank for the same
    plan), ``start`` and ``end`` the host's ``perf_counter`` seconds and,
    for a span opened with ``device=True``, ``device_ms`` the time between
    its CUDA events."""
    name: str
    parent: Optional[int]
    plan: Optional[int]
    rank: int
    start: float
    end: Optional[float] = None
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    device_ms: Optional[float] = None
    events: Any = dataclasses.field(default=None, repr=False)

    @property
    def host_s(self) -> float:
        return self.end - self.start


class Recorded(NamedTuple):
    """What the recorder holds: the spans, each closed one resolved, the
    counters' totals by rank and name, and the spans not kept past
    ``MAX_SPANS``."""
    spans: List[Span]
    counts: Dict[int, Dict[str, int]]
    dropped: int = 0


def _rank() -> int:
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


class Recorder:
    """Spans and counters (the module's ``span``, ``count``,
    ``recorded``, ``clear`` and ``recording`` act on one of these)."""

    def __init__(self):
        self.forced = self.forced_counts = 0
        self.spans: List[Span] = []
        self.open: List[int] = []
        # (rank, name) → [host total, {device: its running sum}]
        self.counts: Dict[Tuple[int, str], list] = {}
        self.plans = self.dropped = 0

    def on(self) -> bool:
        return self.forced > 0 or _profiler_enabled()

    def counting(self) -> bool:
        return self.forced_counts > 0 or _profiler_enabled()

    def enter(self, name: str, device: bool, plan: bool,
              attrs: dict) -> Span:
        parent = self.open[-1] if self.open else None
        up = self.spans[parent] if parent is not None else None
        if plan:
            plan_id, self.plans = self.plans, self.plans + 1
        else:
            plan_id = up.plan if up is not None else None
        rec = Span(name, parent, plan_id,
                   up.rank if up is not None else _rank(), 0.0,
                   attrs=attrs)
        self.open.append(len(self.spans))
        self.spans.append(rec)
        if device:
            rec.events = [torch.cuda.Event(enable_timing=True)
                          for _ in "se"]
            rec.events[0].record()
        rec.start = time.perf_counter()
        return rec

    def exit(self, rec: Span) -> None:
        rec.end = time.perf_counter()
        if rec.events is not None:
            rec.events[1].record()
        if self.open:
            self.open.pop()

    def count(self, name: str, value) -> None:
        entry = self.counts.setdefault((_rank(), name), [0, {}])
        if isinstance(value, torch.Tensor):
            value = value.reshape(()).to(torch.int64)
            sums = entry[1]
            sums[value.device] = sums[value.device] + value \
                if value.device in sums else value
        else:
            entry[0] += int(value)

    def recorded(self) -> Recorded:
        for rec in self.spans:
            if rec.events is not None and rec.end is not None:
                rec.events[1].synchronize()
                rec.device_ms = rec.events[0].elapsed_time(rec.events[1])
                rec.events = None
        counts: Dict[int, Dict[str, int]] = {}
        for (rank, name), entry in self.counts.items():
            entry[0] += sum(int(t) for t in entry[1].values())
            entry[1] = {}
            counts.setdefault(rank, {})[name] = entry[0]
        return Recorded([dataclasses.replace(s, events=None)
                         for s in self.spans], counts, self.dropped)

    def merge(self, rec: Recorded, rank: int) -> None:
        base = len(self.spans)
        kept = rec.spans[:max(0, MAX_SPANS - base)]
        for s in kept:
            self.spans.append(dataclasses.replace(
                s, rank=rank,
                parent=None if s.parent is None else s.parent + base))
        self.dropped += rec.dropped + len(rec.spans) - len(kept)
        for names in rec.counts.values():
            for name, value in names.items():
                self.counts.setdefault((rank, name), [0, {}])[0] += value

    def clear(self) -> None:
        self.spans, self.open, self.counts = [], [], {}
        self.dropped = 0


RECORDER = Recorder()


class _Span:
    """A recorded span as a context (``span``)."""
    __slots__ = ("args", "fn", "rec")

    def __init__(self, *args):
        self.args = args

    def __enter__(self):
        self.fn = torch.profiler.record_function(self.args[0])
        self.fn.__enter__()
        self.rec = RECORDER.enter(*self.args)
        return self.rec

    def __exit__(self, *exc):
        RECORDER.exit(self.rec)
        self.fn.__exit__(*exc)
        return False


_OFF = contextlib.nullcontext()


def span(name: str, device: bool = False, plan: bool = False, **attrs):
    """A context that records the block as a span named ``name`` with
    ``attrs``, while recording is on (``recording()``, or a
    ``torch.profiler`` recording); otherwise a shared no-op context.
    ``device``: with CUDA events on the current stream around it, whose
    time ``recorded()`` resolves. ``plan``: the span starts a plan, whose
    id the spans inside it carry."""
    if not RECORDER.on():
        return _OFF
    if len(RECORDER.spans) >= MAX_SPANS:
        RECORDER.dropped += 1
        return _OFF
    return _Span(name, device, plan, attrs)


def count(name: str, value) -> None:
    """Adds ``value`` (a host int, or an integer tensor of one element,
    summed on its device and read when the records are) to this rank's
    counter ``name``, while counters are on."""
    if RECORDER.counting():
        RECORDER.count(name, value)


def on() -> bool:
    """Whether spans are recorded now."""
    return RECORDER.on()


def counting() -> bool:
    """Whether counters are kept now (a profiler records, or
    ``recording(counters=True)``): the program feeds them only then."""
    return RECORDER.counting()


def recorded() -> Recorded:
    """The spans (each closed one's CUDA events resolved, which waits for
    them) and the counters' totals."""
    return RECORDER.recorded()


def merge(rec: Recorded, rank: int) -> None:
    """Adds another process's ``recorded()`` to this recorder, its spans
    and counts tagged ``rank`` (the mesh's ranks hand theirs back so), up
    to ``MAX_SPANS`` spans."""
    RECORDER.merge(rec, rank)


def clear() -> None:
    """Empties the recorder (plan ids keep counting)."""
    RECORDER.clear()


@contextlib.contextmanager
def recording(counters: bool = False) -> Iterator[None]:
    """Records spans inside the block, with no profiler, and with
    ``counters`` the counters too."""
    RECORDER.forced += 1
    RECORDER.forced_counts += int(counters)
    try:
        yield
    finally:
        RECORDER.forced -= 1
        RECORDER.forced_counts -= int(counters)


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
    copies and sets, each with its device time range; the spans' ranges
    that the profiler draws on the card's timeline are not among them."""
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.is_user_annotation]


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
