"""rollout_tail_share: the share of the rollout kernel's sample-steps that
come after a sample's first flagged env step, work no planner reads: the
program's counters ``rollout.tail_sample_steps`` (Σ over the flagged
samples of H − 1 − their first flagged step, from the kernel's counting
form) over ``rollout.sample_steps`` (N·H a launch), over the window's
launches, summed over the ranks. Read from the program's recorder
(``mbd_tpu_torch/utils/profiling.py``), which counts only while the
window's profiler records; nothing to read where it counted none."""

from mbd_tpu_torch.utils import profiling


def read(record):
    recorded = getattr(profiling, "recorded", None)
    if recorded is None:
        return None
    counts = recorded().counts.values()
    steps = sum(c.get("rollout.sample_steps", 0) for c in counts)
    if steps <= 0:
        return None
    return sum(c.get("rollout.tail_sample_steps", 0) for c in counts) / steps
