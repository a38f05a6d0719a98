"""rollout_retire_share: the share of the rollout kernel's sample-steps
that the retiring form did not run, each sample having ended at its first
flagged env step: the program's counters ``rollout.retired_sample_steps``
(a retiring launch's N·H less the env steps its kernel counted as it ran
them) over ``rollout.sample_steps`` (N·H a launch, every launch),
over the window's launches, summed over the ranks. Read from the program's
recorder (``mbd_tpu_torch/utils/profiling.py``), which counts only while
the window's profiler records; nothing to read where it counted no
sample-step, or where the program has no retiring form."""

from mbd_tpu_torch.utils import profiling


def read(record):
    recorded = getattr(profiling, "recorded", None)
    if recorded is None:
        return None
    counts = recorded().counts.values()
    steps = sum(c.get("rollout.sample_steps", 0) for c in counts)
    if steps <= 0 or not any("rollout.retired_sample_steps" in c
                             for c in counts):
        return None
    return sum(c.get("rollout.retired_sample_steps", 0)
               for c in counts) / steps
