"""rollout_contact_rows: the mean number of contact rows the rollout
kernel solves in a live substep: the program's counters
``rollout.contact_row_substeps`` (each sample's contact rows whose force
cap is not 0, summed over the substeps of the env steps that start with
the sample unflagged) over ``rollout.live_substeps`` (Σ over the samples
of (their first flagged env step + 1, or H) × n_frames), over the
window's launches, summed over the ranks. Read from the program's
recorder (``mbd_tpu_torch/utils/profiling.py``), which counts only while
the window's profiler records; nothing to read where it counted no live
substep, or where the program has no such counters."""

from mbd_tpu_torch.utils import profiling


def read(record):
    recorded = getattr(profiling, "recorded", None)
    if recorded is None:
        return None
    counts = recorded().counts.values()
    live = sum(c.get("rollout.live_substeps", 0) for c in counts)
    if live <= 0 or not any("rollout.contact_row_substeps" in c
                            for c in counts):
        return None
    return sum(c.get("rollout.contact_row_substeps", 0)
               for c in counts) / live
