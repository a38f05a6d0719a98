"""rollout_fk_stages: the serial steps of forward kinematics in the rollout
kernel's substep, a live substep's mean: the program's counters
``rollout.fk_stage_substeps`` (each launch's live substeps times its build's
serial steps of forward kinematics: the body tree's levels where the group's
lanes split it, the bodies one after another on lane 0 where they do not)
over ``rollout.live_substeps`` (Σ over the samples of (their first flagged
env step + 1, or H) × n_frames), over the window's launches, summed over the
ranks. Read from the program's recorder
(``mbd_tpu_torch/utils/profiling.py``), which counts only while the
window's profiler records; nothing to read where it counted no live
substep, or where the program has no such counter."""

from mbd_tpu_torch.utils import profiling


def read(record):
    recorded = getattr(profiling, "recorded", None)
    if recorded is None:
        return None
    counts = recorded().counts.values()
    live = sum(c.get("rollout.live_substeps", 0) for c in counts)
    if live <= 0 or not any("rollout.fk_stage_substeps" in c
                            for c in counts):
        return None
    return sum(c.get("rollout.fk_stage_substeps", 0) for c in counts) / live
