"""prologue_share: the host seconds of the program's ``mbd.prologue``
spans (each plan's set-up before its first reverse step: the resets, the
schedule, the reverse step's making, a checkpoint's resume) over the
traced window, the largest over the ranks. Read from the program's
recorder (``mbd_tpu_torch/utils/profiling.py``), which records only while
the window's profiler does; nothing to read where it recorded none."""

from mbd_tpu_torch.utils import profiling


def read(record):
    recorded = getattr(profiling, "recorded", None)
    if recorded is None:
        return None
    seconds = {}
    for s in recorded().spans:
        if s.name == "mbd.prologue" and s.end is not None:
            seconds[s.rank] = seconds.get(s.rank, 0.0) + s.end - s.start
    windows = [r["window_s"] for r in record["ranks"]]
    shares = [v / windows[r] for r, v in seconds.items()
              if r < len(windows) and windows[r] > 0]
    return max(shares) if shares else None
