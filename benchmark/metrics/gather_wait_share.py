"""gather_wait_share: the time the mesh's ranks wait in the gather for the
slowest one, apart from the transfer. The program's ``mesh.gather`` spans
time each all_reduce on the card with CUDA events; the k-th gather's
transfer is its least device time over the ranks, and a rank's wait is
the sum over the gathers of its device time less that least. The metric
is the largest wait over its rank's traced window. Read from the
program's recorder (``mbd_tpu_torch/utils/profiling.py``), into which the
ranks hand theirs back; nothing to read on fewer than two ranks or where
none was recorded."""

from mbd_tpu_torch.utils import profiling


def read(record):
    recorded = getattr(profiling, "recorded", None)
    if recorded is None:
        return None
    ms = {}
    for s in recorded().spans:
        if s.name == "mesh.gather" and s.device_ms is not None:
            ms.setdefault(s.rank, []).append(s.device_ms)
    windows = [r["window_s"] for r in record["ranks"]]
    ranks = [r for r in ms if r < len(windows) and windows[r] > 0]
    if len(ranks) < 2:
        return None
    calls = min(len(ms[r]) for r in ranks)
    least = [min(ms[r][k] for r in ranks) for k in range(calls)]
    return max(sum(ms[r][k] - least[k] for k in range(calls)) / 1e3
               / windows[r] for r in ranks)
