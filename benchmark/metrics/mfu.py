"""mfu (%): the operations the window's plans need (``benchmark/work``)
over the traced window, over the float32 peak of the cell's cards (67
TFLOP/s each, outside the tensor cores, at 700 W)."""

from benchmark.work.count import PEAK_FLOPS


def read(record):
    windows = [r["window_s"] for r in record["ranks"]]
    if not windows or max(windows) <= 0:
        return None
    return 100.0 * record["work"]["needed_ops"] / max(windows) / (
        PEAK_FLOPS * record["chips"])
