"""One reader a metric: ``metrics/<name>.py`` holds ``read(record)``, the
metric's value from a run's record, or None where there is nothing to
read. The record (``harness/report.py``): ``plans``, ``span_s`` (the
window from the first plan's start to the last one's end), ``walls``,
``setup_s``, ``chips``, ``work`` (``needed_ops`` and ``least_s`` of the
window's plans, from ``benchmark/work/count.py``), ``counts`` (the
program's counters over the window, summed over the ranks) and, traced,
``ranks``: per rank ``busy_s``, ``window_s``, ``nccl_s`` and ``ops``
(device seconds by operation name)."""
