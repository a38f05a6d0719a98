"""The port's utilities on the CPU: the native launcher's wrapper
(``mbd_tpu_torch/utils/launcher.py``), the phase timer and the profiler
trace (``mbd_tpu_torch/utils/profiling.py``)."""

import json
import os
import sys
import time

import torch

from mbd_tpu_torch.utils import launcher, profiling


def test_launcher_runs_tasks_and_reports_a_failure():
    """Two trivial tasks and one that exits non-zero: two results and one
    failed record."""
    code = ("import json, sys\n"
            "t = int('{task}')\n"
            "sys.exit(3) if t < 0 else print(json.dumps({'t': t}))\n")
    res = launcher.run_tasks([sys.executable, "-c", code],
                             tasks=["1", "2", "-1"], timeout_sec=30,
                             retries=0, jobs=2)
    assert len(res) == 3
    ok = sorted(r["result"]["t"] for r in res if not r.get("failed"))
    assert ok == [1, 2]
    failed = [r for r in res if r.get("failed")]
    assert [r["task"] for r in failed] == ["-1"]


def test_timer_reports_each_phase():
    t = profiling.Timer()
    for _ in range(2):
        with t.phase("rollout"):
            time.sleep(0.02)
    with t.phase("stats"):
        pass
    acc = t.as_dict()
    assert acc["rollout"] >= 0.04 and acc["stats"] < acc["rollout"]
    lines = t.report().splitlines()
    assert lines[0].startswith("rollout") and "(x2)" in lines[0]
    assert lines[1].startswith("stats") and "(x1)" in lines[1]


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "tr")) as prof:
        torch.ones(64).cumsum(0)
    path = tmp_path / "tr" / profiling.TRACE_FILE
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("cumsum" in e.get("name", "") for e in events)
    assert any("cumsum" in a.key for a in prof.key_averages())
    assert os.path.getsize(path) > 0
