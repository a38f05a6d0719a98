"""Python wrapper of the native fault-tolerant experiment executor
(``native/launcher``, C++; port of ``mbd_tpu/utils/launcher.py``). Used
for multi-seed / multi-temperature sweeps where each run is an isolated
subprocess: a fault or hang of the card's runtime costs one retry, not
the sweep.

The port builds its own binary with the same Makefile from a copy of the
same sources in ``build/launcher/`` at the repository's root, under a
file lock, so that it never races the JAX package's build in
``native/launcher/build/``.
"""

from __future__ import annotations

import fcntl
import json
import os
import shutil
import subprocess
from typing import Dict, List, Sequence

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(ROOT, "native", "launcher")
_BUILD_DIR = os.path.join(ROOT, "build", "launcher")
_BINARY = os.path.join(_BUILD_DIR, "build", "mbd_launcher")


def ensure_built() -> str:
    """The launcher binary, built with ``make`` on first use."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    with open(os.path.join(_BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(_BINARY):
            for name in ("Makefile", "launcher.cc"):
                shutil.copy(os.path.join(_NATIVE_DIR, name), _BUILD_DIR)
            subprocess.run(["make", "-C", _BUILD_DIR, "build/mbd_launcher"],
                           check=True, capture_output=True)
    return _BINARY


def run_tasks(cmd_template: Sequence[str], tasks: Sequence[str],
              timeout_sec: int = 3600, retries: int = 1,
              jobs: int = 1) -> List[Dict]:
    """Run ``cmd_template`` (with ``{task}`` placeholders) once per task.

    Each worker process must print one JSON line on success. Returns the
    parsed aggregate records (``failed: true`` entries for tasks that
    exhausted retries).
    """
    binary = ensure_built()
    cmd = [binary, "--timeout", str(timeout_sec), "--retries", str(retries),
           "--jobs", str(jobs), "--"] + list(cmd_template)
    # stderr is not captured: the workers inherit it through the native
    # launcher, and it carries the only diagnostics when a task fails
    proc = subprocess.run(cmd, input="\n".join(tasks) + "\n",
                          stdout=subprocess.PIPE, stderr=None, text=True)
    return [json.loads(line) for line in proc.stdout.splitlines()
            if line.startswith("{")]
