"""A cell and everything it names, found by name under ``benchmark/``.

``BENCHMARK.json`` (at the root of the checkout) lists the cells, their
configuration, traffic mix and chips, and the metrics. Each name leads to
a file of its own, so that a later change adds a cell or a metric by
adding files and entries only:

* ``configs/<config>.json``: the planner's settings as run (env, Nsample,
  Hsample, Ndiffuse, temp_sample, beta0, betaT, enable_demo), with its
  ``source``, ``reduced`` and ``assumed``; the reference's model of the
  same ``env`` is ``reference/models/<env>.py``;
* ``traffic/<traffic>.json``: the mix: ``entry`` (``plan`` or
  ``plan_batch``), ``seeds_per_plan``, ``problems`` (the fixed set of
  plans a window goes through, in an order drawn from the run's seed) and
  ``warmup_diffuse_steps``; a cell of several chips runs its entry over
  one NCCL rank a card;
* ``workloads/<cell>.json``: the cell's config, traffic and chips (as in
  ``BENCHMARK.json``) and the ``limits`` of the numbers compared;
* ``metrics/<metric>.py``: ``read(record)``, the metric from a run's
  record, or None where there is nothing to read.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
from dataclasses import dataclass
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}\Z")
CONFIG_KEYS = ("env", "Nsample", "Hsample", "Ndiffuse", "temp_sample",
               "beta0", "betaT", "enable_demo")
TRAFFIC_KEYS = ("entry", "seeds_per_plan", "problems",
                "warmup_diffuse_steps")
ENTRIES = ("plan", "plan_batch")


class SpecError(ValueError):
    """A cell's files are missing or disagree."""


def _load(path: str) -> dict:
    if not os.path.exists(path):
        raise SpecError(f"{os.path.relpath(path, ROOT)} is missing")
    with open(path) as f:
        return json.load(f)


def checked_name(name: str) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise SpecError(f"{name!r} is not a name: 1 to 64 of letters, "
                        f"digits, '_', '.', '-', not starting with '.' "
                        f"or '-'")
    return name


@dataclass
class Metric:
    name: str
    unit: str
    better: str
    read: object          # metrics/<name>.py's read(record)


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[Metric]
    per_layer: List[Metric]

    @property
    def seeds(self) -> int:
        return self.traffic["seeds_per_plan"]


def metric(entry: dict, root: str = ROOT) -> Metric:
    """A metric of ``BENCHMARK.json`` with its reader."""
    name = checked_name(entry["name"])
    if not UNIT.match(entry["unit"]):
        raise SpecError(f"{name}: unit {entry['unit']!r}")
    path = os.path.join(root, "benchmark", "metrics", f"{name}.py")
    if not os.path.exists(path):
        raise SpecError(f"metric {name}: benchmark/metrics/{name}.py is "
                        f"missing")
    found = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{name}", path)
    module = importlib.util.module_from_spec(found)
    found.loader.exec_module(module)
    return Metric(name, entry["unit"], entry["better"], module.read)


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load(cell: str, root: str = ROOT,
         bench: Optional[dict] = None) -> Cell:
    """The cell ``cell`` of ``BENCHMARK.json`` (or of ``bench``) with its
    files; raises SpecError when one is missing or disagrees."""
    bench = bench if bench is not None else _load(
        os.path.join(root, "BENCHMARK.json"))
    rows = [w for w in bench["workloads"] if w["name"] == cell]
    if not rows:
        raise SpecError(f"no workload {cell!r} in BENCHMARK.json: "
                        f"{[w['name'] for w in bench['workloads']]}")
    row = rows[0]
    base = os.path.join(root, "benchmark")
    own = _load(os.path.join(base, "workloads", f"{checked_name(cell)}.json"))
    for key in ("config", "traffic", "chips"):
        if own.get(key) != row[key]:
            raise SpecError(f"workloads/{cell}.json has {key} "
                            f"{own.get(key)!r}, BENCHMARK.json {row[key]!r}")
    config = _load(os.path.join(base, "configs",
                                f"{checked_name(row['config'])}.json"))
    traffic = _load(os.path.join(base, "traffic",
                                 f"{checked_name(row['traffic'])}.json"))
    missing = [k for k in CONFIG_KEYS if k not in config] + \
        [k for k in TRAFFIC_KEYS if k not in traffic]
    if missing:
        raise SpecError(f"cell {cell}: keys {missing} missing")
    if traffic["entry"] not in ENTRIES:
        raise SpecError(f"traffic {row['traffic']}: entry "
                        f"{traffic['entry']!r} is not one of {ENTRIES}")
    if traffic["entry"] == "plan" and traffic["seeds_per_plan"] != 1:
        raise SpecError(f"traffic {row['traffic']}: plan takes one seed")
    return Cell(
        name=cell, chips=row["chips"], config_name=row["config"],
        config=config, traffic_name=row["traffic"], traffic=traffic,
        limits=own["limits"],
        end_to_end=[metric(m, root) for m in bench["end_to_end"]
                    if _applies(m, cell)],
        per_layer=[metric(m, root) for m in bench["per_layer"]
                   if _applies(m, cell)])
