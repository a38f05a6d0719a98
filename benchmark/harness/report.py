"""A run's result: the comparison with the reference, the work count, the
metrics from their readers, and the line the driver reads.

The line's keys: ``correct``, ``attempted`` (the window's plans),
``failed`` (plans whose final reward is not finite), ``metrics`` (the
cell's end-to-end metrics untraced, its per-layer ones traced; a reader
that finds nothing leaves its metric out), ``device`` (with
``memory_peak_bytes`` of the fullest card, and traced ``busy_s``, the
mean over the cards, and ``window_s``), traced ``breakdown``, and last
``checks``: each number compared with its limit. The same numbers are the
last lines on standard error.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from ..reference import check, models
from ..work import count
from .cell import drawn, forbidden_modules, plan_seeds
from .spec import Cell, SpecError
from .trace import TOP, named_s


class Forbidden(RuntimeError):
    """A module of JAX or of the JAX package was loaded."""


def same_bits(a, b) -> bool:
    """Two plans' results equal bit for bit (floats by their bits)."""
    for x, y in zip(a, b):
        x, y = torch.as_tensor(x), torch.as_tensor(y)
        if x.shape != y.shape or x.dtype != y.dtype:
            return False
        if x.dtype.is_floating_point:
            kind = {2: torch.int16, 4: torch.int32, 8: torch.int64}[
                x.element_size()]
            x, y = x.contiguous().view(kind), y.contiguous().view(kind)
        if not torch.equal(x.cpu(), y.cpu()):
            return False
    return True


def _work(cell: Cell, model, outcome: check.Outcome, plans: int) -> dict:
    c = cell.config
    demo = bool(c["enable_demo"])
    H, N, S = c["Hsample"], c["Nsample"], cell.seeds
    T = c["Ndiffuse"] - 1
    steps = {k: count.tally(outcome.steps[k], demo, H)
             for k in count.tallied_steps(T)}
    sys = model.sys
    pw = count.plan_work(
        c["env"], (sys.nq, sys.nv, sys.nu), model.n_frames, S, N, H, T,
        steps, count.tally(outcome.final), demo)
    return dict(needed_ops=plans * pw.ops, least_s=plans * pw.least_s)


def _breakdown(summaries: List[dict]) -> dict:
    """The device operations that took most time, summed over the ranks,
    and the longest idle gaps of any rank (named by rank when several)."""
    ops: Dict[str, float] = {}
    gaps = []
    for r, s in enumerate(summaries):
        for name, v in s["ops"].items():
            ops[name] = ops.get(name, 0.0) + v[1]
        prefix = f"rank {r}: " if len(summaries) > 1 else ""
        gaps += [[prefix + name, sec] for name, sec in s["idle_gaps"]]
    return dict(
        device_ops=[[k, v] for k, v in sorted(ops.items(),
                                              key=lambda kv: -kv[1])[:TOP]],
        idle_gaps=sorted(gaps, key=lambda g: -g[1])[:TOP])


def finish(cell: Cell, seed: int, out: dict, device,
           trace: bool) -> Tuple[dict, List[str]]:
    """(the result line, the lines of the numbers compared) of a run's
    output ``out``."""
    forbidden = sorted(set(forbidden_modules()).union(
        *[r["forbidden"] for r in out["ranks"]]))
    if forbidden:
        raise Forbidden(f"modules of JAX or the JAX package were loaded: "
                        f"{forbidden}")
    memory = max(r["memory_peak_bytes"] for r in out["ranks"])
    results = out["results"]
    plans = len(results)
    c = cell.config
    T = c["Ndiffuse"] - 1
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.empty_cache()
    # the reference's contractions in float32, as the configuration states
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    p, t = drawn(seed, plans, T)
    model = models.load(c["env"], device)
    extra = count.tallied_steps(T) if trace else ()
    outcome = check.compare(model, c, plan_seeds(cell.traffic, seed, p),
                            results[p], t, device, extra)
    numbers = dict(outcome.numbers)
    if "rank_results" in out:
        ranks = out["rank_results"]
        numbers["rank_mismatch"] = sum(
            not all(same_bits(a, b) for a, b in zip(r, ranks[0]))
            or len(r) != len(ranks[0]) for r in ranks[1:])
    missing = sorted(set(numbers) - set(cell.limits))
    if missing:
        raise SpecError(f"workloads/{cell.name}.json has no limit for "
                        f"{missing}")
    checks = {k: dict(value=v, limit=cell.limits[k])
              for k, v in numbers.items()}
    correct = all(v["value"] <= v["limit"] for v in checks.values())

    summaries = [r["summary"] for r in out["ranks"]] if trace else []
    record = dict(
        cell=cell.name, chips=cell.chips, plans=plans,
        span_s=out["span_s"], walls=out["walls"], setup_s=out["setup_s"],
        work=_work(cell, model, outcome, plans) if trace else None,
        counts={k: sum(r["counts"][k] for r in out["ranks"])
                for k in out["ranks"][0]["counts"]},
        ranks=[dict(busy_s=s["busy_s"], window_s=s["window_s"],
                    nccl_s=named_s(s["ops"], "nccl"), ops=s["ops"])
               for s in summaries])
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = m.read(record)
        if value is not None:
            metrics[m.name] = dict(value=value, unit=m.unit)
    info = dict(platform="gpu" if on_card else "cpu",
                kind=torch.cuda.get_device_name(0) if on_card else "cpu",
                count=cell.chips, memory_peak_bytes=memory)
    if trace:
        info.update(busy_s=sum(s["busy_s"] for s in summaries)
                    / len(summaries),
                    window_s=max(s["window_s"] for s in summaries))
    failed = sum(not all(math.isfinite(x) for x in
                         r.final_reward.reshape(-1).tolist())
                 for r in results)
    line = dict(correct=correct, attempted=plans, failed=failed,
                metrics=metrics, device=info)
    if trace:
        line["breakdown"] = _breakdown(summaries)
    line["checks"] = checks
    lines = [f"check {k} {v['value']!r} limit {v['limit']!r}"
             for k, v in checks.items()]
    return line, lines
