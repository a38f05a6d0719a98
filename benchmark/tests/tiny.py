"""A cell of ``BENCHMARK.json`` cut to a size the CPU tests can run: a few
samples, steps, seeds and ranks; the rest of the cell as it is."""

from __future__ import annotations

from benchmark.harness import spec

SEED = 2 ** 31 + 12345          # larger than 32 signed bits hold


def tiny_cell(name: str, Nsample: int = 8, Hsample: int = 3,
              Ndiffuse: int = 5, seeds: int = 2, ranks: int = 2):
    cell = spec.load(name)
    cell.chips = min(cell.chips, ranks)
    cell.config = dict(cell.config, Nsample=Nsample, Hsample=Hsample,
                       Ndiffuse=Ndiffuse)
    t = cell.traffic
    cell.traffic = dict(t, seeds_per_plan=min(t["seeds_per_plan"], seeds),
                        warmup_diffuse_steps=3)
    return cell


def output(cell, seconds: float = 0.01, prepare=None) -> dict:
    """One run of ``cell`` on the CPU (gloo ranks for a mesh), up to the
    comparison: what ``report.finish`` takes."""
    from benchmark.harness import cell as run_cell

    started = run_cell.Started()
    if cell.chips > 1:
        return run_cell.run_mesh(cell, SEED, seconds, False, started,
                                 backend="gloo", device="cpu",
                                 prepare=prepare)
    return run_cell.run_single(cell, SEED, seconds, False, "cpu", started)


def run(cell, seconds: float = 0.01, prepare=None) -> dict:
    """One run of ``cell`` on the CPU: the result line."""
    from benchmark.harness import report

    return report.finish(cell, SEED, output(cell, seconds, prepare), "cpu",
                         False)[0]
