"""The port's bench (``mbd_tpu_torch/bench.py``) on the CPU: its cells are
the JAX package's configs, its env-step count is the JAX bench's, its
busy share is the union of the card's intervals, the last step's samples
it rebuilds for the parity are the plan's own, and its CPU rehearsal
prints one line with every device field null; without a card, or with an
unknown cell, it is an error line and exit 1. The fixed work count
(``utils/work.py``) is held by ``tests/test_torch_work.py``."""

import ast
import dataclasses
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

from mbd_tpu.planners import mbd as jax_mbd
from mbd_tpu_torch import bench, envs
from mbd_tpu_torch.ops import rollout_cuda
from mbd_tpu_torch.planners import mbd
from mbd_tpu_torch.rollout.rollout import rollout_us
from mbd_tpu_torch.utils import profiling
from mbd_tpu_torch.utils.work import WORK

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("Nsample", "Hsample", "Ndiffuse", "temp_sample", "beta0", "betaT",
          "enable_demo")


def _jax_bench_configs():
    """``north_cfg`` and ``flag_cfg`` of the root bench.py's ``main``, read
    from its source (importing it would start JAX's TPU set-up)."""
    with open(os.path.join(ROOT, "bench.py")) as f:
        tree = ast.parse(f.read())
    out = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                getattr(node.targets[0], "id", None) in ("north_cfg",
                                                         "flag_cfg"):
            out[node.targets[0].id] = {k.arg: ast.literal_eval(k.value)
                                       for k in node.value.keywords}
    return out


def _jax_config(name):
    cell = bench.CELLS[name]
    if name in ("humanoidrun_n1024", "humanoidrun"):
        key = "north_cfg" if name == "humanoidrun_n1024" else "flag_cfg"
        return jax_mbd.MBDConfig(**_jax_bench_configs()[key])
    return jax_mbd.recommended_config(cell.env, jax_mbd.MBDConfig(
        enable_demo=cell.cfg.enable_demo))


@pytest.mark.parametrize("name", list(bench.CELLS))
def test_cell_config_is_the_reference_config(name):
    """bench.py:262-263 for the humanoidrun cells (its north star at 1024
    and its flagship at 8192), the JAX package's ``recommended_config`` for
    the others; 8 seeds for hopper_seeds8 only."""
    ref = _jax_config(name)
    cfg = bench.CELLS[name].cfg
    assert {k: getattr(cfg, k) for k in FIELDS} == \
        {k: getattr(ref, k) for k in FIELDS}
    assert bench.CELLS[name].seeds == (8 if name == "hopper_seeds8" else 1)


def test_env_steps_is_the_jax_bench_count():
    """bench.py:88-95: n = Ndiffuse − 1 steps, n·Nsample·H env steps; the
    port's count is that, times the seeds."""
    with open(os.path.join(ROOT, "bench.py")) as f:
        src = f.read()
    assert "steps = jnp.arange(cfg.Ndiffuse - 1, 0, -1)" in src
    assert "n_env_steps = n * cfg.Nsample * cfg.Hsample" in src
    for name, cell in bench.CELLS.items():
        cfg = cell.cfg
        n = cfg.Ndiffuse - 1
        assert bench.env_steps(cfg, cell.seeds) == \
            n * cfg.Nsample * cfg.Hsample * cell.seeds, name
    assert bench.env_steps(bench.CELLS["humanoidrun"].cfg) == 122_470_400


def test_busy_share_is_the_union_of_intervals():
    """Overlapping, nested, touching and disjoint intervals, unsorted."""
    spans = [(20.0, 25.0), (0.0, 10.0), (5.0, 15.0), (24.0, 30.0),
             (40.0, 41.0), (40.2, 40.7), (41.0, 42.0)]
    assert profiling.busy_us(spans) == 15.0 + 10.0 + 2.0
    assert profiling.busy_us(iter(spans)) == 27.0
    assert profiling.busy_us([]) == 0.0

    def event(name, lo, hi):
        return SimpleNamespace(name=name, time_range=SimpleNamespace(
            start=lo, end=hi, elapsed_us=lambda: hi - lo))

    totals = profiling.kernel_totals([
        event("void rollout_kernel<8>(float*)", 0.0, 3.0),
        event("elementwise", 1.0, 2.0),
        event("void rollout_kernel<8>(float*)", 4.0, 8.0)])
    assert profiling.named(totals, "rollout_kernel") == (2, 7.0)
    assert profiling.named(totals, "nosuch") == (0, 0)


@pytest.mark.parametrize("name", ["car2d", "cartpole"])
def test_last_step_samples_are_the_plans(name):
    """The samples the parity rebuilds are the plan's last step's: their
    mean reward, as the planner forms it, is the plan's last trace entry,
    bit for bit (car2d's reset draws nothing, cartpole's draws first)."""
    env = envs.get_env(name, device="cpu")
    cfg = mbd.MBDConfig(Nsample=8, Hsample=4, Ndiffuse=4,
                        enable_demo=name == "car2d")
    res = mbd.plan(env, cfg, torch.Generator().manual_seed(3))
    samples = bench.last_step_samples(env, cfg, 3, res.Ybars)
    assert samples.shape == (8, 4, env.action_size)
    state = env.reset(torch.Generator().manual_seed(3))
    out = mbd.rollout_batch(env, mbd.batch_states(env, [state], 8), samples)
    rew_mean = mbd.standardized_rewards(out[0], out[1], cfg.temp_sample)[2]
    assert torch.equal(rew_mean, res.rews_trace[-1])


def test_last_step_is_the_plan_batch_launch():
    """``last_step`` of a 2-seed ``plan_batch``: each seed's samples of
    the last step from its own reset state, its final plan in place of
    its sample 0; with sample 0 put back, each seed's mean reward is the
    plan's last trace entry, bit for bit."""
    env = envs.get_env("cartpole", device="cpu")
    cfg = mbd.MBDConfig(Nsample=8, Hsample=4, Ndiffuse=4)
    gens = [torch.Generator().manual_seed(5 + s) for s in range(2)]
    res = mbd.plan_batch(env, cfg, gens)
    state0, Y0s = bench.last_step(env, cfg, 5, res.Ybars)
    assert Y0s.shape == (16, 4, env.action_size)
    Y0s = Y0s.reshape(2, 8, 4, -1)
    for s in range(2):
        assert torch.equal(Y0s[s, 0], res.Ybars[s, -1])
        Y0s[s, 0] = bench.last_step_samples(env, cfg, 5 + s,
                                            res.Ybars[s])[0]
    out = mbd.rollout_batch(env, state0, Y0s.reshape(16, 4, -1))
    for s in range(2):
        rew_mean = mbd.standardized_rewards(
            out[0][8 * s:8 * s + 8], out[1][8 * s:8 * s + 8],
            cfg.temp_sample)[2]
        assert torch.equal(rew_mean, res.rews_trace[s, -1])


def test_cpu_rehearsal_prints_one_line():
    """hopper and car2d + demo at Nsample 8, H 4, Ndiffuse 3 on the CPU:
    one parseable line, the cuts in ``reduced``, every device field null,
    no launch, and the counts: hopper's sample-steps (2 steps of 8 samples
    and the final selection's 2, each over 4 steps), the plain engine's
    work on them and, less, what they need at the rows that acted in the
    last step; car2d's work from the plan's structure."""
    argv = [sys.executable, "-m", "mbd_tpu_torch.bench", "--device", "cpu",
            "--cell", "hopper", "--cell", "car2d_demo", "--Nsample", "8",
            "--Hsample", "4", "--Ndiffuse", "3", "--repeat", "1"]
    proc = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["correct"] is True
    assert line["device"]["platform"] == "cpu"
    assert list(line["cells"]) == ["hopper", "car2d_demo"]
    for name, cell in line["cells"].items():
        repeat = 9 if name == "car2d_demo" else 3
        assert cell["reduced"] == [
            "Nsample 8 (published 2048)", "Hsample 4 (published 50)",
            "Ndiffuse 3 (published 100)", f"repeat 1 (default {repeat})"]
        assert set(bench.FIELDS) <= set(cell), name
        assert set(bench.LAYER_FIELDS) <= set(cell["per_layer"]), name
        for k in bench.DEVICE_FIELDS:
            assert cell[k] is None, (name, k)
        for k in bench.DEVICE_LAYER:
            assert cell["per_layer"][k] is None, (name, k)
        assert cell["per_layer"]["launches"] == 0
        assert cell["env_steps"] == 2 * 8 * 4
        assert cell["parity"] is None and cell["correct"] is True
        assert cell["checks"]["launches_as_planned"] is True
        assert cell["checks"]["quality"] is None
    hopper = line["cells"]["hopper"]
    assert hopper["per_layer"]["sample_steps"] == (2 * 8 + 2) * 4
    plain = WORK["hopper", False] * (2 * 8 + 2) * 4
    assert hopper["plain_engine_ops"] == plain
    assert hopper["rows_acting"]["shape"] == "8x4"
    assert 0.0 < hopper["rows_acting"]["contacts"] < 1.0
    assert 0.0 < hopper["work_ops"] < plain
    car2d = line["cells"]["car2d_demo"]
    assert car2d["per_layer"]["sample_steps"] == 0
    assert car2d["rows_acting"] is None
    assert car2d["work_ops"] == car2d["plain_engine_ops"] == \
        WORK["car2d", True] * 2 * 8 * 4 + WORK["car2d", False] * 4
    assert isinstance(car2d["final_logpd"], float)


def test_no_card_is_an_error(capsys, monkeypatch):
    """Without a card and without ``--device cpu``: one error line and
    exit 1, before any plan."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    launches = rollout_cuda.SAMPLE_STEPS
    assert bench.main(["--cell", "hopper"]) == 1
    line = json.loads(capsys.readouterr().out.strip())
    assert "no CUDA card" in line["error"]
    assert rollout_cuda.SAMPLE_STEPS == launches


@pytest.mark.parametrize("argv", [["--cell", "nosuch"],
                                  ["--cell", "hopper", "--cell", "nosuch"],
                                  ["--cell", "hopper", "--repeat", "0"]])
def test_bad_arguments_are_an_error(capsys, argv):
    assert bench.main(argv + ["--device", "cpu"]) == 1
    line = json.loads(capsys.readouterr().out.strip())
    assert line["error"]


def test_final_logpd_of_car2d_is_its_eval():
    """A demo cell's final log-density: car2d's ``eval_xref_logpd`` of
    the final plan's states from its reset."""
    env = envs.get_env("car2d", device="cpu")
    plan = 0.3 * torch.ones((5, 2))
    got = bench.final_logpd(env, 0, plan)
    _, xs = rollout_us(env, env.reset(None), plan)
    assert got == float(env.eval_xref_logpd(xs))


def test_cuts_are_listed():
    cell = bench.CELLS["hopper"]
    args = SimpleNamespace(Nsample=None, Hsample=50, Ndiffuse=12,
                           repeat=None)
    cfg, reduced = bench.cell_config(cell, args)
    assert cfg == dataclasses.replace(cell.cfg, Ndiffuse=12)
    assert reduced == ["Ndiffuse 12 (published 100)"]
    car2d = bench.CELLS["car2d_demo"]
    args = SimpleNamespace(Nsample=None, Hsample=None, Ndiffuse=None,
                           repeat=3)
    assert bench.cell_config(car2d, args) == (car2d.cfg,
                                              ["repeat 3 (default 9)"])
