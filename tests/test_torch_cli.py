"""The port's CLI (``python -m mbd_tpu_torch.cli.run_mbd``) on the CPU at
tiny sizes: every mode for MBD and the baselines, its artifacts, and that
it writes nowhere but under ``--results_dir``. Every run writes under
pytest's ``tmp_path``."""

import hashlib
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from mbd_tpu_torch import envs
from mbd_tpu_torch.cli import run_mbd
from mbd_tpu_torch.rollout.rollout import rollout_states
from mbd_tpu_torch.viz import html

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# cartpole: 4 substeps a step, the cheapest model to plan on the CPU
TINY = ["--env_name", "cartpole", "--device", "cpu", "--Nsample", "4",
        "--Hsample", "3", "--Ndiffuse", "3", "--disable_recommended_params",
        "--n_seeds", "2"]


def _data(page):
    """The viewer's embedded data of a rollout.html."""
    return json.loads(re.search(r"const DATA = (.*);\n", page).group(1))


@pytest.mark.parametrize("algo", ["mbd", "path_integral"])
def test_single_writes_plans_and_viewer(tmp_path, algo):
    """``single`` writes mu_0ts.npy [Ndiffuse − 1, H, nu] and a
    rollout.html of H frames with the model's geoms: the page of the final
    plan rolled out from the seed's reset, byte for byte."""
    rew = run_mbd.main(TINY + ["--algo", algo, "--update_method", "cem",
                               "--results_dir", str(tmp_path)])
    out = tmp_path / "cartpole"
    mu = np.load(out / "mu_0ts.npy")
    assert mu.shape == (2, 3, 1) and np.isfinite(mu).all()
    assert np.isfinite(rew)
    page = (out / "rollout.html").read_text()
    data = _data(page)
    env = envs.get_env("cartpole", device="cpu")
    assert len(data["frames"]) == 3
    assert len(data["system"]["geoms"]) == len(html._system_dict(
        env.sys)["geoms"]) > 0
    state = env.reset(torch.Generator().manual_seed(0))
    states = rollout_states(env, state, torch.from_numpy(mu[-1]))
    assert page == html.render_states(env.sys, states, dt=env.dt,
                                      title=f"cartpole ({algo})")


@pytest.mark.parametrize("algo", ["mbd", "path_integral"])
def test_seed_batched_equals_serial(tmp_path, algo):
    """``seed`` with --batch_seeds plans the seeds in one batch, each to
    its serial reward (atol 1e-5); neither writes artifacts."""
    argv = TINY + ["--mode", "seed", "--algo", algo,
                   "--results_dir", str(tmp_path)]
    serial = run_mbd.main(argv)
    batch = run_mbd.main(argv + ["--batch_seeds"])
    np.testing.assert_allclose(batch["rewards"], serial["rewards"], rtol=0,
                               atol=1e-5)
    assert batch["diverged"] == [False, False]
    assert not any(tmp_path.iterdir())


def _digest(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.mark.parametrize("algo", ["mbd", "path_integral"])
def test_temp_writes_under_results_dir_only(tmp_path, monkeypatch, algo):
    """``temp`` with the default --results_dir, from a scratch directory:
    the six temperatures land in ./results/RESULTS_TEMP.json there, merged
    by env, and the reference's docs/RESULTS_TEMP.json is untouched."""
    published = os.path.join(ROOT, "docs", "RESULTS_TEMP.json")
    before = _digest(published)
    monkeypatch.chdir(tmp_path)
    out = run_mbd.main(TINY + ["--mode", "temp", "--algo", algo,
                               "--results_dir", "results"])
    assert out == os.path.join("results", "RESULTS_TEMP.json")
    table = json.loads((tmp_path / out).read_text())["cartpole"]
    assert list(table["sweep"]) == [str(t) for t in run_mbd.TEMPS]
    assert table["n_seeds"] == 2 and table["backend"] == "cpu"
    for row in table["sweep"].values():
        assert len(row["rewards"]) == 2 and np.isfinite(row["rew_mean"])
    assert _digest(published) == before


def test_device_cuda_needs_a_card(tmp_path):
    """--device cuda (the default) never falls back to the CPU."""
    argv = TINY[:2] + ["--results_dir", str(tmp_path)]
    if torch.cuda.is_available():
        assert run_mbd.build_parser().parse_args(argv).device == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        run_mbd.main(argv)


def test_car2d_is_not_ported_yet(tmp_path):
    """car2d is ported now: the CLI plans it (the picture it draws is
    tests/test_torch_car2d.py's), and a name no env has raises
    ValueError."""
    rew = run_mbd.main(["--env_name", "car2d", "--device", "cpu",
                        "--Nsample", "8", "--Hsample", "4", "--Ndiffuse",
                        "3", "--disable_recommended_params", "--not_render",
                        "--results_dir", str(tmp_path)])
    assert rew == 0.0
    with pytest.raises(ValueError, match="Unknown environment"):
        run_mbd.main(["--env_name", "no_such_env", "--device", "cpu",
                      "--results_dir", str(tmp_path)])


def test_help_names_one_engine_per_device():
    out = subprocess.run([sys.executable, "-m", "mbd_tpu_torch.cli.run_mbd",
                          "--help"], cwd=ROOT, capture_output=True,
                         text=True, check=True).stdout
    assert "--device" in out and "--engine" not in out
    assert "no other engine" in out
