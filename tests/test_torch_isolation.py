"""The port stands alone: importing every module of ``mbd_tpu_torch`` and
``chip_smoke.py`` and ``seed_quality.py``, and the work table the smoke's
bounds read (``benchmark/work/count.py``), loads neither JAX, flax nor
optax, nor anything of the reference package ``mbd_tpu`` (the card's
machine has no JAX)."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r"""
import importlib, pkgutil, sys
import mbd_tpu_torch
names = [m.name for m in pkgutil.walk_packages(mbd_tpu_torch.__path__,
                                               "mbd_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke, seed_quality
import benchmark.work.count
bad = sorted(m for m in sys.modules
             if m in ("jax", "flax", "optax")
             or m.startswith(("jax.", "jaxlib", "flax.", "optax."))
             or m == "mbd_tpu" or m.startswith("mbd_tpu."))
print(len(names), " ".join(names))
print("LOADED", " ".join(bad))
"""


def test_port_imports_neither_jax_nor_the_reference():
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT,
                         capture_output=True, text=True, check=True).stdout
    listed, loaded = out.splitlines()[-2:]
    for module in ("mbd_tpu_torch.cli.run_mbd", "mbd_tpu_torch.viz.html",
                   "mbd_tpu_torch.rollout.replay",
                   "mbd_tpu_torch.planners.mbd", "mbd_tpu_torch.envs.car2d",
                   "mbd_tpu_torch.cli.vis_diffusion",
                   "mbd_tpu_torch.blackbox.bbo", "mbd_tpu_torch.rl.networks",
                   "mbd_tpu_torch.rl.wrappers", "mbd_tpu_torch.rl.batched_env",
                   "mbd_tpu_torch.rl.ppo", "mbd_tpu_torch.rl.sac",
                   "mbd_tpu_torch.rl.train", "mbd_tpu_torch.parallel",
                   "mbd_tpu_torch.parallel.mesh",
                   "mbd_tpu_torch.parallel.multichip",
                   "mbd_tpu_torch.blackbox.mnist",
                   "mbd_tpu_torch.utils.profiling",
                   "mbd_tpu_torch.utils.launcher",
                   "mbd_tpu_torch.cli.vis_explainer",
                   "mbd_tpu_torch.notebooks.demo_1d"):
        assert module in listed.split()
    assert loaded.split() == ["LOADED"], loaded
