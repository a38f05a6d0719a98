"""The port's model loader (mbd_tpu_torch/sim/system.py) against the JAX one
(mbd_tpu/sim/system.py): every field bit for bit, for every MJCF under
mbd_tpu/assets/, loaded from the XML and carried across from the JAX
System's fields; and the compiled snapshots the port's envs load."""

import glob
import os

import jax
import numpy as np
import pytest
import torch

from mbd_tpu.envs.physics import ASSET_DIR
from mbd_tpu.sim.system import load_mjcf as jax_load
from mbd_tpu_torch import envs
from mbd_tpu_torch.envs import physics
from mbd_tpu_torch.sim.system import (NUMERIC_FIELDS, SLIDE, STATIC_FIELDS,
                                      load_mjcf, system_from_numpy)

XMLS = sorted(os.path.basename(p)[:-4]
              for p in glob.glob(os.path.join(ASSET_DIR, "*.xml")))


def _assert_same(jsys, tsys):
    for k in STATIC_FIELDS:
        assert getattr(jsys, k) == getattr(tsys, k), k
    for k in NUMERIC_FIELDS:
        a, b = np.asarray(getattr(jsys, k)), getattr(tsys, k).numpy()
        assert a.dtype == b.dtype == np.float32, k
        assert a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def test_every_asset_is_covered():
    assert len(XMLS) == 9


@pytest.mark.parametrize("name", XMLS)
def test_loader_matches_jax(name):
    path = os.path.join(ASSET_DIR, f"{name}.xml")
    _assert_same(jax_load(path), load_mjcf(path, device="cpu"))


@pytest.mark.parametrize("name", XMLS)
def test_system_from_numpy_matches_jax(name):
    jsys = jax_load(os.path.join(ASSET_DIR, f"{name}.xml"))
    fields = {k: getattr(jsys, k) for k in STATIC_FIELDS}
    fields.update({k: np.asarray(jax.device_get(getattr(jsys, k)))
                   for k in NUMERIC_FIELDS})
    _assert_same(jsys, system_from_numpy(fields, device="cpu"))


@pytest.mark.parametrize("name", physics.MODELS)
def test_snapshot_matches_jax(name):
    """The committed snapshots are MuJoCo's current compile of the XMLs."""
    _assert_same(jax_load(os.path.join(ASSET_DIR, f"{name}.xml")),
                 physics.load(name, "cpu"))


def test_get_env_refuses_unported():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        envs.get_env("car2d")


def test_get_env_defaults_to_the_card():
    """With no device named, an env builds on ``cuda``: here, without a
    card, it raises instead of building on the CPU."""
    if torch.cuda.is_available():
        assert envs.get_env("cartpole").device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        envs.get_env("cartpole")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        physics.load("hopper")


def test_model_loaders_default_to_the_card():
    """The loaders and the schedule, too, build on ``cuda`` when no device
    is named: here, without a card, each raises."""
    from mbd_tpu_torch.core.schedule import make_schedule
    from mbd_tpu_torch.sim.system import load_npz

    xml = os.path.join(ASSET_DIR, "hopper.xml")
    devices = [lambda: load_mjcf(xml).device,
               lambda: load_npz(physics.snapshot_path("hopper")).device,
               lambda: make_schedule(10).alphas.device]
    for device in devices:
        if torch.cuda.is_available():
            assert device().type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                device()


def test_humanoidtrack_model_is_a_forest():
    """nq/nv/nu 29/28/17 over 19 bodies: the humanoid's free root and the
    five ``*_ref`` marker bodies, each on its own slide along x, are all
    children of the world."""
    sys = envs.get_env("humanoidtrack", device="cpu").sys
    assert (sys.nq, sys.nv, sys.nu, sys.nbody) == (29, 28, 17, 19)
    roots = [b for b in range(1, sys.nbody) if sys.body_parentid[b] == 0]
    assert [sys.link_names[b - 1] for b in roots] == [
        "torso", "torso_ref", "left_thigh_ref", "right_thigh_ref",
        "left_shin_ref", "right_shin_ref"]
    for b in roots[1:]:
        (j,) = [j for j in range(sys.njnt) if sys.jnt_bodyid[j] == b]
        assert sys.jnt_type[j] == SLIDE
        assert sys.jnt_axis[j].tolist() == [1.0, 0.0, 0.0]


@pytest.mark.parametrize("name,n_frames,dt", [
    ("hopper", 20, 0.002), ("walker2d", 20, 0.002),
    ("halfcheetah", 5, 0.01), ("cartpole", 4, 0.005), ("ant", 5, 0.01),
    ("humanoidrun", 7, 0.006), ("humanoidstandup", 7, 0.006),
    ("humanoidtrack", 5, 0.006), ("pushT", 5, 0.01)])
def test_env_sizes_match_jax(name, n_frames, dt):
    from mbd_tpu import envs as jax_envs

    jenv, tenv = jax_envs.get_env(name), envs.get_env(name, device="cpu")
    assert tenv.n_frames == jenv.n_frames == n_frames
    assert tenv.action_size == jenv.action_size
    assert tenv.dt == jenv.dt == pytest.approx(n_frames * dt)
