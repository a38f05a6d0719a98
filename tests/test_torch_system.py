"""The port's model loader (mbd_tpu_torch/sim/system.py) against the JAX one
(mbd_tpu/sim/system.py): every field bit for bit, for every MJCF under
mbd_tpu/assets/, loaded from the XML and carried across from the JAX
System's fields; and the compiled snapshots the port's envs load."""

import glob
import os

import jax
import numpy as np
import pytest

from mbd_tpu.envs.physics import ASSET_DIR
from mbd_tpu.sim.system import load_mjcf as jax_load
from mbd_tpu_torch import envs
from mbd_tpu_torch.envs import physics
from mbd_tpu_torch.sim.system import (NUMERIC_FIELDS, STATIC_FIELDS,
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
    _assert_same(jax_load(path), load_mjcf(path))


@pytest.mark.parametrize("name", XMLS)
def test_system_from_numpy_matches_jax(name):
    jsys = jax_load(os.path.join(ASSET_DIR, f"{name}.xml"))
    fields = {k: getattr(jsys, k) for k in STATIC_FIELDS}
    fields.update({k: np.asarray(jax.device_get(getattr(jsys, k)))
                   for k in NUMERIC_FIELDS})
    _assert_same(jsys, system_from_numpy(fields))


@pytest.mark.parametrize("name", physics.MODELS)
def test_snapshot_matches_jax(name):
    """The committed snapshots are MuJoCo's current compile of the XMLs."""
    _assert_same(jax_load(os.path.join(ASSET_DIR, f"{name}.xml")),
                 physics.load(name, "cpu"))


def test_get_env_refuses_unported():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        envs.get_env("pushT")


@pytest.mark.parametrize("name,n_frames,dt", [
    ("hopper", 20, 0.002), ("walker2d", 20, 0.002),
    ("halfcheetah", 5, 0.01), ("cartpole", 4, 0.005), ("ant", 5, 0.01),
    ("humanoidrun", 7, 0.006), ("humanoidstandup", 7, 0.006)])
def test_env_sizes_match_jax(name, n_frames, dt):
    from mbd_tpu import envs as jax_envs

    jenv, tenv = jax_envs.get_env(name), envs.get_env(name)
    assert tenv.n_frames == jenv.n_frames == n_frames
    assert tenv.action_size == jenv.action_size
    assert tenv.dt == jenv.dt == pytest.approx(n_frames * dt)
