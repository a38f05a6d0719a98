"""The torch batch-last engine (mbd_tpu_torch/sim/batched.py) against the
JAX one (mbd_tpu/sim/batched.py): the same q, qd and ctrl, made with numpy
from a seed, through one substep, one checked env step and the link
outputs, at N = 8.

The JAX side runs op by op (``jax.disable_jit``): the torch engine
evaluates the same expressions in the same order, while a jitted JAX
program lets XLA reassociate float32 (a jitted and an eager JAX walker2d
substep alone differ by 2.7e-5 in qd). Tolerance: atol 1e-5, the one of
tests/test_rollout_pallas.py:24, on every output, with one exception.

The humanoids' qd is held at 1e-4 (q stays at 1e-5). Over seeds 0 to 2 a
humanoid substep or checked env step differed by up to 5.3e-5 in qd
(humanoidrun, two substeps) and 4.4e-5 (humanoidstandup). This is neither
engine's fault. The hinge rotations take sin and cos of θ/2, where XLA's
CPU and torch differ in the last bit, and a 23-dof tree with 34 limit
rows amplifies that. With one correctly rounded sin/cos fed to both
engines, the humanoidrun substep matched exactly and humanoidstandup to
6e-6. The torch engine in float64 puts both float32 engines equally far
from the truth: 2.1e-4 (JAX) and 2.3e-4 (torch) on humanoidrun,
5.7e-5 each on humanoidstandup. ``test_humanoid_substep_exact_at_rest``
pins the operation order without those ulps: at θ = 0 every hinge's sine
and cosine is exact, and the engines agree to 1e-6 (measured: qd exactly,
q within 4.7e-10, from the free root's own sin of |ω|h/2).
"""

import jax
import numpy as np
import pytest
import torch

from mbd_tpu.envs.physics import asset_path
from mbd_tpu.sim import batched as JB
from mbd_tpu.sim.system import load_mjcf as jax_load
from mbd_tpu_torch.sim import batched as TB
from mbd_tpu_torch.sim.system import load_mjcf as torch_load

SCENES = ["hopper", "walker2d", "halfcheetah", "cartpole", "pushT", "ant",
          "humanoidrun", "humanoidstandup", "humanoidtrack"]
N = 8
ATOL = 1e-5
# qd tolerance per scene (module docstring)
QD_ATOL = {"humanoidrun": 1e-4, "humanoidstandup": 1e-4,
           "humanoidtrack": 1e-4}
N_FRAMES = 2


def _systems(scene):
    path = asset_path(f"{scene}.xml")
    return jax_load(path), torch_load(path, device="cpu")


def _inputs(sys, seed=0):
    rng = np.random.default_rng(seed)
    q = np.asarray(sys.init_q)[:, None] + rng.normal(size=(sys.nq, N)) * 0.05
    for j in range(sys.njnt):
        if sys.jnt_type[j] == 0:       # free joint: unit quaternion
            a = sys.jnt_qposadr[j]
            q[a + 3:a + 7] /= np.linalg.norm(q[a + 3:a + 7], axis=0)
    qd = rng.normal(size=(sys.nv, N)) * 0.3
    u = rng.normal(size=(sys.nu, N)) * 0.5
    return [x.astype(np.float32) for x in (q, qd, u)]


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=0, atol=atol)


@pytest.mark.parametrize("scene", SCENES)
def test_substep_matches_jax(scene):
    js, ts = _systems(scene)
    q, qd, u = _inputs(js)
    with jax.disable_jit():
        jq, jqd = JB.substep_b(js, q, qd, u)
    tq, tqd = TB.substep_b(ts, *map(torch.from_numpy, (q, qd, u)))
    _close(jq, tq)
    _close(jqd, tqd, QD_ATOL.get(scene, ATOL))


@pytest.mark.parametrize("scene", SCENES)
def test_env_step_checked_matches_jax(scene):
    js, ts = _systems(scene)
    q, qd, u = _inputs(js, seed=1)
    bad = np.zeros(N, np.float32)
    with jax.disable_jit():
        jq, jqd, jbad = JB.env_step_checked_b(js, q, qd, u, N_FRAMES, bad)
    tq, tqd, tbad = TB.env_step_checked_b(
        ts, *map(torch.from_numpy, (q, qd, u)), N_FRAMES,
        torch.from_numpy(bad))
    _close(jq, tq)
    _close(jqd, tqd, QD_ATOL.get(scene, ATOL))
    np.testing.assert_array_equal(np.asarray(jbad), tbad.numpy())


@pytest.mark.parametrize("scene", SCENES)
def test_link_out_matches_jax(scene):
    js, ts = _systems(scene)
    q, qd, _ = _inputs(js, seed=2)
    with jax.disable_jit():
        jo = JB.link_out_b(js, q, qd)
    to = TB.link_out_b(ts, torch.from_numpy(q), torch.from_numpy(qd))
    for field in ("xpos", "xquat", "vel", "ang"):
        for a, b in zip(getattr(jo, field), getattr(to, field)):
            _close(a, b)


def test_validity_flags_and_clamp():
    """A sample driven past QD_DIVERGED is flagged and clamped, its
    neighbours are not, in both engines."""
    js, ts = _systems("cartpole")
    q, qd, u = _inputs(js, seed=3)
    qd[:, 0] = 500.0
    bad = np.zeros(N, np.float32)
    with jax.disable_jit():
        _, jqd, jbad = JB.env_step_checked_b(js, q, qd, u, 1, bad)
    _, tqd, tbad = TB.env_step_checked_b(
        ts, *map(torch.from_numpy, (q, qd, u)), 1, torch.from_numpy(bad))
    assert tbad[0] == 1.0 and not bool(tbad[1:].any())
    assert float(tqd.abs().max()) <= TB.QD_DIVERGED
    np.testing.assert_array_equal(np.asarray(jbad), tbad.numpy())
    _close(jqd, tqd)


def test_humanoid_substep_exact_at_rest():
    """humanoidrun with every hinge at its init angle (θ = 0, so every sine
    and cosine is exact) and the root lifted 3 m off the floor, under
    random qd and u: the engines agree to 1e-6 in q and qd."""
    js, ts = _systems("humanoidrun")
    rng = np.random.default_rng(4)
    q = np.repeat(np.asarray(js.init_q)[:, None], N, axis=1)
    q[2] += 3.0
    qd = (rng.normal(size=(js.nv, N)) * 0.3).astype(np.float32)
    u = (rng.normal(size=(js.nu, N)) * 0.5).astype(np.float32)
    q = q.astype(np.float32)
    with jax.disable_jit():
        jq, jqd = JB.substep_b(js, q, qd, u)
    tq, tqd = TB.substep_b(ts, *map(torch.from_numpy, (q, qd, u)))
    _close(jq, tq, 1e-6)
    _close(jqd, tqd, 1e-6)
