"""The torch rollout (mbd_tpu_torch/rollout/fused.py) against the JAX one
(mbd_tpu/rollout/fused.py), and the CUDA kernel's wrapper
(mbd_tpu_torch/ops/rollout_cuda.py) on the CPU.

Both packages start from the same reset state (JAX's) and roll out the
same controls, made with numpy from a seed, at N = 8 and H = 10.
Tolerances:

* the first env step's rewards to atol 1e-5, the one of
  tests/test_rollout_pallas.py:24 (measured at most 4.5e-7);
* the validity flags equal;
* hopper, cartpole and ant: every step's reward to atol 1e-4. XLA
  reassociates float32 inside the jitted JAX rollout, and the largest
  per-step gap over seeds 1 to 3 (ragged and per-sample cases included)
  was 4.8e-5 on hopper and 1.2e-7 on cartpole; ant's was 8.3e-7 at
  seed 1, its feet's contacts not switching within the ten steps;
* walker2d and halfcheetah: each sample's mean reward over the horizon to
  atol 5e-3, the tolerance tests/test_fused_planner.py:20-21 states for
  the same chaos. A jitted and an eager JAX walker2d substep already
  differ by 2.7e-5 in qd, and a contact that switches on a few substeps
  apart turns that into per-step reward gaps of up to 2.5e-2 on walker2d
  and 1.0e-3 on halfcheetah; the per-sample means stayed within 2.5e-3
  over seeds 1 to 3;
* pushT: every step's reward to atol 1e-4, as hopper. Each sample's
  pusher starts beside, inside or clear of the slider's bars
  (``_pusht_q0``), and 35 to 54 (sample, step) pairs of the ten steps have
  a contact in the pusher, yet the largest per-step gap over seeds 1 to 3
  was 7.4e-5 against jitted JAX and 4.8e-7 against the TPU kernel in
  interpret mode (its own test below).

The engine's arithmetic itself is held at 1e-5 per substep in
tests/test_torch_engine.py. The humanoids' rollouts are not compiled by
JAX here (an XLA-CPU compile of a humanoid engine takes over 20
minutes); their rewards are held against JAX's ``reward_qs_b`` on the same
trajectories, at 1e-6.

The kernel itself (csrc/rollout.cu) is built with ``--fmad=false``: every
multiply and add then rounds on its own, as in the plain version's
separate elementwise kernels, and the two agree bit for bit on the card
(``chip_smoke.py``, tests/test_torch_cuda.py). With contraction on,
the kernel would fuse products into FMAs that the plain version rounds
twice, and chaotic contact rollouts would drift apart from it.
"""

from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from mbd_tpu import envs as jax_envs
from mbd_tpu.ops.rollout_pallas import rollout_rewards_pallas
from mbd_tpu.rollout.fused import rollout_rewards as jax_rollout_rewards
from mbd_tpu_torch import envs
from mbd_tpu_torch.ops import rollout_cuda
from mbd_tpu_torch.rollout.fused import rollout_rewards

ATOL = 1e-5
STEP_ATOL = 1e-4
MEAN_ATOL = 5e-3
# models whose contacts switch within the horizon: held on the mean
CONTACT_CHAOS = ("walker2d", "halfcheetah")


def _state(q, qd):
    return SimpleNamespace(pipeline_state=SimpleNamespace(q=q, qd=qd))


def _pusht_q0(q, rng, N):
    """pushT's reset q per sample, with the pusher within 0.25 of the
    slider's centre in x and y: in, beside or clear of its bars."""
    q = np.repeat(q[:, None], N, axis=1)
    q[0:2] = q[2:4] + rng.uniform(-0.25, 0.25, (2, N))
    return q.astype(np.float32)


def _case(name, N, H, per_sample=False, seed=1):
    """(JAX env, port env, JAX state, port state, Y0s) from one seed."""
    jenv, tenv = jax_envs.get_env(name), envs.get_env(name, device="cpu")
    js = jenv.reset(jax.random.PRNGKey(0)).pipeline_state
    q, qd = np.asarray(js.q), np.asarray(js.qd)
    rng = np.random.default_rng(seed)
    if name == "pushT":
        q = _pusht_q0(q, rng, N)
        qd = np.repeat(qd[:, None], N, axis=1)
    elif per_sample:
        q = (q[:, None] + 0.01 * rng.normal(size=(q.shape[0], N))
             ).astype(np.float32)
        qd = np.repeat(qd[:, None], N, axis=1)
    Y0s = rng.uniform(-1, 1, (N, H, tenv.action_size)).astype(np.float32)
    return (jenv, tenv, _state(q, qd),
            _state(torch.tensor(q), torch.tensor(qd)), Y0s)


def _compare(name, N, H, per_sample=False):
    jenv, tenv, jstate, tstate, Y0s = _case(name, N, H, per_sample)
    r_j, _, bad_j = jax.jit(lambda q, qd, y: jax_rollout_rewards(
        jenv, _state(q, qd), y))(jstate.pipeline_state.q,
                                 jstate.pipeline_state.qd, Y0s)
    r_t, qs, bad_t = rollout_rewards(tenv, tstate, torch.from_numpy(Y0s))
    assert r_t.shape == (N, H) and bad_t.shape == (N,) and qs is None
    r_j, r_t = np.asarray(r_j), r_t.numpy()
    np.testing.assert_allclose(r_j[:, 0], r_t[:, 0], rtol=0, atol=ATOL)
    if name in CONTACT_CHAOS:
        np.testing.assert_allclose(r_j.mean(1), r_t.mean(1), rtol=0,
                                   atol=MEAN_ATOL)
    else:
        np.testing.assert_allclose(r_j, r_t, rtol=0, atol=STEP_ATOL)
    np.testing.assert_array_equal(np.asarray(bad_j), bad_t.numpy())


@pytest.mark.parametrize("name", ["hopper", "walker2d", "halfcheetah",
                                  "cartpole", "ant", "pushT"])
def test_rollout_rewards_match_jax(name):
    _compare(name, N=8, H=10)


def test_plain_version_matches_tpu_kernel_pusht():
    """The port's plain version against the TPU kernel itself
    (``rollout_rewards_pallas`` in interpret mode) on pushT, from per-sample
    initial states with live sphere–box contacts, at N = 8, H = 6: the
    first step to 1e-5, every step to 1e-4 (module docstring), flags
    equal."""
    jenv, tenv, jstate, tstate, Y0s = _case("pushT", N=8, H=6)
    r_j, bad_j = rollout_rewards_pallas(jenv, jstate, Y0s, b_tile=8,
                                        interpret=True)
    r_t, bad_t = rollout_cuda.rollout_rewards_cuda(tenv, tstate,
                                                   torch.from_numpy(Y0s))
    r_j, r_t = np.asarray(r_j), r_t.numpy()
    assert r_t.shape == r_j.shape == (8, 6)
    np.testing.assert_allclose(r_j[:, 0], r_t[:, 0], rtol=0, atol=ATOL)
    np.testing.assert_allclose(r_j, r_t, rtol=0, atol=STEP_ATOL)
    np.testing.assert_array_equal(np.asarray(bad_j), bad_t.numpy())


def test_rollout_rewards_ragged_batch():
    _compare("hopper", N=5, H=10)


def test_rollout_rewards_per_sample_q0():
    _compare("hopper", N=8, H=10, per_sample=True)


def test_rollout_qs_trace():
    """need_qs returns the post-step positions [H, nq, N], whose last step
    the rewards are computed from."""
    _, tenv, _, tstate, Y0s = _case("cartpole", N=4, H=3)
    rews, qs, _ = rollout_rewards(tenv, tstate, torch.from_numpy(Y0s),
                                  need_qs=True)
    assert qs.shape == (3, tenv.sys.nq, 4)
    assert torch.isfinite(qs).all()


@pytest.mark.parametrize("per_sample", [False, True])
def test_cuda_wrapper_on_cpu_is_plain_version(per_sample):
    _, tenv, _, tstate, Y0s = _case("cartpole", N=5, H=6,
                                    per_sample=per_sample)
    Y = torch.from_numpy(Y0s)
    launches = rollout_cuda.LAUNCHES
    r_k, bad_k = rollout_cuda.rollout_rewards_cuda(tenv, tstate, Y)
    r_p, _, bad_p = rollout_rewards(tenv, tstate, Y)
    assert rollout_cuda.LAUNCHES == launches      # no launch on the CPU
    assert r_k.shape == (5, 6) and bad_k.shape == (5,)
    assert torch.equal(r_k, r_p) and torch.equal(bad_k, bad_p)


def test_model_header_hopper():
    """The generated header carries hopper's sizes: 4 plane–capsule pairs
    (8 contact rows) and 3 capsule–capsule pairs (3 rows), then 3 limited
    joints (6 rows): 17 constraint rows."""
    env = envs.get_env("hopper", device="cpu")
    sizes = rollout_cuda.model_tables(env.sys, env.n_frames,
                                      env.kernel_reward)["sizes"]
    assert sizes == dict(NQ=6, NV=6, NU=3, NB=5, NJ=6, NFRAMES=20, NPAIR=7,
                         NCON=11, NLIMJ=3, NC=17, NSPRING=0, NSENSOR=1,
                         NTRACK=0, NFK=0)
    header = rollout_cuda.model_header(env)
    assert "#define NC 17" in header
    assert "constexpr int kReward = 0;" in header        # progress
    assert "constexpr float kH = 2.000000095e-03f;" in header   # f32 dt


# Constraint rows: one per plane–sphere pair, two per plane–capsule pair
# (the capsule's two end caps), then two per limited joint. ant: 1 + 12·2
# + 8·2; humanoidrun: 2 + 17·2; humanoidstandup: 3 + 6·2 + 17·2;
# humanoidtrack: 2 + (17 hinges + 5 marker slides)·2.
@pytest.mark.parametrize("name,nc", [("walker2d", 26), ("halfcheetah", 28),
                                     ("cartpole", 2), ("ant", 41),
                                     ("humanoidrun", 36),
                                     ("humanoidstandup", 49),
                                     ("humanoidtrack", 46)])
def test_model_header_sizes(name, nc):
    env = envs.get_env(name, device="cpu")
    assert f"#define NC {nc}\n" in rollout_cuda.model_header(env)


@pytest.mark.parametrize("name,ncon,reward", [
    ("ant", 25, "healthy"), ("humanoidrun", 2, "run"),
    ("humanoidstandup", 15, "standup"), ("humanoidtrack", 2, "track")])
def test_kernel_accepts_free_roots_and_plane_sphere(name, ncon, reward):
    """Free roots and plane–sphere pairs are in the kernel: the header
    carries the contact rows, the free root's height sensor, the env's
    reward branch and the lanes per sample: 16 on humanoidrun, whose plans
    run at N = 8192, 8 on the others."""
    env = envs.get_env(name, device="cpu")
    rollout_cuda.check_supported(env.sys)
    t = rollout_cuda.model_tables(env.sys, env.n_frames, env.kernel_reward)
    assert t["sizes"]["NCON"] == ncon and t["sizes"]["NSENSOR"] == 1
    assert t["ints"]["kReward"] == rollout_cuda.REWARD_IDS[reward]
    G = 16 if name == "humanoidrun" else 8
    assert f"constexpr int kG = {G};" in rollout_cuda.model_header(env)
    assert ("sensor_qadr", "int", [2]) in t["tables"]   # root z = q[2]


def test_model_header_pusht():
    """pushT in the kernel: two sphere–box pairs (the pusher, geom 1,
    against the slider's bars, geoms 2 and 3), one row each, then 6
    limited slides: 14 rows, at 8 lanes a sample; the box
    half-sizes in ``pair_box_b``, the pusher's radius in ``pair_r1``, the
    push reward."""
    env = envs.get_env("pushT", device="cpu")
    rollout_cuda.check_supported(env.sys)
    assert env.sys.contact_pairs == ((3, 1, 2), (3, 1, 3))
    t = rollout_cuda.model_tables(env.sys, env.n_frames, env.kernel_reward)
    assert t["sizes"] == dict(NQ=8, NV=8, NU=2, NB=4, NJ=8, NFRAMES=5,
                              NPAIR=2, NCON=2, NLIMJ=6, NC=14, NSPRING=0,
                              NSENSOR=0, NTRACK=0, NFK=0)
    tables = {spec[0]: spec[2] for spec in t["tables"]}
    assert tables["pair_kind"] == [t["ints"]["kSphereBox"]] * 2
    np.testing.assert_array_equal(
        np.asarray(tables["pair_box_b"], np.float32),
        np.float32([0.15, 0.05, 0.05, 0.05, 0.15, 0.05]))
    np.testing.assert_array_equal(np.asarray(tables["pair_r1"], np.float32),
                                  np.float32([0.05, 0.05]))
    assert t["ints"]["kReward"] == rollout_cuda.REWARD_IDS["push"]
    header = rollout_cuda.model_header(env)
    assert "#define NC 14\n" in header
    assert "constexpr int kG = 8;" in header
    assert "constexpr int kReward = 7;" in header


def test_humanoidtrack_header_tracks_bodies():
    """The demo's tracked bodies are in the header (torso, thighs, shins);
    the clip is not, so jog and walk share one build."""
    jog = envs.get_env("humanoidtrack", device="cpu")
    walk = envs.get_env("humanoidtrack_walk", device="cpu")
    t = rollout_cuda.model_tables(jog.sys, jog.n_frames, jog.kernel_reward,
                                  jog.track_body_ids)
    assert t["sizes"]["NTRACK"] == 5
    assert ("track_body", "int", (1, 7, 4, 8, 5)) in t["tables"]
    assert rollout_cuda.model_header(jog) == rollout_cuda.model_header(walk)
    assert "#define NTRACK 0\n" in rollout_cuda.model_header(
        envs.get_env("humanoidrun", device="cpu"))


def test_cuda_wrapper_demo_and_trace_on_cpu():
    """On the CPU the wrapper's need_qs and demo outputs are the plain
    version's: the trace, and ``traj_xref_logpd_qs`` of it."""
    env = envs.get_env("humanoidtrack", device="cpu")
    state = env.reset(torch.Generator())
    Y = torch.from_numpy(np.random.default_rng(2).uniform(
        -1, 1, (3, 2, env.action_size)).astype(np.float32))
    rews, bad, qs, logpd = rollout_cuda.rollout_rewards_cuda(
        env, state, Y, need_qs=True, demo=True)
    r_p, qs_p, bad_p = rollout_rewards(env, state, Y, need_qs=True)
    assert torch.equal(rews, r_p) and torch.equal(bad, bad_p)
    assert torch.equal(qs, qs_p) and qs.shape == (2, env.sys.nq, 3)
    assert torch.equal(logpd, env.traj_xref_logpd_qs(qs_p))
    rews2, bad2, logpd2 = rollout_cuda.rollout_rewards_cuda(
        env, state, Y, demo=True)
    assert torch.equal(logpd2, logpd)


def test_cuda_wrapper_refuses_demo_it_cannot_score():
    """demo=True raises ValueError on an env without a demo and for a
    horizon longer than the demo's 50 frames."""
    hopper = envs.get_env("hopper", device="cpu")
    with pytest.raises(ValueError, match="demo"):
        rollout_cuda.rollout_rewards_cuda(
            hopper, hopper.reset(torch.Generator()),
            torch.zeros(2, 3, hopper.action_size), demo=True)
    track = envs.get_env("humanoidtrack", device="cpu")
    with pytest.raises(ValueError, match="50 frames"):
        rollout_cuda.rollout_rewards_cuda(
            track, track.reset(torch.Generator()),
            torch.zeros(2, 51, track.action_size), demo=True)


@pytest.mark.parametrize("scene", ["ball"])
def test_kernel_refuses_free_joints_and_sphere_box(scene):
    """What the kernel does not cover is refused: a ball joint (on ant's
    root). pushT's sphere–box pair is covered (test_model_header_pusht)."""
    from mbd_tpu.envs.physics import asset_path
    from mbd_tpu_torch.sim.system import BALL, load_mjcf

    sys = load_mjcf(asset_path("ant.xml"), device="cpu")
    sys = sys.replace(jnt_type=(BALL,) + sys.jnt_type[1:])
    env = SimpleNamespace(sys=sys, n_frames=5, kernel_reward=("progress", {}))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        rollout_cuda.model_header(env)
    state = _state(sys.init_q, torch.zeros(sys.nv))
    with pytest.raises(NotImplementedError):
        rollout_cuda.rollout_rewards_cuda(env, state,
                                          torch.zeros(2, 3, sys.nu))



@pytest.mark.parametrize("name", ["ant", "humanoidrun", "humanoidstandup"])
def test_reward_qs_b_matches_jax(name):
    """Each free-root env's batch-last reward against JAX's on the same
    random trajectories (qs, qds, us, q0), at 1e-6."""
    jenv, tenv = jax_envs.get_env(name), envs.get_env(name, device="cpu")
    sys = tenv.sys
    H, N = 6, 16
    rng = np.random.default_rng(7)
    qs = (np.asarray(sys.init_q)[None, :, None]
          + rng.normal(size=(H, sys.nq, N)) * 0.5).astype(np.float32)
    qds = rng.normal(size=(H, sys.nv, N)).astype(np.float32)
    us = rng.uniform(-1, 1, (H, sys.nu, N)).astype(np.float32)
    q0 = (np.asarray(sys.init_q)[:, None]
          + rng.normal(size=(sys.nq, N)) * 0.5).astype(np.float32)
    qd0 = rng.normal(size=(sys.nv, N)).astype(np.float32)
    r_j = np.asarray(jenv.reward_qs_b(qs, qds, us, q0, qd0))
    r_t = tenv.reward_qs_b(*map(torch.from_numpy, (qs, qds, us, q0, qd0)))
    assert r_t.shape == (H, N)
    np.testing.assert_allclose(r_j, r_t.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["hopper", "walker2d", "halfcheetah",
                                  "cartpole", "ant", "humanoidrun",
                                  "humanoidstandup", "humanoidtrack",
                                  "pushT"])
def test_group_size_is_built(name):
    """Each env's header is built for its G, the one timed fastest at its
    planning shape (PERF.md, PR 5): 16 on humanoidrun, 8 on the others;
    a G the header is given overrides it."""
    env = envs.get_env(name, device="cpu")
    G = 16 if name == "humanoidrun" else 8
    assert env.kernel_group == G
    assert f"constexpr int kG = {G};" in rollout_cuda.model_header(env)
    other = 32 // G
    assert f"constexpr int kG = {other};" in rollout_cuda.model_header(
        env, other)
