"""Replay of the reference's committed 8-seed plans through the port
(``mbd_tpu_torch/rollout/replay.py``), on the CPU.

``results/<env>/seed_harness.npz`` holds JAX's 8 final plans and their
rewards. The port rolls them out with the plain torch engine from JAX's
own reset states (``mbd_tpu_torch/assets/seed_resets.npz``) and compares
each seed's mean reward with the file's, at a tolerance per env (below).
The humanoids are replayed only on the card (``chip_smoke.py``): no
humanoid engine compiles on JAX-CPU, and the plain engine takes minutes
for one humanoid horizon here. What is held here of humanoidrun's two
envelope-edge seeds (``replay.EDGE``) is the substep their card replay
first flags, from the state before it, against one eager JAX substep.
car2d, an analytic env, replays from its fixed start.

    PYTHONPATH=. python tests/test_torch_replay.py            # the fixture
    PYTHONPATH=. python tests/test_torch_replay.py --measure  # the drifts
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from mbd_tpu import envs as jax_envs
from mbd_tpu_torch import envs
from mbd_tpu_torch.rollout import replay

CHEAP = ("hopper", "walker2d", "halfcheetah", "cartpole", "pushT", "ant",
         "car2d")
# the envs whose resets are drawn, and stored in the fixture
DRAWN = sorted(set(replay.HARNESS.values()) - {"car2d"})


def jax_resets(env_name):
    """JAX's reset states of seeds 0–7, the chain the harness planned
    from: split(PRNGKey(s))[1] → env.reset (tools/crosssim.py:233-235)."""
    env = jax_envs.get_env(env_name)
    qs, qds = [], []
    for s in range(8):
        _, rng_reset = jax.random.split(jax.random.PRNGKey(s))
        ps = env.reset(rng_reset).pipeline_state
        qs.append(np.asarray(ps.q))
        qds.append(np.asarray(ps.qd))
    return np.stack(qs), np.stack(qds)


def write_fixture():
    arrays = {}
    for env_name in DRAWN:
        arrays[f"{env_name}/q"], arrays[f"{env_name}/qd"] = \
            jax_resets(env_name)
    np.savez(replay.RESETS, **arrays)
    print(f"wrote {replay.RESETS}")


@pytest.mark.parametrize("env_name", DRAWN)
def test_reset_fixture_matches_jax(env_name):
    """The stored resets are JAX's, bit for bit."""
    q, qd = jax_resets(env_name)
    with np.load(replay.RESETS) as d:
        np.testing.assert_array_equal(d[f"{env_name}/q"], q)
        np.testing.assert_array_equal(d[f"{env_name}/qd"], qd)


@pytest.mark.parametrize("directory", CHEAP)
def test_replay_of_committed_plans(directory):
    """The plain engine replays the 8 committed plans from JAX's resets:
    each seed's flag as committed, and its mean reward within the env's
    tolerance (``replay.REPLAY_ATOL``, JAX's own drift from the TPU to the
    CPU) of the committed one. The seeds logged as faults in ROADMAP.md
    Queue 3 (``replay.FAULTS``) must still miss it: a fix shows here, and
    then their entries go."""
    env = envs.get_env(replay.HARNESS[directory], device="cpu")
    (rews, bad), ref = replay.replay(env, directory)
    assert replay.misses(directory, rews, bad, ref) == replay.faults(
        directory, "cpu"), ((rews - ref["rewards"]).tolist(), bad.tolist())


def test_op_trace_pairs_ops_and_finds_the_first_difference():
    """``torch_op_trace``'s comparison (hopper seed 0's CPU-against-card
    diagnosis): logs whose names part where one torch makes extra copies
    are paired again, and the first op with equal inputs and other
    outputs is found, not the ops downstream of it."""
    import torch_op_trace as T

    a = [("aten.mul", ["x"], ["y"]), ("aten.cos", ["y"], ["c"]),
         ("aten.add", ["c"], ["d"]), ("aten.sin", ["d"], ["e"]),
         ("aten.sub", ["e"], ["f"]), ("aten.neg", ["f"], ["g"])]
    b = [("aten._to_copy", ["x"], ["x"]), ("aten.mul", ["x"], ["y"]),
         ("aten.cos", ["y"], ["c'"]), ("aten.add", ["c'"], ["d'"]),
         ("aten.sin", ["d'"], ["e'"]), ("aten.sub", ["e'"], ["f'"]),
         ("aten.neg", ["f'"], ["g'"])]
    assert T.align(a, b) == [(i, i + 1) for i in range(6)]
    assert T.first_difference(a, b) == ((1, 2), 5, (0, 1))


def jax_replay(directory, perturbations=0):
    """The committed plans through JAX's fused engine on this CPU, from
    the resets and, after them, from ``perturbations`` copies of the
    resets with every q moved by one ulp up or down: [1 + perturbations,
    8] mean rewards. Their distance from the committed rewards is the
    drift of the platform alone."""
    from types import SimpleNamespace

    import jax.numpy as jnp

    from mbd_tpu.rollout.fused import rollout_rewards

    env = jax_envs.get_env(replay.HARNESS[directory])
    if directory == "car2d":
        # analytic: JAX's vmap engine from the fixed start
        import functools

        from mbd_tpu.rollout import rollout_us

        plans = np.tile(replay.harness(directory)["plans"],
                        (1 + perturbations, 1, 1))
        rews, _ = jax.jit(jax.vmap(functools.partial(rollout_us, env.step),
                                   in_axes=(None, 0)))(
            env.reset(jax.random.PRNGKey(0)), jnp.asarray(plans))
        return np.asarray(rews).mean(axis=-1).reshape(1 + perturbations, 8)
    q, qd = jax_resets(replay.HARNESS[directory])
    shim = SimpleNamespace(pipeline_state=SimpleNamespace(
        q=jnp.asarray(replay.perturbed(q, perturbations).T),
        qd=jnp.asarray(np.tile(qd, (1 + perturbations, 1)).T)))
    plans = np.tile(replay.harness(directory)["plans"],
                    (1 + perturbations, 1, 1))
    rews, _, _ = jax.jit(lambda y: rollout_rewards(
        env, shim, y, need_states=False))(jnp.asarray(plans))
    return np.asarray(rews).mean(axis=-1).reshape(1 + perturbations, 8)


def measure():
    """Per env: the platform's drift, max |JAX-CPU replay − committed|
    over a batch of the 8 plans and a batch of 72 (the 8 from their
    resets and from 8 one-ulp perturbations of them; XLA rounds the two
    batch sizes differently); and the port's plain engine's per-seed
    gaps, with the seconds each took."""
    import time

    for directory in CHEAP:
        ref = replay.harness(directory)["rewards"]
        drift = max(np.abs(jax_replay(directory) - ref).max(),
                    np.abs(jax_replay(directory, 8) - ref).max())
        t0 = time.perf_counter()
        (port, bad), _ = replay.replay(
            envs.get_env(replay.HARNESS[directory], device="cpu"), directory)
        print(f"{directory}: platform drift {drift:.4g}; port − committed "
              f"{np.round(port - ref, 7).tolist()}, flags {bad.tolist()} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)


def test_edge_accepts_only_the_logged_flags():
    """``replay.edge`` accepts a flag where the committed plan is clean
    only on a logged envelope-edge seed and device, and only while its
    reward stays within the tolerance."""
    ref = replay.harness("humanoidrun")
    rews = ref["rewards"].copy()
    bad = np.ones(8, bool)
    tol = replay.tolerance("humanoidrun")
    assert replay.edge("humanoidrun", "cuda", rews, bad, ref) == {
        1: replay.EDGE["humanoidrun", 1]["cuda"],
        7: replay.EDGE["humanoidrun", 7]["cuda"]}
    assert set(replay.edge("humanoidrun", "cpu", rews, bad, ref)) == {1}
    rews[7] += 2 * tol
    assert set(replay.edge("humanoidrun", "cuda", rews, bad, ref)) == {1}
    assert replay.edge("humanoidrun", "cuda", rews, ~bad, ref) == {}
    assert replay.edge("hopper", "cpu", replay.harness("hopper")["rewards"],
                       bad, replay.harness("hopper")) == {}


def edge_substeps(seed):
    """One substep of each package from the state before the card's first
    flagged substep of humanoidrun seed ``seed`` (``replay.EDGE_STATES``):
    (the port's qd, eager JAX's qd) [nv, 1]."""
    from mbd_tpu.envs.physics import asset_path
    from mbd_tpu.sim import batched as JB
    from mbd_tpu.sim.system import load_mjcf as jax_load
    from mbd_tpu_torch.sim import batched as TB

    with np.load(replay.EDGE_STATES) as d:
        q, qd, u = (d[f"{seed}/{k}"][:, None] for k in ("q", "qd", "u"))
    tsys = envs.get_env("humanoidrun", device="cpu").sys
    _, tqd = TB.substep_b(tsys, *map(torch.from_numpy, (q, qd, u)))
    with jax.disable_jit():
        _, jqd = JB.substep_b(jax_load(asset_path("humanoidrun.xml")),
                              q, qd, u)
    return tqd.numpy(), np.asarray(jqd)


@pytest.mark.parametrize("seed", sorted(s for d, s in replay.EDGE
                                         if d == "humanoidrun"))
def test_envelope_edge_seed_flags_in_both_packages(seed):
    """humanoidrun's envelope-edge seeds (``replay.EDGE``): from the state
    before the substep the card's replay first flags
    (``replay.EDGE_STATES``, written by ``python -m
    mbd_tpu_torch.rollout.replay --first_flag humanoidrun:1,7 --out``),
    one substep of the port's engine and one eager substep of JAX's both
    trip |qd| > 100, by the card's margin (6.17 and 5.68) within 0.2: the
    reference's own engine flags the state the plan reaches, so the flag
    is not a port difference. The two packages' qd agree to atol 2e-3:
    measured 0 (seed 1) and 9.6e-4 (seed 7), at |qd| ≈ 106, where both
    float32 engines stand 0.30 and 3e-3 from the port's engine in float64
    (the known 1e-4 of tests/test_torch_engine.py is at |qd| ≈ 0.3). The
    margin's 0.2: the card's substep and this CPU's differ by 0.152 on
    seed 1 (sin, cos and sqrt round otherwise), as far as the float32
    engines are from float64 there."""
    from mbd_tpu_torch.sim.batched import QD_DIVERGED

    tqd, jqd = edge_substeps(seed)
    margin = replay.EDGE["humanoidrun", seed]["cuda"]
    for out in (tqd, jqd):
        assert abs(np.abs(out).max() - QD_DIVERGED - margin) <= 0.2
    np.testing.assert_allclose(tqd, jqd, rtol=0, atol=2e-3)


class rounded_math:
    """torch's sqrt, sin and cos taken in double and rounded once, inside
    the ``with``."""
    NAMES = ("sqrt", "sin", "cos")

    def __enter__(self):
        self.saved = {n: getattr(torch, n) for n in self.NAMES}
        for n, fn in self.saved.items():
            setattr(torch, n, lambda x, fn=fn: fn(x.double()).float())

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(torch, n, fn)


def hopper_seed0(eager=False):
    """The diagnosis of hopper seed 0's CPU miss (``replay.FAULTS``):
    (1) each of the 50 env steps from the port's own state through JAX's
    jitted ``env_step_checked_b`` and the port's, one-step max |Δq| and
    |Δqd|; (2) the 20 substeps of the env step with the largest gap, each
    from the port's state, through one eager JAX substep: max |Δqd|;
    (3) the mean reward from 32 one-ulp perturbations of the reset
    (``replay.perturbed``) in JAX's fused engine, in the port's, and in the
    port's with correctly rounded sqrt, sin and cos, how many land more
    than 0.02 below the committed reward, and the env step at which the
    port's part into those two branches; (4) the port's engine in
    float64; with ``eager``, (5) the whole plan through eager JAX (about
    25 minutes)."""
    from types import SimpleNamespace

    import jax.numpy as jnp

    from mbd_tpu.rollout.fused import rollout_rewards
    from mbd_tpu.sim import batched as JB
    from mbd_tpu_torch.ops.rollout_cuda import rollout_rewards_cuda
    from mbd_tpu_torch.sim import batched as TB
    from mbd_tpu_torch.sim.system import NUMERIC_FIELDS

    jenv = jax_envs.get_env("hopper")
    tenv = envs.get_env("hopper", device="cpu")
    ref = replay.harness("hopper")
    committed = ref["rewards"][0]
    q0, qd0 = (a[:1] for a in jax_resets("hopper"))
    U = ref["plans"][0][:, :, None]
    step = jax.jit(lambda q, qd, u, bad: JB.env_step_checked_b(
        jenv.sys, q, qd, u, jenv.n_frames, bad))
    q, qd, bad = torch.tensor(q0.T), torch.tensor(qd0.T), torch.zeros(1)
    states, worst = [], (0.0, 0)
    for t in range(U.shape[0]):
        states.append((q, qd))
        jq, jqd, _ = step(q.numpy(), qd.numpy(), U[t], bad.numpy())
        q, qd, bad = TB.env_step_checked_b(tenv.sys, q, qd,
                                           torch.tensor(U[t]),
                                           tenv.n_frames, bad)
        dq = float(np.abs(np.asarray(jq) - q.numpy()).max())
        dqd = float(np.abs(np.asarray(jqd) - qd.numpy()).max())
        worst = max(worst, (dqd, t))
        print(f"env step {t}: one-step |dq| {dq:.3g}, |dqd| {dqd:.3g}")
    t = worst[1]
    q, qd = states[t]
    gaps = []
    for _ in range(tenv.n_frames):
        with jax.disable_jit():
            _, jqd = JB.substep_b(jenv.sys, q.numpy(), qd.numpy(), U[t])
        q, qd = TB.substep_b(tenv.sys, q, qd, torch.tensor(U[t]))
        gaps.append(float(np.abs(np.asarray(jqd) - qd.numpy()).max()))
        qd = torch.clamp(qd, -TB.QD_DIVERGED, TB.QD_DIVERGED)
    print(f"env step {t}, substeps from the port's state against eager "
          f"JAX: max |dqd| {max(gaps):.3g} ({[f'{g:.2g}' for g in gaps]})")
    copies = 32
    qp, qdp = replay.perturbed(q0, copies), np.tile(qd0, (1 + copies, 1))
    plans = np.tile(ref["plans"][:1], (1 + copies, 1, 1))
    shim = SimpleNamespace(pipeline_state=SimpleNamespace(
        q=jnp.asarray(qp.T), qd=jnp.asarray(qdp.T)))
    jr = np.asarray(jax.jit(lambda y: rollout_rewards(
        jenv, shim, y, need_states=False))(jnp.asarray(plans))[0]).mean(-1)
    tst = SimpleNamespace(pipeline_state=SimpleNamespace(
        q=torch.tensor(qp.T.copy()), qd=torch.tensor(qdp.T.copy())))
    rews, _, qs = rollout_rewards_cuda(tenv, tst, torch.tensor(plans),
                                       need_qs=True)
    tr = rews.mean(-1).numpy()
    with rounded_math():
        tr_rounded = rollout_rewards_cuda(tenv, tst, torch.tensor(plans))[
            0].mean(-1).numpy()
    for name, r in (("JAX", jr), ("port", tr),
                    ("port, sqrt/sin/cos rounded from double", tr_rounded)):
        g = r - committed
        print(f"{name}: reset {g[0]:+.6f} from the committed reward; "
              f"{copies} one-ulp copies {g[1:].min():+.6f} … "
              f"{g[1:].max():+.6f}, {int((g[1:] < -0.02).sum())} below "
              "−0.02")
    # the env step at which the port's copies part into the two branches:
    # the first whose gap between the branches' mean q passes 5× the
    # spread inside the upper branch
    low = tr - committed < -0.02
    qs = qs.numpy()
    for t in range(U.shape[0]):
        up, lo = qs[t][:, ~low], qs[t][:, low]
        gap = np.abs(up.mean(1) - lo.mean(1)).max()
        inside = np.abs(up - up[:, :1]).max()
        if lo.size and gap > 5 * inside:
            print(f"the branches part at env step {t}: |Δq| between "
                  f"them {gap:.3g}, inside the upper one {inside:.3g}")
            break
    s64 = tenv.sys.replace(**{k: getattr(tenv.sys, k).double()
                              for k in NUMERIC_FIELDS})
    q, qd = torch.tensor(q0.T).double(), torch.tensor(qd0.T).double()
    bad, qs, qds = torch.zeros(1).double(), [], []
    for t in range(U.shape[0]):
        q, qd, bad = TB.env_step_checked_b(
            s64, q, qd, torch.tensor(U[t]).double(), tenv.n_frames, bad)
        qs.append(q)
        qds.append(qd)
    r64 = tenv.reward_qs_b(torch.stack(qs), torch.stack(qds), None,
                           None, None)
    print(f"port in float64: {float(r64.mean()):.6f} (committed "
          f"{committed:.6f})")
    if eager:
        q, qd, bad = q0.T, qd0.T, np.zeros(1, np.float32)
        jqs = []
        with jax.disable_jit():
            for t in range(U.shape[0]):
                q, qd, bad = JB.env_step_checked_b(jenv.sys, q, qd, U[t],
                                                   jenv.n_frames, bad)
                jqs.append(np.asarray(q))
        r = tenv.reward_qs_b(torch.tensor(np.stack(jqs)), None, None, None,
                             None)
        print(f"eager JAX: {float(r.mean()):.6f}")


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    if "--hopper_seed0" in sys.argv:
        hopper_seed0(eager="--eager" in sys.argv)
    elif "--edge" in sys.argv:
        for seed in sorted(s for d, s in replay.EDGE if d == "humanoidrun"):
            tqd, jqd = edge_substeps(seed)
            print(f"humanoidrun seed {seed}: max |qd| after the substep, "
                  f"port {np.abs(tqd).max():.5f}, eager JAX "
                  f"{np.abs(jqd).max():.5f}, max |Δqd| "
                  f"{np.abs(tqd - jqd).max():.3g}")
    elif "--measure" in sys.argv:
        measure()
    else:
        write_fixture()
