"""Replay of the reference's committed 8-seed plans through the port
(``mbd_tpu_torch/rollout/replay.py``), on the CPU.

``results/<env>/seed_harness.npz`` holds JAX's 8 final plans and their
rewards. The port rolls them out with the plain torch engine from JAX's
own reset states (``mbd_tpu_torch/assets/seed_resets.npz``) and compares
each seed's mean reward with the file's, at a tolerance per env (below).
The humanoids are replayed only on the card (``chip_smoke.py``): no
humanoid engine compiles on JAX-CPU, and the plain engine takes minutes
for one humanoid horizon here.

    PYTHONPATH=. python tests/test_torch_replay.py            # the fixture
    PYTHONPATH=. python tests/test_torch_replay.py --measure  # the drifts
"""

import os
import sys

import jax
import numpy as np
import pytest

from mbd_tpu import envs as jax_envs
from mbd_tpu_torch import envs
from mbd_tpu_torch.rollout import replay

CHEAP = ("hopper", "walker2d", "halfcheetah", "cartpole", "pushT", "ant")


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
    for env_name in sorted(set(replay.HARNESS.values())):
        arrays[f"{env_name}/q"], arrays[f"{env_name}/qd"] = \
            jax_resets(env_name)
    np.savez(replay.RESETS, **arrays)
    print(f"wrote {replay.RESETS}")


@pytest.mark.parametrize("env_name", sorted(set(replay.HARNESS.values())))
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


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    if "--measure" in sys.argv:
        measure()
    else:
        write_fixture()
