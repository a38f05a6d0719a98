"""Demo-conditioned diffusion in the port (mbd_tpu_torch/planners/mbd.py,
``enable_demo``) against the JAX planner (mbd_tpu/planners/mbd.py), on
humanoidtrack and the CPU.

The JAX side runs op by op (``jax.disable_jit``): jitting a humanoid engine
on JAX's CPU backend takes over 20 minutes, eagerly one reverse step at
Nsample 8, Hsample 2 takes 30–50 s here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mbd_tpu import envs as jax_envs
from mbd_tpu.core.schedule import make_schedule as jax_schedule
from mbd_tpu.planners import mbd as jax_mbd
from mbd_tpu_torch import envs
from mbd_tpu_torch.core.schedule import DiffusionSchedule
from mbd_tpu_torch.envs import State
from mbd_tpu_torch.planners import mbd
from mbd_tpu_torch.rollout.fused import rollout_outputs

SCHED_FIELDS = ("betas", "alphas", "alphas_bar", "sigmas", "sigmas_cond")


def test_demo_reverse_step_matches_jax():
    """One demo reverse step from the same Ȳ, noise, schedule and reset
    state: Ȳᵢ₋₁ and the mean reward to atol 1e-5.

    At temperature 1, for the reason test_torch_planner.py's reverse-step
    test gives: the demo branch divides the fused log-weights by the
    temperature twice, so at the recommended 0.1 the rollouts' float32
    differences would reach Ȳ multiplied by 100. Measured over seeds 0 to
    2 of Ȳ: at most 1.1e-6 in Ȳᵢ₋₁ and 6e-8 in the mean reward."""
    cfg = dict(Nsample=8, Hsample=2, Ndiffuse=8, temp_sample=1.0,
               enable_demo=True)
    i = cfg["Ndiffuse"] - 1
    jenv = jax_envs.get_env("humanoidtrack")
    tenv = envs.get_env("humanoidtrack", device="cpu")
    jstate = jenv.reset(jax.random.PRNGKey(0))
    jsched = jax_schedule(cfg["Ndiffuse"])
    Ybar = np.random.default_rng(1).uniform(
        -0.5, 0.5, (cfg["Hsample"], jenv.action_size)).astype(np.float32)
    rng = jax.random.PRNGKey(4)

    step = jax_mbd.make_reverse_once(jenv, jax_mbd.MBDConfig(**cfg), jstate,
                                     jsched, engine="fused")
    with jax.disable_jit():
        (_, jY), (_, jrew) = step((rng, jnp.asarray(Ybar)), i)

    _, key = jax.random.split(rng)                 # mbd.py:224-225
    eps = np.asarray(jax.random.normal(
        key, (cfg["Nsample"], cfg["Hsample"], jenv.action_size)))
    tsched = DiffusionSchedule(*(torch.tensor(np.asarray(getattr(jsched, k)))
                                 for k in SCHED_FIELDS))
    ps = tenv.pipeline_init(torch.tensor(np.asarray(jstate.pipeline_state.q)),
                            torch.tensor(np.asarray(jstate.pipeline_state.qd)))
    tstate = State(ps, tenv._obs(ps), torch.zeros(()), torch.zeros(()))
    tstep = mbd.make_reverse_once(tenv, mbd.MBDConfig(**cfg), tstate, tsched)
    tY, trew = tstep(torch.from_numpy(Ybar), i, torch.tensor(eps))
    np.testing.assert_allclose(np.asarray(jY), tY.numpy(), rtol=0, atol=1e-5)
    assert abs(float(jrew) - float(trew)) <= 1e-5


def test_zero_controls_track_below_the_smoke_gate():
    """From the reset state, 50 steps of zero controls let the humanoid
    fall (the rollout is flagged) and track the jog at −0.768: below the
    −0.70 that chip_smoke.py asks of the planned humanoidtrack, so that
    gate shows the demo steering, not the reset pose. Measured here:
    reward −2.279, log-density −0.7678 (the torch engine)."""
    env = envs.get_env("humanoidtrack", device="cpu")
    rews, bad, logpd = rollout_outputs(
        env, env.reset(torch.Generator()),
        torch.zeros((1, 50, env.action_size)), demo=True)
    assert bool(bad[0])
    assert float(rews.mean()) == pytest.approx(-2.279, abs=1e-3)
    assert float(logpd[0]) == pytest.approx(-0.7678, abs=1e-4)


def test_demo_plan_on_cpu():
    """The slice at a tiny size on the CPU, torch only: humanoidtrack with
    the demo at Nsample 8, Hsample 3, Ndiffuse 3; shapes, finite outputs
    and a clean final plan."""
    env = envs.get_env("humanoidtrack", device="cpu")
    cfg = mbd.recommended_config("humanoidtrack", mbd.MBDConfig(
        Nsample=8, Hsample=3, Ndiffuse=3, enable_demo=True))
    assert cfg.enable_demo and cfg.temp_sample == 0.1
    res = mbd.plan(env, cfg, torch.Generator().manual_seed(0))
    assert res.Ybars.shape == (2, 3, env.action_size)
    assert res.rews_trace.shape == (2,)
    assert torch.isfinite(res.Ybars).all()
    assert torch.isfinite(res.rews_trace).all()
    assert torch.isfinite(res.final_reward)
    assert res.final_diverged is False
