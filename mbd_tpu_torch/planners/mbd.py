"""Model-Based Diffusion trajectory optimizer (port of
``mbd_tpu/planners/mbd.py``: ``plan`` and its reverse step).

Per reverse step i, from Ndiffuse−1 down to 1:

    Yi   = Ȳᵢ·√ᾱᵢ
    Y0s  = clip(Ȳᵢ + σᵢ·ε, −1, 1),  ε ~ N(0, 1) of shape [Nsample, H, nu]
    rews = mean per-step reward of each rollout (the CUDA kernel on the
           card, the torch engine on the CPU), standardized → logp₀
    [demo] logp₀ = max(logp₀, logp_demo), standardized again and divided
           by the temperature a second time (below)
    w    = softmax(logp₀);  Ȳ = Σₙ wₙ·Y0sₙ
    score = (−Yi + √ᾱᵢ·Ȳ)/(1 − ᾱᵢ)
    Ȳᵢ₋₁ = (Yi + (1 − ᾱᵢ)·score)/√αᵢ/√ᾱᵢ₋₁

Samples flagged by the engine's validity envelope (or with a non-finite
reward) are demoted to the worst valid reward for the statistics and get
zero weight; when every sample is flagged the weights fall back to uniform.

Demo conditioning (``enable_demo``, reference mbd_planner.py:117-125, and
``docs/DEMO_CONDITIONING.md``): each rollout's demo-tracking log-density,
shifted so that the best sample's is 0, plus ``env.rew_xref``, is
standardized with the reward's mean and std into logp_demo. The fused
log-weights are standardized again and divided by the temperature a second
time: the reference's behaviour, kept as it is.

Every tensor lives on ``env.device`` and the loop never waits on the
device until the final evaluation. Random numbers come from an explicit
``torch.Generator``: ``env.reset`` draws the initial state from it, then
each step draws its noise. The ``eps`` argument replaces that noise
stream with given tensors (the tests feed JAX's stream through it).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from ..core.schedule import DiffusionSchedule, make_schedule
from ..ops.rollout_cuda import check_demo, rollout_rewards_cuda


@dataclass
class MBDConfig:
    Nsample: int = 2048          # number of control-sequence samples
    Hsample: int = 50            # planning horizon
    Ndiffuse: int = 100          # diffusion steps
    temp_sample: float = 0.1     # softmax temperature
    beta0: float = 1e-4
    betaT: float = 1e-2
    enable_demo: bool = False    # demo-conditioned diffusion


# Per-env recommended overrides (mbd_tpu/planners/mbd.py:54-61).
TEMP_RECOMMEND = {
    "ant": 0.1, "halfcheetah": 0.4, "hopper": 0.1, "humanoidstandup": 0.1,
    "humanoidrun": 0.1, "walker2d": 0.1, "pushT": 0.2,
}
NDIFFUSE_RECOMMEND = {"pushT": 200, "humanoidrun": 300}
NSAMPLE_RECOMMEND = {"humanoidrun": 8192}
HSAMPLE_RECOMMEND = {"pushT": 40}


def recommended_config(env_name: str,
                       base: Optional[MBDConfig] = None) -> MBDConfig:
    cfg = base or MBDConfig()
    return MBDConfig(
        Nsample=NSAMPLE_RECOMMEND.get(env_name, cfg.Nsample),
        Hsample=HSAMPLE_RECOMMEND.get(env_name, cfg.Hsample),
        Ndiffuse=NDIFFUSE_RECOMMEND.get(env_name, cfg.Ndiffuse),
        temp_sample=TEMP_RECOMMEND.get(env_name, cfg.temp_sample),
        beta0=cfg.beta0, betaT=cfg.betaT, enable_demo=cfg.enable_demo,
    )


@dataclass
class MBDResult:
    Ybars: torch.Tensor          # (Ndiffuse-1, Hsample, nu) denoised means
    rews_trace: torch.Tensor     # (Ndiffuse-1,) mean batch reward per step
    final_reward: torch.Tensor   # mean reward of rolling out Ybars[-1]
    # True when the returned plan's own rollout is flagged by the validity
    # envelope and no clean iterate existed to fall back to: final_reward
    # is then not an earned number
    final_diverged: bool = False


def make_reverse_once(env, cfg: MBDConfig, state_init,
                      sched: DiffusionSchedule) -> Callable:
    """The reverse step as ``reverse_once(Ybar_i, i, eps) → (Ybar_{i−1},
    mean reward)``, with ``eps`` [Nsample, Hsample, nu] the step's noise."""
    if cfg.enable_demo:
        check_demo(env, cfg.Hsample)
    # the barycenter is a float32 contraction: keep it out of TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def reverse_once(Ybar_i: torch.Tensor, i: int, eps: torch.Tensor):
        abar = sched.alphas_bar[i]
        Yi = Ybar_i * torch.sqrt(abar)
        Y0s = torch.clamp(eps * sched.sigmas[i] + Ybar_i, -1.0, 1.0)

        if cfg.enable_demo:
            rewss, bad, xref_logpds = rollout_rewards_cuda(
                env, state_init, Y0s, demo=True)
        else:
            rewss, bad = rollout_rewards_cuda(env, state_init, Y0s)
        logp0, valid, rew_mean, rew_std = standardized_rewards(
            rewss, bad, cfg.temp_sample)

        if cfg.enable_demo:
            # the max over every sample, flagged ones included
            xref_logpds = xref_logpds - xref_logpds.max()
            logpdemo = (xref_logpds + env.rew_xref - rew_mean) / rew_std \
                / cfg.temp_sample
            logp0 = torch.where(logpdemo > logp0, logpdemo, logp0)
            lstd = logp0.std(correction=0)
            lstd = torch.where(lstd < 1e-4, torch.ones_like(lstd), lstd)
            logp0 = (logp0 - logp0.mean()) / lstd / cfg.temp_sample

        weights = masked_softmax(logp0, valid)
        Ybar = torch.einsum("n,nij->ij", weights, Y0s)

        score = (-Yi + torch.sqrt(abar) * Ybar) / (1.0 - abar)
        Yim1 = (Yi + (1.0 - abar) * score) / torch.sqrt(sched.alphas[i])
        return Yim1 / torch.sqrt(sched.alphas_bar[i - 1]), rew_mean

    return reverse_once


def standardized_rewards(rewss: torch.Tensor, bad: torch.Tensor,
                         temp: float):
    """Each rollout's mean per-step reward (rewss [N, H]), standardized and
    divided by ``temp``: (logp₀ [N], valid [N], mean, std). Flagged or
    non-finite rollouts (not ``valid``) take the worst valid reward for
    the statistics; a std under 1e-4 counts as 1."""
    rews = rewss.mean(dim=-1)
    valid = torch.isfinite(rews) & (bad == 0)
    inf = torch.full_like(rews, float("inf"))
    worst = torch.min(torch.where(valid, rews, inf))
    worst = torch.where(torch.isfinite(worst), worst, torch.zeros_like(worst))
    rews = torch.where(valid, rews, worst)
    rew_mean = rews.mean()
    rew_std = rews.std(correction=0)
    rew_std = torch.where(rew_std < 1e-4, torch.ones_like(rew_std), rew_std)
    return (rews - rew_mean) / rew_std / temp, valid, rew_mean, rew_std


def masked_softmax(logp0: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Softmax weights with zero weight for the samples not ``valid``;
    uniform weights when none is."""
    logp0 = torch.where(valid, logp0, torch.full_like(logp0, -float("inf")))
    weights = torch.softmax(logp0, dim=0)
    return torch.where(valid.any(), weights,
                       torch.full_like(weights, 1.0 / logp0.shape[0]))


def plan(env, cfg: MBDConfig, generator: torch.Generator, state_init=None,
         chunk_size: int = 0, progress_fn=None,
         eps: Optional[torch.Tensor] = None) -> MBDResult:
    """Run the full reverse diffusion on ``env.device``.

    ``generator`` draws the reset state (unless ``state_init`` is given)
    and then every step's noise. ``progress_fn(step, mean_reward)`` is
    called after every ``chunk_size`` steps and after the last one.
    ``eps`` [Ndiffuse−1, Nsample, Hsample, nu] replaces the drawn noise,
    step by step in the order the steps run.
    """
    device = env.device
    if state_init is None:
        state_init = env.reset(generator)
    sched = make_schedule(cfg.Ndiffuse, cfg.beta0, cfg.betaT, device=device)
    reverse_once = make_reverse_once(env, cfg, state_init, sched)
    nu = env.action_size
    shape = (cfg.Nsample, cfg.Hsample, nu)
    if eps is not None and tuple(eps.shape) != (cfg.Ndiffuse - 1,) + shape:
        raise ValueError(f"eps must be [{cfg.Ndiffuse - 1}, "
                         f"{cfg.Nsample}, {cfg.Hsample}, {nu}]")

    Ybar = torch.zeros((cfg.Hsample, nu), device=device)
    Ybars, rews_trace = [], []
    steps = range(cfg.Ndiffuse - 1, 0, -1)
    for t, i in enumerate(steps):
        e = eps[t] if eps is not None else torch.randn(
            shape, generator=generator, device=device)
        Ybar, rew = reverse_once(Ybar, i, e)
        Ybars.append(Ybar)
        rews_trace.append(rew)
        done = t + 1
        if progress_fn is not None and chunk_size > 0 and (
                done % chunk_size == 0 or done == len(steps)):
            progress_fn(done, float(rew))
    Ybars = torch.stack(Ybars)
    rews_trace = torch.stack(rews_trace)
    final_reward, final_diverged = evaluate_final(env, state_init, Ybars)
    return MBDResult(Ybars=Ybars, rews_trace=rews_trace,
                     final_reward=final_reward,
                     final_diverged=final_diverged)


def evaluate_final(env, state_init, plans: torch.Tensor):
    """The final plan ``plans[-1]``'s mean reward through the same rollout,
    and whether it is flagged. When its own rollout is flagged, the best
    clean iterate of ``plans`` [T, H, nu] takes its place (in place) and
    its reward is returned; with no clean iterate, the flagged reward and
    True. The first wait on the device of a plan."""
    final_rews, final_bad = rollout_rewards_cuda(env, state_init, plans[-1:])
    final_reward = final_rews[0].mean()
    if not bool(final_bad[0]):
        return final_reward, False
    cand_rews, cand_bad = rollout_rewards_cuda(env, state_init, plans)
    cand = cand_rews.mean(dim=-1)
    cand = torch.where((cand_bad == 0) & torch.isfinite(cand), cand,
                       torch.full_like(cand, -float("inf")))
    best = int(torch.argmax(cand))
    if not bool(torch.isfinite(cand[best])):
        return final_reward, True
    plans[-1] = plans[best]
    return cand[best], False
