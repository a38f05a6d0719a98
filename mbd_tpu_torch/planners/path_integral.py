"""Zeroth-order path-integral baselines: MPPI, CMA-ES, CEM (port of
``mbd_tpu/planners/path_integral.py``: the configs, the update rules and
the serial ``plan``).

Nrefine − 1 refine steps, each from the running mean μ (0 at first) and
step size σ (1 at first, adapted by CMA-ES only):

    Y0s  = clip(σ·ε + μ, −1, 1),  ε ~ N(0, 1) of shape [Nsample, H, nu]
    rews = mean per-step reward of each rollout (the CUDA kernel on the
           card, the torch engine on the CPU), standardized → logp₀
    w    = softmax(logp₀ / temperature), then the update rule:

  * mppi   — μ = Σₙ wₙ·Y0sₙ
  * cma-es — the same μ, and σ ← mean(√(Σₙ wₙ·(Y0sₙ − μ_old)²))·σ,
             floored at 1e-3
  * cem    — μ = the mean of the ``cem_elite`` clean samples of largest
             weight

Flagged or non-finite rollouts are demoted to the worst valid reward for
the statistics and get zero weight (uniform weights when none is valid),
as in ``planners/mbd.py``; the final plan is evaluated with the same
best-clean-iterate fallback. σ stays a tensor on the device and the loop
never waits on the device until the final evaluation. ``eps`` replaces the
drawn noise (the tests feed JAX's stream through it).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from ..ops.rollout_cuda import rollout_rewards_cuda
from .mbd import (HSAMPLE_RECOMMEND, NSAMPLE_RECOMMEND, TEMP_RECOMMEND,
                  evaluate_final, masked_softmax, standardized_rewards)

NREFINE_RECOMMEND = {"pushT": 200, "humanoidrun": 300}


@dataclass
class PathIntegralConfig:
    update_method: str = "mppi"   # mppi | cma-es | cem
    Nsample: int = 2048
    Hsample: int = 50
    Nrefine: int = 100
    temp_sample: float = 0.1
    cem_elite: int = 10


def recommended_config(env_name: str,
                       base: Optional[PathIntegralConfig] = None
                       ) -> PathIntegralConfig:
    cfg = base or PathIntegralConfig()
    return PathIntegralConfig(
        update_method=cfg.update_method,
        Nsample=NSAMPLE_RECOMMEND.get(env_name, cfg.Nsample),
        Hsample=HSAMPLE_RECOMMEND.get(env_name, cfg.Hsample),
        Nrefine=NREFINE_RECOMMEND.get(env_name, cfg.Nrefine),
        temp_sample=TEMP_RECOMMEND.get(env_name, cfg.temp_sample),
        cem_elite=cfg.cem_elite,
    )


def softmax_update(weights, Y0s, sigma, mu_0t, cfg, valid):
    return torch.einsum("n,nij->ij", weights, Y0s), sigma


def cma_es_update(weights, Y0s, sigma, mu_0t, cfg, valid):
    # flagged samples carry zero weight, so they move neither the mean nor
    # the step size
    mu = torch.einsum("n,nij->ij", weights, Y0s)
    err = Y0s - mu_0t
    sigma = torch.sqrt(torch.einsum("n,nij->ij", weights, err * err)
                       ).mean() * sigma
    return mu, torch.clamp_min(sigma, 1e-3)


def cem_update(weights, Y0s, sigma, mu_0t, cfg, valid):
    # The elite set by weight (softmax is monotone in the reward), flagged
    # samples ranked below every clean one and left out of the mean. A
    # stable descending sort puts the lowest index first among equal
    # weights, as jax.lax.top_k does: underflowed weights are often
    # exactly 0, and torch.topk leaves the order of ties open on CUDA.
    ranked = torch.where(valid, weights, torch.full_like(weights, -1.0))
    idx = torch.sort(ranked, descending=True, stable=True)[1][:cfg.cem_elite]
    elite = Y0s[idx]
    sel_ok = (ranked[idx] >= 0.0).to(Y0s.dtype)
    n_ok = sel_ok.sum()
    mu_clean = torch.einsum("k,kij->ij", sel_ok, elite) / torch.clamp_min(
        n_ok, 1.0)
    # no clean sample at all: the plain elite mean (finite)
    return torch.where(n_ok > 0, mu_clean, elite.mean(dim=0)), sigma


UPDATE_FNS = {"mppi": softmax_update, "cma-es": cma_es_update,
              "cem": cem_update}


@dataclass
class PathIntegralResult:
    mu_0ts: torch.Tensor         # (Nrefine-1, Hsample, nu) refined means
    rews_trace: torch.Tensor     # (Nrefine-1,) mean batch reward per step
    final_reward: torch.Tensor   # mean reward of rolling out mu_0ts[-1]
    # True when the returned plan's own rollout is flagged and no clean
    # iterate existed to fall back to (cf. mbd.MBDResult)
    final_diverged: bool = False


def make_refine_step(env, cfg: PathIntegralConfig, state_init) -> Callable:
    """The refine step as ``refine_step(mu, sigma, eps) → (mu', sigma',
    mean reward)``, with ``eps`` [Nsample, Hsample, nu] standard-normal
    draws taken before σ (CMA-ES scales them by its own σ)."""
    update_fn = UPDATE_FNS[cfg.update_method]
    # the weighted sums are float32 contractions: keep them out of TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def refine_step(mu: torch.Tensor, sigma: torch.Tensor,
                    eps: torch.Tensor):
        Y0s = torch.clamp(eps * sigma + mu, -1.0, 1.0)
        rewss, bad = rollout_rewards_cuda(env, state_init, Y0s)
        logp0, valid, rew_mean, _ = standardized_rewards(rewss, bad,
                                                         cfg.temp_sample)
        weights = masked_softmax(logp0, valid)
        mu, sigma = update_fn(weights, Y0s, sigma, mu, cfg, valid)
        return mu, sigma, rew_mean

    return refine_step


def plan(env, cfg: PathIntegralConfig, generator: torch.Generator,
         state_init=None, eps: Optional[torch.Tensor] = None
         ) -> PathIntegralResult:
    """Refine on ``env.device``. ``generator`` draws the reset state
    (unless ``state_init`` is given) and then every step's noise; ``eps``
    [Nrefine−1, Nsample, Hsample, nu] replaces the drawn noise, step by
    step."""
    device = env.device
    if cfg.update_method not in UPDATE_FNS:
        raise ValueError(f"update_method {cfg.update_method!r} is not one "
                         f"of {sorted(UPDATE_FNS)}")
    if state_init is None:
        state_init = env.reset(generator)
    refine_step = make_refine_step(env, cfg, state_init)
    nu = env.action_size
    shape = (cfg.Nsample, cfg.Hsample, nu)
    T = cfg.Nrefine - 1
    if eps is not None and tuple(eps.shape) != (T,) + shape:
        raise ValueError(f"eps must be [{T}, {cfg.Nsample}, {cfg.Hsample}, "
                         f"{nu}]")

    mu = torch.zeros((cfg.Hsample, nu), device=device)
    sigma = torch.ones((), device=device)
    mu_0ts, rews_trace = [], []
    for t in range(T):
        e = eps[t] if eps is not None else torch.randn(
            shape, generator=generator, device=device)
        mu, sigma, rew = refine_step(mu, sigma, e)
        mu_0ts.append(mu)
        rews_trace.append(rew)
    mu_0ts = torch.stack(mu_0ts)
    final_reward, final_diverged = evaluate_final(env, state_init, mu_0ts)
    return PathIntegralResult(mu_0ts=mu_0ts,
                              rews_trace=torch.stack(rews_trace),
                              final_reward=final_reward,
                              final_diverged=final_diverged)
