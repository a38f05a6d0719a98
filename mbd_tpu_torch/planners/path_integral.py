"""Zeroth-order path-integral baselines: MPPI, CMA-ES, CEM (port of
``mbd_tpu/planners/path_integral.py``: the configs, the update rules,
``plan`` and the seed-batched ``plan_batch``).

Nrefine − 1 refine steps, each from the running mean μ (0 at first) and
step size σ (1 at first, adapted by CMA-ES only):

    Y0s  = clip(σ·ε + μ, −1, 1),  ε ~ N(0, 1) of shape [Nsample, H, nu]
    rews = mean per-step reward of each rollout (the CUDA kernel on the
           card, the torch engine on the CPU; an analytic env's own step),
           standardized → logp₀
    w    = softmax(logp₀ / temperature), then the update rule:

  * mppi   — μ = Σₙ wₙ·Y0sₙ
  * cma-es — the same μ, and σ ← mean(√(Σₙ wₙ·(Y0sₙ − μ_old)²))·σ,
             floored at 1e-3
  * cem    — μ = the mean of the ``cem_elite`` clean samples of largest
             weight

Flagged or non-finite rollouts are demoted to the worst valid reward for
the statistics and get zero weight (uniform weights when none is valid),
as in ``planners/mbd.py``; the final plan is evaluated as there: with the
best-clean-iterate fallback on a physics env, the last iterate on an
analytic one (car2d), whose rollouts step the whole batch at once
(``mbd.rollout_batch``). σ stays a tensor on the device and the loop
never waits on the device until the final evaluation. ``eps`` replaces the
drawn noise (the tests feed JAX's stream through it). ``mesh`` shards the
samples over ranks as ``mbd.plan`` does, with the same result.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Union

import torch

from .mbd import (HSAMPLE_RECOMMEND, NSAMPLE_RECOMMEND, TEMP_RECOMMEND,
                  draw_eps, evaluate_final, masked_softmax, per_seed,
                  shard_samples, sharded_rollout, standardized_rewards)

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
    """One refinement's result; from ``plan_batch`` every field has a
    leading seed axis S, and ``final_diverged`` is a [S] bool tensor."""
    mu_0ts: torch.Tensor         # (Nrefine-1, Hsample, nu) refined means
    rews_trace: torch.Tensor     # (Nrefine-1,) mean batch reward per step
    final_reward: torch.Tensor   # mean reward of rolling out mu_0ts[-1]
    # True when the returned plan's own rollout is flagged and no clean
    # iterate existed to fall back to (cf. mbd.MBDResult)
    final_diverged: Union[bool, torch.Tensor] = False


def make_refine_step_batch(env, cfg: PathIntegralConfig,
                           states_init, mesh=None) -> Callable:
    """The refine step of S = len(states_init) independent refinements as
    ``refine_step(mu, sigma, eps) → (mu', sigma', mean reward)``, with μ
    [S, H, nu], σ and the mean reward [S] and eps [S, Nsample, H, nu]
    standard-normal draws taken before σ (CMA-ES scales them by its own
    σ): one rollout of the S·N samples, each from its own seed's reset
    state, and each seed's statistics and update its own
    (``mbd.per_seed``), as JAX's jax.vmap(update_fn) makes them
    (mbd_tpu/planners/path_integral.py:167-168). With ``mesh``, this rank
    rolls out its shard of the S·N samples (``mbd.sharded_rollout``)."""
    update_fn = UPDATE_FNS[cfg.update_method]
    # the weighted sums are float32 contractions: keep them out of TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    state0, lo, hi = shard_samples(env, states_init, cfg.Nsample, mesh)

    def update(rewss, bad, Y0s, mu, sigma):
        """One seed's update from its rewards [N, H], flags [N] and
        samples [N, H, nu]: (μ', σ', mean reward)."""
        logp0, valid, rew_mean, _ = standardized_rewards(rewss, bad,
                                                         cfg.temp_sample)
        mu, sigma = update_fn(masked_softmax(logp0, valid), Y0s, sigma, mu,
                              cfg, valid)
        return mu, sigma, rew_mean

    def refine_step(mu: torch.Tensor, sigma: torch.Tensor,
                    eps: torch.Tensor):
        Y0s = torch.clamp(eps * sigma[:, None, None, None] + mu[:, None],
                          -1.0, 1.0)
        S, N = Y0s.shape[:2]
        rewss, bad = sharded_rollout(
            env, state0, Y0s.reshape((S * N,) + Y0s.shape[2:]), lo, hi, mesh)
        return per_seed(update, rewss.reshape(S, N, -1), bad.reshape(S, N),
                        Y0s, mu, sigma)

    return refine_step


def make_refine_step(env, cfg: PathIntegralConfig, state_init) -> Callable:
    """One seed's refine step, ``refine_step(mu, sigma, eps) → (mu',
    sigma', mean reward)`` with μ [H, nu], σ a scalar and eps [Nsample, H,
    nu]: ``make_refine_step_batch`` at S = 1."""
    step = make_refine_step_batch(env, cfg, [state_init])

    def refine_step(mu, sigma, eps):
        return tuple(o[0] for o in step(mu[None], sigma[None], eps[None]))

    return refine_step


def _check_method(cfg: PathIntegralConfig) -> None:
    if cfg.update_method not in UPDATE_FNS:
        raise ValueError(f"update_method {cfg.update_method!r} is not one "
                         f"of {sorted(UPDATE_FNS)}")


def plan(env, cfg: PathIntegralConfig, generator: torch.Generator,
         state_init=None, eps: Optional[torch.Tensor] = None, mesh=None
         ) -> PathIntegralResult:
    """Refine one seed on ``env.device``: ``plan_batch`` at S = 1, without
    the seed axis. ``generator`` draws the reset state (unless
    ``state_init`` is given) and then every step's noise; ``eps``
    [Nrefine−1, Nsample, Hsample, nu] replaces the drawn noise, step by
    step. ``mesh``: the samples sharded over its ranks, each of which
    calls ``plan`` with the same arguments and gets the same result."""
    res = plan_batch(env, cfg, [generator],
                     None if state_init is None else [state_init],
                     None if eps is None else eps[:, None], mesh)
    return PathIntegralResult(mu_0ts=res.mu_0ts[0],
                              rews_trace=res.rews_trace[0],
                              final_reward=res.final_reward[0],
                              final_diverged=bool(res.final_diverged[0]))


def plan_batch(env, cfg: PathIntegralConfig,
               generators: Sequence[torch.Generator], states_init=None,
               eps: Optional[torch.Tensor] = None, mesh=None
               ) -> PathIntegralResult:
    """S = len(generators) independent refinements in one batch (cf.
    ``mbd.plan_batch``): one rollout of S·Nsample samples per step, σ [S],
    each seed's update its serial rule, and one rollout of the S·(Nrefine
    − 1) iterates for the final selection. The generators draw the resets
    and then each step's noise in seed order, so seed s sees exactly the
    noise of ``plan(env, cfg, generators[s])``; ``eps`` [Nrefine−1, S,
    Nsample, Hsample, nu] replaces the draws; ``mesh`` shards the S·Nsample
    samples as in ``plan``. Returns a PathIntegralResult with a leading
    seed axis."""
    device = env.device
    _check_method(cfg)
    S = len(generators)
    if states_init is None:
        states_init = [env.reset(g) for g in generators]
    if len(states_init) != S:
        raise ValueError(f"{len(states_init)} initial states for {S} seeds")
    refine_step = make_refine_step_batch(env, cfg, states_init, mesh)
    nu = env.action_size
    shape = (cfg.Nsample, cfg.Hsample, nu)
    T = cfg.Nrefine - 1
    if eps is not None and tuple(eps.shape) != (T, S) + shape:
        raise ValueError(f"eps must be [{T}, {S}, {cfg.Nsample}, "
                         f"{cfg.Hsample}, {nu}]")

    mu = torch.zeros((S, cfg.Hsample, nu), device=device)
    sigma = torch.ones((S,), device=device)
    mu_0ts, rews_trace = [], []
    for t in range(T):
        e = eps[t] if eps is not None else draw_eps(generators, shape,
                                                    device)
        mu, sigma, rew = refine_step(mu, sigma, e)
        mu_0ts.append(mu)
        rews_trace.append(rew)
    mu_0ts = torch.stack(mu_0ts, dim=1)                  # [S, T, H, nu]
    final_reward, final_diverged = evaluate_final(env, states_init, mu_0ts,
                                                  mesh)
    return PathIntegralResult(mu_0ts=mu_0ts,
                              rews_trace=torch.stack(rews_trace, dim=1),
                              final_reward=final_reward,
                              final_diverged=final_diverged)
