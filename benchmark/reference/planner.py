"""The planner's arithmetic written out in plain torch: the variance
schedule, the reverse step (standardize, masked softmax, barycenter, score
update), the final selection, and the random draws of a plan worked out
again from its seeds.

What a plan of S seeds draws, in order, from seed s's
``torch.Generator`` on the plan's device: the reset (``Model.reset``),
then at each reverse step t = 0, 1, … (index i = Ndiffuse − 1 − t) one
standard normal ε of shape [Nsample, H, nu]. Step t forms its samples as
clip(Ȳ + σᵢ·ε, −1, 1) around the iterate before it (zeros before the
first step).
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence

import torch


class Schedule(NamedTuple):
    alphas: torch.Tensor
    alphas_bar: torch.Tensor
    sigmas: torch.Tensor


def schedule(Ndiffuse: int, beta0: float, betaT: float, device) -> Schedule:
    """Linear float32 betas from beta0 to betaT (the last exactly betaT),
    ᾱ = cumprod(1 − β), σ = √(1 − ᾱ)."""
    f = dict(dtype=torch.float32, device=device)
    lo, hi = torch.tensor(beta0, **f), torch.tensor(betaT, **f)
    if Ndiffuse == 1:
        betas = lo[None]
    else:
        frac = torch.arange(Ndiffuse - 1, **f) / float(Ndiffuse - 1)
        betas = torch.cat([lo * (1 - frac) + hi * frac, hi[None]])
    alphas = 1.0 - betas
    alphas_bar = torch.cumprod(alphas, dim=0)
    return Schedule(alphas, alphas_bar, torch.sqrt(1.0 - alphas_bar))


class Draws(NamedTuple):
    """A plan's draws: the S resets (q [S, nq], qd [S, nv]) and the noise
    [S, N, H, nu] of each step asked for, by step."""
    q0: torch.Tensor
    qd0: torch.Tensor
    eps: dict


def draws(model, seeds: Sequence[int], steps: Sequence[int], shape,
          device) -> Draws:
    """The resets of ``seeds`` and the noise of reverse steps ``steps``
    (indices t from 0), drawn again from fresh generators."""
    gens = [torch.Generator(device).manual_seed(s) for s in seeds]
    resets = [model.reset(g) for g in gens]
    eps = {}
    for t in range(max(steps) + 1):
        e = torch.stack([torch.randn(shape, generator=g, device=device)
                         for g in gens])
        if t in steps:
            eps[t] = e
    return Draws(torch.stack([q for q, _ in resets]),
                 torch.stack([qd for _, qd in resets]), eps)


def samples(sched: Schedule, i: int, Ybar: torch.Tensor,
            eps: torch.Tensor) -> torch.Tensor:
    """Step i's samples [S, N, H, nu] around Ybar [S, H, nu]."""
    return torch.clamp(eps * sched.sigmas[i] + Ybar[:, None], -1.0, 1.0)


def _std(x: torch.Tensor) -> torch.Tensor:
    std = x.std(correction=0)
    return torch.where(std < 1e-4, torch.ones_like(std), std)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, to nearest, ties away
    from zero (what the tensor cores read of a float32 operand)."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return torch.where(torch.isfinite(x), bits.view(torch.float32), x)


def weigh(rewss: torch.Tensor, bad: torch.Tensor, Y0s: torch.Tensor,
          temp: float, precision: str = "float32") -> torch.Tensor:
    """One seed's barycenter [H, nu] from its rewards [N, H], flags [N]
    and samples [N, H, nu]: each rollout's mean reward, the flagged or
    non-finite ones set to the worst valid one, standardized (a std under
    1e-4 counts as 1) and divided by ``temp``; softmax weights with 0 for
    those not valid (uniform when none is); Σₙ wₙ·Y0sₙ. ``precision``
    "tf32" forms the barycenter from TF32-rounded operands (the
    control)."""
    rews = rewss.mean(dim=-1)
    valid = torch.isfinite(rews) & (bad == 0)
    inf = torch.full_like(rews, float("inf"))
    worst = torch.min(torch.where(valid, rews, inf))
    worst = torch.where(torch.isfinite(worst), worst, torch.zeros_like(worst))
    rews = torch.where(valid, rews, worst)
    logp0 = (rews - rews.mean()) / _std(rews) / temp
    logp0 = torch.where(valid, logp0, torch.full_like(logp0, -float("inf")))
    weights = torch.softmax(logp0, dim=0)
    weights = torch.where(valid.any(), weights,
                          torch.full_like(weights, 1.0 / logp0.shape[0]))
    if precision == "tf32":
        weights, Y0s = tf32(weights), tf32(Y0s)
    return torch.einsum("n,nij->ij", weights, Y0s)


def reverse(sched: Schedule, i: int, Ybar: torch.Tensor,
            Ybar0: torch.Tensor) -> torch.Tensor:
    """The score update of step i from the iterate Ybar [S, H, nu] and the
    barycenters Ybar0 [S, H, nu]: the next iterate."""
    abar = sched.alphas_bar[i]
    Yi = Ybar * torch.sqrt(abar)
    score = (-Yi + torch.sqrt(abar) * Ybar0) / (1.0 - abar)
    Yim1 = (Yi + (1.0 - abar) * score) / torch.sqrt(sched.alphas[i])
    return Yim1 / torch.sqrt(sched.alphas_bar[i - 1])


def step(sched: Schedule, i: int, Ybar: torch.Tensor, Y0s: torch.Tensor,
         rews: torch.Tensor, bad: torch.Tensor, temp: float,
         precision: str = "float32") -> torch.Tensor:
    """Step i of S seeds: Ybar [S, H, nu], their samples Y0s [S, N, H, nu]
    with rewards [S, N, H] and flags [S, N] → the next iterate."""
    Ybar0 = torch.stack([weigh(rews[s], bad[s], Y0s[s], temp, precision)
                         for s in range(Y0s.shape[0])])
    return reverse(sched, i, Ybar, Ybar0)


class Selection(NamedTuple):
    """The final selection of S seeds over T candidates each."""
    choose: torch.Tensor      # [S] the candidate chosen
    reward: torch.Tensor      # [S] its mean reward
    diverged: torch.Tensor    # [S] bool: no clean candidate
    cand: torch.Tensor        # [S, T] every candidate's mean reward
    feasible: torch.Tensor    # [S, T] bool: clean


def select(rews: torch.Tensor, bad: torch.Tensor, S: int) -> Selection:
    """From the rewards [S·T, H] and flags [S·T] of S seeds' T candidates
    each (seed-major): per seed the last candidate when it is clean (flag
    0 and a finite mean reward), else the best clean one; with none
    clean, the last, diverged."""
    cand = rews.mean(dim=-1).reshape(S, -1)
    T = cand.shape[1]
    feasible = (bad.reshape(S, T) == 0) & torch.isfinite(cand)
    masked = torch.where(feasible, cand, torch.full_like(cand,
                                                         -float("inf")))
    last = torch.full((S,), T - 1, device=cand.device)
    choose = torch.where(feasible[:, -1], last, torch.argmax(masked, dim=1))
    choose = torch.where(feasible.any(dim=1), choose, last)
    seeds = torch.arange(S, device=cand.device)
    return Selection(choose, cand[seeds, choose], ~feasible[seeds, choose],
                     cand, feasible)


def seed_major(x: torch.Tensor, n: int) -> torch.Tensor:
    """[S, k] per-seed rows → [k, S·n], column s·n + j seed s's."""
    return x.T.repeat_interleave(n, dim=1).contiguous()


def segments(rews: torch.Tensor, bad: torch.Tensor,
             sizes: Sequence[int]) -> List[tuple]:
    """The rollout's outputs (rews [M, H], bad [M]) cut into consecutive
    segments of ``sizes`` samples, each segment's rewards laid out as a
    launch of its own gives them (the transpose of a contiguous [H, n])."""
    out, lo = [], 0
    for n in sizes:
        seg = rews[lo:lo + n].t().contiguous().t()
        out.append((seg, bad[lo:lo + n]))
        lo += n
    return out


