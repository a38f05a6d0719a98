"""MBD as a black-box optimizer, with no dynamics model (port of
``mbd_tpu/blackbox/bbo.py``).

A population Y [Nsample, dim] in the search cube [−1, 1]^dim is diffused:
at each reverse step every member is perturbed by N(0, σₜ²) and clipped,
the objective values J = −f are standardized into softmax weights at
``temp_sample``, and the weighted barycenter becomes every member's mean
for the next step. The test functions (Ackley, Rastrigin, Levy) map the
cube onto their usual domains.

The reference's quirk is kept: the initial population is zeros plus
N(0, 1), drawn from the same generator the loop then draws its noise
from; it matters only for the first step, after which every member sits
at the barycenter. ``eps`` replaces the draws (the tests feed JAX's
stream through it). Every tensor lives on ``device``: the card unless
the caller asks for the CPU.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch

from ..core.schedule import make_schedule
from ..device import DEFAULT, resolve

A, B, C = 20.0, 0.2, 2.0 * math.pi


def _domain(fn_name: str) -> Tuple[float, float]:
    return (-5.0, 10.0) if fn_name == "Ackley" else (-5.0, 5.0)


def make_objective(fn_name: str, dim: int) -> Callable:
    """f(Y) [...] of points Y [..., dim] in the search cube, mapped onto
    the function's domain: Ackley on [−5, 10], Rastrigin and Levy on
    [−5, 5]; 0 at the optimum."""
    x_min, x_max = _domain(fn_name)

    def to_domain(Y):
        return x_min + (x_max - x_min) * (Y + 1.0) / 2.0

    if fn_name == "Ackley":
        def fn(Y):
            X = to_domain(Y)
            p1 = -A * torch.exp(-B / math.sqrt(dim) *
                                torch.sqrt((X * X).sum(dim=-1)))
            p2 = -torch.exp(torch.cos(C * X).mean(dim=-1))
            return p1 + p2 + A + math.e
    elif fn_name == "Rastrigin":
        def fn(Y):
            X = to_domain(Y)
            return 10.0 * dim + (X ** 2 - 10.0 * torch.cos(
                2.0 * math.pi * X)).sum(dim=-1)
    elif fn_name == "Levy":
        def fn(Y):
            X = to_domain(Y)
            w = 1.0 + (X - 1.0) / 4.0
            p1 = torch.sin(math.pi * w[..., 0]) ** 2
            p2 = ((w[..., :-1] - 1.0) ** 2 * (1.0 + 10.0 * torch.sin(
                math.pi * w[..., :-1] + 1.0) ** 2)).sum(dim=-1)
            p3 = (w[..., -1] - 1.0) ** 2 * (
                1.0 + torch.sin(2.0 * math.pi * w[..., -1]) ** 2)
            return p1 + p2 + p3
    else:
        raise ValueError(fn_name)
    return fn


@dataclass
class BBOConfig:
    fn_name: str = "Rastrigin"
    dim: int = 800
    Nsample: int = 64
    Ndiffuse: int = 100
    temp_sample: float = 1.0
    beta0: float = 1e-4
    betaT: float = 1e-2


@dataclass
class BBOResult:
    evals: torch.Tensor     # cumulative objective evaluations per step
    J_trace: torch.Tensor   # the best (max of −f) objective value per step
    mu_final: torch.Tensor  # the final population [Nsample, dim]


def optimize(cfg: BBOConfig, generator: torch.Generator, device=DEFAULT,
             eps: Optional[torch.Tensor] = None) -> BBOResult:
    """Ndiffuse − 1 reverse steps from Ndiffuse − 1 down to 1. The
    generator (on ``device``) draws the initial population's N(0, 1), then
    each step's noise; ``eps`` [Ndiffuse, Nsample, dim] replaces them, row
    0 the initial population's, row t + 1 step t's."""
    device = resolve(device)
    # the barycenter is a float32 contraction: keep it out of TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    fn = make_objective(cfg.fn_name, cfg.dim)
    sched = make_schedule(cfg.Ndiffuse, cfg.beta0, cfg.betaT, device=device)
    shape = (cfg.Nsample, cfg.dim)
    if eps is not None and tuple(eps.shape) != (cfg.Ndiffuse,) + shape:
        raise ValueError(f"eps must be [{cfg.Ndiffuse}, {cfg.Nsample}, "
                         f"{cfg.dim}]")

    def noise(t):
        if eps is not None:
            return eps[t].to(device)
        return torch.randn(shape, generator=generator, device=device)

    mu = torch.zeros(shape, device=device) + noise(0)
    J_trace = []
    for k, t in enumerate(range(cfg.Ndiffuse - 1, 0, -1)):
        Y0s = torch.clamp(noise(k + 1) * sched.sigmas[t] + mu, -1.0, 1.0)
        Js = -fn(Y0s)
        logp0 = (Js - Js.mean()) / torch.clamp_min(
            Js.std(correction=0), 1e-8) / cfg.temp_sample
        w = torch.softmax(logp0, dim=0)
        mu = torch.einsum("n,ni->i", w, Y0s)[None, :] + torch.zeros_like(mu)
        J_trace.append(Js.max())
    evals = torch.arange(1, cfg.Ndiffuse, device=device) * cfg.Nsample
    return BBOResult(evals=evals, J_trace=torch.stack(J_trace),
                     mu_final=mu)
