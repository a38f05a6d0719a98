"""Model-Based Diffusion trajectory optimizer (port of
``mbd_tpu/planners/mbd.py``: ``plan``, ``plan_batch`` and their reverse
step).

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
So no reward of a flagged sample is read, and without the demo the reverse
step asks the kernel to retire each sample at its first flag
(``rollout_rewards_cuda(..., retire=True)``). The final selection, whose
reported reward may be a flagged plan's, and the demo, which reads flagged
samples' log-densities, roll out whole.

Demo conditioning (``enable_demo``, reference mbd_planner.py:117-125, and
``docs/DEMO_CONDITIONING.md``): each rollout's demo-tracking log-density,
shifted so that the best sample's is 0, plus ``env.rew_xref``, is
standardized with the reward's mean and std into logp_demo. The fused
log-weights are standardized again and divided by the temperature a second
time: the reference's behaviour, kept as it is.

Seed batching (``plan_batch``): S independent plans fold their samples
into one rollout of S·Nsample samples per step, sample s·N + n starting
from seed s's reset state; each seed's statistics above are its own.

The rollout is chosen by the env's kind, as JAX's ``default_engine``
chooses it (mbd_tpu/planners/mbd.py:88-101): a physics env rolls out in
the CUDA kernel (the torch engine on the CPU); an analytic env (car2d)
steps all samples as one batch (``rollout/rollout.py::rollout_us``, JAX's
vmap engine), whose rollouts are never flagged, scores the demo with its
``eval_xref_logpd`` and takes the last iterate as the final plan.

``plan`` can keep a checkpoint after every chunk of steps and resume
from it (``checkpoint_path``, JAX's layout).

Sharding (``mesh``, a ``parallel.SampleMesh``): every rank draws each
step's full noise from the same generator, as one process does, forms
all of Y0s and rolls out only its contiguous shard of the S·Nsample
samples (one launch a step on the card); the per-sample rewards, flags
and demo log-densities are gathered exactly onto every rank, where the
statistics and the update run on the full vectors. So a sharded plan
equals the single-process plan bit for bit, and no collective is as
large as Y0s. The final selection's S·(Ndiffuse − 1) rollouts are split
over the ranks the same way.

Spans (``utils/profiling.py``, recorded only while a ``torch.profiler``
records or inside ``profiling.recording()``): ``mbd.plan`` over a whole
plan, in it ``mbd.prologue`` (everything before the first reverse step),
one ``mbd.step`` a reverse step, tiled by ``mbd.noise``, ``mbd.rollout``,
``mbd.weigh`` (the per-seed statistics) and ``mbd.update``, and
``mbd.final`` (the final selection).

Every tensor lives on ``env.device`` and the loop never waits on the
device until the final evaluation. Random numbers come from an explicit
``torch.Generator``: ``env.reset`` draws the initial state from it, then
each step draws its noise. The ``eps`` argument replaces that noise
stream with given tensors (the tests feed JAX's stream through it).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from ..core.schedule import DiffusionSchedule, make_schedule
from ..envs.physics import PhysicsEnv
from ..ops.rollout_cuda import check_demo, library, rollout_rewards_cuda
from ..rollout.rollout import eval_us, rollout_us
from ..utils.profiling import span


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
    """One plan's result; from ``plan_batch`` every field has a leading
    seed axis S, and ``final_diverged`` is a [S] bool tensor."""
    Ybars: torch.Tensor          # (Ndiffuse-1, Hsample, nu) denoised means
    rews_trace: torch.Tensor     # (Ndiffuse-1,) mean batch reward per step
    final_reward: torch.Tensor   # mean reward of rolling out Ybars[-1]
    # True when the returned plan's own rollout is flagged by the validity
    # envelope and no clean iterate existed to fall back to: final_reward
    # is then not an earned number
    final_diverged: Union[bool, torch.Tensor] = False


def make_reverse_once_batch(env, cfg: MBDConfig, states_init,
                            sched: DiffusionSchedule, mesh=None
                            ) -> Callable:
    """The reverse step of S = len(states_init) independent denoises as
    ``reverse_once(Ybar_i, i, eps) → (Ybar_{i−1}, mean reward)``, with
    Ybar_i [S, H, nu], eps [S, Nsample, H, nu] the step's noise (or a
    function that draws it, called inside the step's ``mbd.noise`` span)
    and the mean reward [S]: the S·N samples go out in one rollout, each
    from its own seed's reset state, and each seed's statistics are its
    own (``per_seed``). With ``mesh``, this rank rolls out its shard of the
    S·N samples, which must divide evenly over the mesh."""
    if cfg.enable_demo and isinstance(env, PhysicsEnv):
        check_demo(env, cfg.Hsample)
    # the barycenter is a float32 contraction: keep it out of TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    state0, lo, hi = shard_samples(env, states_init, cfg.Nsample, mesh)

    def weigh(rewss, bad, Y0s, xref_logpds=None):
        """One seed's barycenter Ȳ and mean reward, from its rewards
        [N, H], flags [N], samples [N, H, nu] (and demo log-densities)."""
        logp0, valid, rew_mean, rew_std = standardized_rewards(
            rewss, bad, cfg.temp_sample)
        if xref_logpds is not None:
            logp0 = fuse_demo(logp0, xref_logpds, rew_mean, rew_std,
                              env.rew_xref, cfg.temp_sample)
        return barycenter(masked_softmax(logp0, valid), Y0s), rew_mean

    def reverse_once(Ybar_i: torch.Tensor, i: int, eps):
        with span("mbd.noise"):
            if callable(eps):
                eps = eps()
            abar = sched.alphas_bar[i]
            Yi = Ybar_i * torch.sqrt(abar)
            Y0s = torch.clamp(eps * sched.sigmas[i] + Ybar_i[:, None], -1.0,
                              1.0)
        S, N = Y0s.shape[:2]
        with span("mbd.rollout"):
            out = sharded_rollout(env, state0, Y0s.reshape(
                (S * N,) + Y0s.shape[2:]), lo, hi, mesh,
                demo=cfg.enable_demo, retire=not cfg.enable_demo)
        with span("mbd.weigh"):
            Ybar, rew = per_seed(weigh, out[0].reshape(S, N, -1),
                                 out[1].reshape(S, N), Y0s,
                                 *[o.reshape(S, N) for o in out[2:]])
        with span("mbd.update"):
            score = (-Yi + torch.sqrt(abar) * Ybar) / (1.0 - abar)
            Yim1 = (Yi + (1.0 - abar) * score) / torch.sqrt(sched.alphas[i])
            return Yim1 / torch.sqrt(sched.alphas_bar[i - 1]), rew

    return reverse_once


def make_reverse_once(env, cfg: MBDConfig, state_init,
                      sched: DiffusionSchedule, mesh=None) -> Callable:
    """One seed's reverse step, ``reverse_once(Ybar_i, i, eps) →
    (Ybar_{i−1}, mean reward)`` with Ybar_i [H, nu] and eps [Nsample, H,
    nu]: ``make_reverse_once_batch`` at S = 1."""
    step = make_reverse_once_batch(env, cfg, [state_init], sched, mesh)

    def reverse_once(Ybar_i, i, eps):
        return tuple(o[0] for o in step(Ybar_i[None], i, eps[None]))

    return reverse_once


def per_seed(fn: Callable, *args):
    """``fn`` on each seed's slice of the args (leading axis S), its
    outputs stacked. Each seed's statistics then reduce the serial plan's
    shapes, so seed s of a batch is the same seed planned alone bit for
    bit on the card too, where a reduction over the rows of [S, N] may sum
    in another order than one over [N]."""
    outs = [fn(*(a[s] for a in args)) for s in range(args[0].shape[0])]
    return tuple(torch.stack(o) for o in zip(*outs))


def seed_major(states, N: int) -> SimpleNamespace:
    """Per-sample initial states [nq, S·N] / [nv, S·N] from S seeds' reset
    states: sample s·N + n starts from seed s's (JAX's
    ``jnp.repeat(q.T, N, axis=1)``)."""
    def rows(xs):
        return torch.stack(xs).T.repeat_interleave(N, dim=1).contiguous()

    return SimpleNamespace(pipeline_state=SimpleNamespace(
        q=rows([s.pipeline_state.q for s in states]),
        qd=rows([s.pipeline_state.qd for s in states])))


def batch_states(env, states, N: int):
    """The initial states of S·N samples, sample s·N + n from seed s's
    reset state: ``seed_major``'s for a physics env; for an analytic env
    one state whose pipeline state is [S·N, 3]."""
    if isinstance(env, PhysicsEnv):
        return seed_major(states, N)
    x = torch.stack([s.pipeline_state for s in states])
    return states[0].replace(pipeline_state=x.repeat_interleave(N, dim=0))


def shard_states(env, state0, lo: int, hi: int):
    """Samples [lo, hi) of ``batch_states``'s initial states."""
    if isinstance(env, PhysicsEnv):
        ps = state0.pipeline_state
        if (lo, hi) == (0, ps.q.shape[1]):
            return state0
        return SimpleNamespace(pipeline_state=SimpleNamespace(
            q=ps.q[:, lo:hi].contiguous(), qd=ps.qd[:, lo:hi].contiguous()))
    return state0.replace(pipeline_state=state0.pipeline_state[lo:hi])


def shard_samples(env, states_init, N: int, mesh):
    """(state0, lo, hi): this rank's samples [lo, hi) of the S·N of S =
    len(states_init) seeds and their initial states (``batch_states``,
    ``shard_states``); all of them without ``mesh``. S·N must divide
    evenly over the mesh. A physics env's ranks on the card load one
    build of its kernel, which rank 0 makes first."""
    state0 = batch_states(env, states_init, N)
    SN = len(states_init) * N
    if mesh is None:
        return state0, 0, SN
    lo, hi = mesh.shard(SN, "Nsample" if len(states_init) == 1
                        else "S·Nsample")
    if isinstance(env, PhysicsEnv) and env.device.type == "cuda":
        mesh.first(lambda: library(env))
    return shard_states(env, state0, lo, hi), lo, hi


def sharded_rollout(env, state0, Y0s: torch.Tensor, lo: int, hi: int,
                    mesh, demo: bool = False, retire: bool = False):
    """``rollout_batch`` of the samples [lo, hi) of Y0s [n, H, nu] from
    their initial states ``state0`` (``shard_states``'s), each output
    then gathered to all n samples on every rank; without ``mesh``, the
    rollout of all of Y0s. One collective: the outputs go as the columns
    of one [n, H + 1 (+ 1)] tensor. The rewards come back laid out in
    memory as the rollout gave them (the transpose of an [H, n] tensor
    from the kernel and the plain engine), so that their mean over H sums
    in the same order as in one process."""
    out = rollout_batch(env, state0, Y0s[lo:hi], demo=demo, retire=retire)
    if mesh is None:
        return out
    rews, H = out[0], out[0].shape[1]
    full = mesh.gather(torch.cat([rews] + [o[:, None] for o in out[1:]],
                                 dim=1), Y0s.shape[0], lo)
    rews = full[:, :H].t().contiguous().t() if rews.t().is_contiguous() \
        else full[:, :H].contiguous()
    return (rews,) + tuple(full[:, H + k].contiguous()
                           for k in range(len(out) - 1))


def rollout_batch(env, state0, Y0s: torch.Tensor, demo: bool = False,
                  retire: bool = False):
    """Y0s [N, H, nu] from ``batch_states``'s initial states → (rews [N, H],
    bad [N][, logpd [N]]). A physics env: the CUDA kernel (the torch
    engine on the CPU), with ``retire`` its retiring form, whose rewards
    after a sample's first flag are NaN. An analytic env: its step on the
    whole batch (JAX's vmap engine, mbd_tpu/planners/mbd.py:388-395), no
    flag, and the demo log-density from ``env.eval_xref_logpd`` over the
    states."""
    if isinstance(env, PhysicsEnv):
        return rollout_rewards_cuda(env, state0, Y0s, demo=demo,
                                    retire=retire)
    rews, xs = rollout_us(env, state0, Y0s)
    out = (rews, torch.zeros_like(rews[:, 0]))
    return out + (env.eval_xref_logpd(xs),) if demo else out


# One seed's statistics, each the counterpart of JAX plan_batch's over
# axis 1 (mbd_tpu/planners/mbd.py:409-438).

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
    rew_std = _std(rews)
    return (rews - rew_mean) / rew_std / temp, valid, rew_mean, rew_std


def _std(x: torch.Tensor) -> torch.Tensor:
    """The population std, 1 where under 1e-4."""
    std = x.std(correction=0)
    return torch.where(std < 1e-4, torch.ones_like(std), std)


def fuse_demo(logp0, xref_logpds, rew_mean, rew_std, rew_xref: float,
              temp: float) -> torch.Tensor:
    """The demo fusion: each rollout's demo log-density, shifted so that
    the best is 0 (the max over every sample, flagged ones included),
    plus ``rew_xref``, standardized with the reward's mean and std into
    logp_demo; the larger of the two log-weights, standardized again and
    divided by ``temp`` a second time."""
    xref_logpds = xref_logpds - xref_logpds.max()
    logpdemo = (xref_logpds + rew_xref - rew_mean) / rew_std / temp
    logp0 = torch.where(logpdemo > logp0, logpdemo, logp0)
    return (logp0 - logp0.mean()) / _std(logp0) / temp


def masked_softmax(logp0: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Softmax weights with zero weight for the samples not ``valid``;
    uniform weights when none is."""
    logp0 = torch.where(valid, logp0, torch.full_like(logp0, -float("inf")))
    weights = torch.softmax(logp0, dim=0)
    return torch.where(valid.any(), weights,
                       torch.full_like(weights, 1.0 / logp0.shape[0]))


def barycenter(weights: torch.Tensor, Y0s: torch.Tensor) -> torch.Tensor:
    """Σₙ wₙ·Y0sₙ: weights [N], Y0s [N, H, nu]."""
    return torch.einsum("n,nij->ij", weights, Y0s)


def plan(env, cfg: MBDConfig, generator: torch.Generator, state_init=None,
         chunk_size: int = 0, progress_fn=None,
         eps: Optional[torch.Tensor] = None,
         checkpoint_path: Optional[str] = None, mesh=None) -> MBDResult:
    """Run the full reverse diffusion of one seed on ``env.device``:
    ``plan_batch`` at S = 1, without the seed axis.

    ``generator`` draws the reset state (unless ``state_init`` is given)
    and then every step's noise. ``progress_fn(step, mean_reward)`` is
    called after every ``chunk_size`` steps and after the last one.
    ``eps`` [Ndiffuse−1, Nsample, Hsample, nu] replaces the drawn noise,
    step by step in the order the steps run.

    ``checkpoint_path`` (needs ``chunk_size > 0``) keeps the denoise's
    state after every chunk and, when the checkpoint exists, resumes from
    it: ``Checkpoint`` has the layout. A resumed plan equals the
    uninterrupted one bit for bit on the same device when it is called as
    the interrupted one was (the same generator seed or ``state_init``,
    and ``eps``). A checkpoint of the JAX package cannot be resumed here:
    it stores a threefry key, the port a Philox generator's state.

    ``mesh`` (a ``parallel.SampleMesh``): the Nsample samples are sharded
    over its ranks, each of which calls ``plan`` with the same arguments
    and gets the same result; Nsample must divide evenly. Only rank 0
    writes the checkpoint.
    """
    if checkpoint_path is not None and chunk_size <= 0:
        raise ValueError("checkpoint_path needs chunk_size > 0: the "
                         "checkpoint is written after every chunk")
    res = _denoise(env, cfg, [generator],
                   None if state_init is None else [state_init],
                   chunk_size, progress_fn,
                   None if eps is None else eps[:, None],
                   checkpoint_path, mesh)
    return MBDResult(Ybars=res.Ybars[0], rews_trace=res.rews_trace[0],
                     final_reward=res.final_reward[0],
                     final_diverged=bool(res.final_diverged[0]))


def draw_eps(generators: Sequence[torch.Generator], shape,
             device) -> torch.Tensor:
    """One step's noise of every seed, [S, *shape]: each seed's from its
    own generator, in seed order, as its serial plan draws it."""
    return torch.stack([torch.randn(shape, generator=g, device=device)
                        for g in generators])


def plan_batch(env, cfg: MBDConfig, generators: Sequence[torch.Generator],
               states_init=None, chunk_size: int = 0, progress_fn=None,
               eps: Optional[torch.Tensor] = None, mesh=None) -> MBDResult:
    """S = len(generators) independent plans in one batch on
    ``env.device``: every step rolls the S·Nsample samples out in one
    launch, and the final selection takes one more.

    Each generator draws its seed's reset state first (unless
    ``states_init``, a sequence of S states, is given); at each step every
    seed then draws its noise from its own generator, in seed order, so
    seed s sees exactly the noise of ``plan(env, cfg, generators[s])``.
    ``eps`` [Ndiffuse−1, S, Nsample, Hsample, nu] replaces the draws.
    ``progress_fn(step, mean reward over the seeds)`` as in ``plan``.
    ``mesh``: the S·Nsample samples of a step sharded over its ranks, as
    in ``plan``. Returns an MBDResult with a leading seed axis.
    """
    return _denoise(env, cfg, generators, states_init, chunk_size,
                    progress_fn, eps, mesh=mesh)


class Checkpoint:
    """A denoise's checkpoint in the JAX package's layout
    (mbd_tpu/planners/mbd.py:705-750), from ``path`` (``.npz`` added if
    missing) and its base ``<base>``:

      * ``<base>.Ybars.npy`` and ``<base>.rews.npy``: preallocated ``.npy``
        memmaps of the iterates [T + pad, H, nu] and the mean rewards
        [T + pad] (pad: the tail up to a whole chunk, which stays 0),
        written a chunk at a time;
      * ``<base>.npz``: ``next_chunk`` (the first step not yet run),
        ``Ybar`` [H, nu] and ``generator`` (the generator's state as
        uint8), written after the memmaps are flushed, so that a crash
        inside a chunk only runs that chunk again.

    Under a mesh every rank resumes from the files, and only rank 0
    (``writer``) creates and writes them; ``save`` ends with a barrier,
    so that no rank reads a checkpoint rank 0 is still writing.
    """

    def __init__(self, path: str, T: int, chunk_size: int, H: int, nu: int,
                 mesh=None):
        self.mesh = mesh
        self.writer = mesh is None or mesh.rank == 0
        self.path = path if path.endswith(".npz") else path + ".npz"
        base = self.path[:-len(".npz")]
        self.shape = (T + (-T) % chunk_size, H, nu)
        self.y_path, self.r_path = base + ".Ybars.npy", base + ".rews.npy"
        self.Y_mm = self.r_mm = None

    def resume(self, generator: torch.Generator, device):
        """Opens the memmaps; when the checkpoint exists, restores the
        generator and returns (the first step to run, Ȳ [1, H, nu], the
        iterates [start, H, nu] and rewards [start] so far), else
        (0, None, None, None)."""
        if not os.path.exists(self.path):
            if not self.writer:
                return 0, None, None, None
            self.Y_mm = np.lib.format.open_memmap(
                self.y_path, mode="w+", dtype=np.float32, shape=self.shape)
            self.r_mm = np.lib.format.open_memmap(
                self.r_path, mode="w+", dtype=np.float32,
                shape=self.shape[:1])
            return 0, None, None, None
        with np.load(self.path) as meta:
            start = int(meta["next_chunk"])
            Ybar = torch.from_numpy(meta["Ybar"]).to(device)[None]
            generator.set_state(torch.from_numpy(meta["generator"]))
        mode = "r+" if self.writer else "r"
        self.Y_mm = np.lib.format.open_memmap(self.y_path, mode=mode)
        self.r_mm = np.lib.format.open_memmap(self.r_path, mode=mode)
        return (start, Ybar, torch.from_numpy(np.array(self.Y_mm[:start])),
                torch.from_numpy(np.array(self.r_mm[:start])))

    def save(self, c: int, Ybars, rews, Ybar, generator, chunk_size: int):
        """Chunk c's iterates [k, H, nu] and rewards [k] into the memmaps
        at rows c…c + k, then the meta file with next_chunk = c +
        chunk_size."""
        if not self.writer:
            self.mesh.barrier()
            return
        self.Y_mm[c:c + len(Ybars)] = Ybars.cpu().numpy()
        self.r_mm[c:c + len(rews)] = rews.cpu().numpy()
        self.Y_mm.flush()
        self.r_mm.flush()
        np.savez(self.path, next_chunk=c + chunk_size,
                 Ybar=Ybar.cpu().numpy(),
                 generator=generator.get_state().numpy())
        if self.mesh is not None:
            self.mesh.barrier()


def _denoise(env, cfg: MBDConfig, generators, states_init, chunk_size,
             progress_fn, eps, checkpoint_path: Optional[str] = None,
             mesh=None) -> MBDResult:
    """``plan_batch``; with ``checkpoint_path`` (one seed only, from
    ``plan``), the chunks are checkpointed and resumed (``Checkpoint``)."""
    S = len(generators)
    T = cfg.Ndiffuse - 1
    with span("mbd.plan", plan=True, S=S, Nsample=cfg.Nsample, T=T):
        with span("mbd.prologue"):
            pro = _prologue(env, cfg, generators, states_init, chunk_size,
                            eps, checkpoint_path, mesh)
        Ybar, Ybars, rews_trace, ckpt = pro.Ybar, pro.Ybars, \
            pro.rews_trace, pro.ckpt
        for t, i in enumerate(range(cfg.Ndiffuse - 1, 0, -1)):
            if t < pro.start:
                continue
            with span("mbd.step", t=t):
                e = eps[t] if eps is not None else (
                    lambda: draw_eps(generators, pro.shape, env.device))
                Ybar, rew = pro.reverse_once(Ybar, i, e)
                Ybars.append(Ybar)
                rews_trace.append(rew)
            if chunk_size > 0 and ((t + 1) % chunk_size == 0 or t + 1 == T):
                if ckpt is not None:
                    c = t - t % chunk_size             # the chunk's first
                    ckpt.save(c, torch.stack(Ybars[c:])[:, 0],
                              torch.stack(rews_trace[c:])[:, 0], Ybar[0],
                              generators[0], chunk_size)
                if progress_fn is not None:
                    progress_fn(t + 1, float(rew.mean()))
        with span("mbd.final"):
            Ybars = torch.stack(Ybars, dim=1)                # [S, T, H, nu]
            final_reward, final_diverged = evaluate_final(
                env, pro.states_init, Ybars, mesh)
    return MBDResult(Ybars=Ybars, rews_trace=torch.stack(rews_trace, dim=1),
                     final_reward=final_reward,
                     final_diverged=final_diverged)


def _prologue(env, cfg: MBDConfig, generators, states_init, chunk_size,
              eps, checkpoint_path, mesh) -> SimpleNamespace:
    """What ``_denoise`` sets up before its first reverse step: the reset
    states, the schedule and the reverse step, the first iterate and, with
    a checkpoint, the step to resume at and the iterates and rewards so
    far."""
    device = env.device
    S = len(generators)
    if states_init is None:
        states_init = [env.reset(g) for g in generators]
    if len(states_init) != S:
        raise ValueError(f"{len(states_init)} initial states for {S} seeds")
    sched = make_schedule(cfg.Ndiffuse, cfg.beta0, cfg.betaT, device=device)
    reverse_once = make_reverse_once_batch(env, cfg, states_init, sched,
                                           mesh)
    nu = env.action_size
    shape = (cfg.Nsample, cfg.Hsample, nu)
    T = cfg.Ndiffuse - 1
    if eps is not None and tuple(eps.shape) != (T, S) + shape:
        raise ValueError(f"eps must be [{T}, {S}, {cfg.Nsample}, "
                         f"{cfg.Hsample}, {nu}]")

    Ybar = torch.zeros((S, cfg.Hsample, nu), device=device)
    Ybars, rews_trace = [], []
    start = 0
    ckpt = None
    if checkpoint_path is not None:
        ckpt = Checkpoint(checkpoint_path, T, chunk_size, cfg.Hsample, nu,
                          mesh)
        start, Ybar_saved, Ybars_saved, rews_saved = ckpt.resume(
            generators[0], device)
        if mesh is not None:
            mesh.agree(start, "the step a checkpointed plan resumes at (its "
                       "path must name the same files on every rank)")
        if start:
            Ybar = Ybar_saved
            Ybars = list(Ybars_saved[:T, None].to(device))
            rews_trace = list(rews_saved[:T, None].to(device))
    return SimpleNamespace(
        states_init=states_init, reverse_once=reverse_once, shape=shape,
        Ybar=Ybar, Ybars=Ybars, rews_trace=rews_trace, start=start,
        ckpt=ckpt)


def evaluate_final(env, states_init, plans: torch.Tensor, mesh=None):
    """The final selection of S plans at once. For a physics env (JAX's
    plan_batch, mbd_tpu/planners/mbd.py:560-598): every iterate of
    ``plans`` [S, T, H, nu] in one rollout of S·T samples, each from its
    seed's reset state. Per seed, the last iterate when its own rollout is
    clean, else the best clean one (written into ``plans[:, -1]``); with
    none clean, the last and True; with ``mesh``, the S·T rollouts split
    over its ranks (``SampleMesh.split``). For an analytic env (JAX's vmap
    branch, :599-606 and :786-790): the last iterate's mean reward,
    flagged only when it is not finite. Returns (final_reward [S],
    final_diverged [S] bool)."""
    S, T = plans.shape[:2]
    if not isinstance(env, PhysicsEnv):
        final_reward = eval_us(env, batch_states(env, states_init, 1),
                               plans[:, -1]).mean(dim=-1)
        return final_reward, ~torch.isfinite(final_reward)
    lo, hi = (0, S * T) if mesh is None else mesh.split(S * T)
    rews, bad = sharded_rollout(
        env, shard_states(env, seed_major(states_init, T), lo, hi),
        plans.reshape((S * T,) + plans.shape[2:]), lo, hi, mesh)
    cand = rews.mean(dim=-1).reshape(S, T)
    feasible = (bad.reshape(S, T) == 0) & torch.isfinite(cand)
    masked = torch.where(feasible, cand, torch.full_like(cand,
                                                         -float("inf")))
    last = torch.full((S,), T - 1, device=plans.device)
    choose = torch.where(feasible[:, -1], last, torch.argmax(masked, dim=1))
    choose = torch.where(feasible.any(dim=1), choose, last)
    seeds = torch.arange(S, device=plans.device)
    plans[:, -1] = plans[seeds, choose]
    return cand[seeds, choose], ~feasible[seeds, choose]
