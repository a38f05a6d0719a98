"""Batch-last training environment: RL's env step on the rollout kernel
(port of ``mbd_tpu/rl/batched_env.py``).

The per-env state is carried as q [nq, B] / qd [nv, B]. One step is one
launch of the CUDA rollout kernel's state-out mode
(``ops/rollout_cuda.py::env_step_cuda``: the checked substeps of
``env_step_checked_b`` and the env's ``reward_qs_b``) on the card, and its
plain version (the torch engine) on the CPU; observations and
terminations come from the env's ``obs_qs_b`` / ``rl_done_qs_b``.

Semantics mirror rl/wrappers.py (tests/test_torch_rl_env.py holds them
against the JAX package's):

 - DivergenceGuardWrapper: a step that leaves the validity envelope (a
   flag of the checked substeps, or a non-finite q) is rolled back to the
   pre-step state with done = 1 and reward −10;
 - EpisodeWrapper: done at ``episode_length`` steps, with ``truncation``
   marked so GAE can bootstrap through time limits;
 - AutoResetWrapper: on done, the cached FIRST reset state replaces the
   env's state (brax semantics: no re-randomisation).

With a ``mesh`` (``parallel.SampleMesh``), each rank steps its share of
the envs (one launch a rank and step) and the new states, rewards and
flags are gathered exactly onto every rank; everything else runs on the
whole batch on every rank, as in one process.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops.rollout_cuda import env_step_cuda, library


@dataclass
class BatchedEnvState:
    """Batch-last training state: q [nq, B], qd [nv, B], obs [B, obs],
    steps [B] (steps since the episode's start)."""
    q: torch.Tensor
    qd: torch.Tensor
    obs: torch.Tensor
    steps: torch.Tensor


class BatchedTrainEnv:
    """Auto-reset, episode-truncated, divergence-guarded batch-last env."""

    def __init__(self, env, episode_length: int,
                 divergence_penalty: float = -10.0, mesh=None):
        if not (hasattr(env, "sys") and hasattr(env, "reward_qs_b")):
            raise ValueError(
                f"{type(env).__name__} has no batch-last path (sys + "
                "reward_qs_b): train it through rl/wrappers.py")
        self.env = env
        self.episode_length = episode_length
        self.divergence_penalty = divergence_penalty
        self.mesh = mesh
        if mesh is not None and env.device.type == "cuda":
            mesh.first(lambda: library(env))     # one build for the ranks

    def reset(self, generator: torch.Generator,
              num_envs: int) -> BatchedEnvState:
        """``num_envs`` resets, drawn from ``generator`` in turn as the
        env's own ``reset`` draws them (``reset_q``), in the batch-last
        layout. The returned state doubles as the cached auto-reset
        pool."""
        states = [self.env.reset_q(generator) for _ in range(num_envs)]
        return self.from_states(torch.stack([q for q, _ in states], 1),
                                torch.stack([qd for _, qd in states], 1))

    def from_states(self, q: torch.Tensor,
                    qd: torch.Tensor) -> BatchedEnvState:
        """The state at the start of an episode from q [nq, B] and
        qd [nv, B]."""
        q, qd = q.contiguous(), qd.contiguous()
        return BatchedEnvState(q=q, qd=qd, obs=self.env.obs_qs_b(q, qd).t(),
                               steps=torch.zeros_like(q[0]))

    def guarded_step(self, q0: torch.Tensor, qd0: torch.Tensor,
                     u: torch.Tensor):
        """One env step under the divergence guard: u [nu, B] →
        (q' [nq, B], qd' [nv, B], reward [B], bad [B]), a flagged sample
        rolled back to (q0, qd0) with the penalty as its reward."""
        q1, qd1, reward, bad = self.env_step(q0, qd0, u)
        bad = torch.maximum(bad, 1.0 - torch.isfinite(q1).all(0).to(
            q0.dtype))
        flagged = bad > 0
        q1 = torch.where(flagged, q0, q1)
        qd1 = torch.where(flagged, qd0, qd1)
        reward = torch.where(flagged, torch.full_like(
            reward, self.divergence_penalty), reward)
        return q1, qd1, reward, bad

    def env_step(self, q0: torch.Tensor, qd0: torch.Tensor,
                 u: torch.Tensor):
        """``env_step_cuda`` of all B envs; under a mesh, of this rank's
        share (``SampleMesh.split``), its outputs gathered as the rows of
        one [B, nq + nv + 2] tensor."""
        if self.mesh is None:
            return env_step_cuda(self.env, q0, qd0, u)
        B = u.shape[1]
        lo, hi = self.mesh.split(B)
        q1, qd1, reward, bad = env_step_cuda(self.env, q0[:, lo:hi],
                                             qd0[:, lo:hi], u[:, lo:hi])
        full = self.mesh.gather(torch.cat(
            [q1, qd1, reward[None], bad[None]]).t(), B, lo).t()
        nq, nv = q1.shape[0], qd1.shape[0]
        return tuple(t.contiguous() for t in (
            full[:nq], full[nq:nq + nv], full[nq + nv], full[nq + nv + 1]))

    def step(self, state: BatchedEnvState, first: BatchedEnvState,
             actions: torch.Tensor):
        """One training step for all envs: actions [B, nu] →
        (next_state, reward [B], done [B], truncation [B]). ``first`` is
        the cached reset pool from :meth:`reset`."""
        q1, qd1, reward, bad = self.guarded_step(state.q, state.qd,
                                                 actions.t().contiguous())
        env_done = torch.maximum(self.env.rl_done_qs_b(q1, qd1), bad)
        steps = state.steps + 1.0
        at_limit = steps >= self.episode_length
        done = torch.where(at_limit, torch.ones_like(env_done), env_done)
        truncation = (at_limit & (env_done == 0)).to(done.dtype)
        # auto-reset from the cached pool
        reset = done > 0
        next_state = BatchedEnvState(
            q=torch.where(reset, first.q, q1),
            qd=torch.where(reset, first.qd, qd1),
            obs=torch.where(reset[:, None], first.obs,
                            self.env.obs_qs_b(q1, qd1).t()),
            steps=torch.where(reset, torch.zeros_like(steps), steps))
        return next_state, reward, done, truncation


class TrainEnv:
    """The envs of a training run, stepped as one batch: a physics env
    through ``BatchedTrainEnv`` (the kernel on the card), an analytic one
    (car2d) through the wrappers (``rl/wrappers.py``). JAX's trainers take
    the first path for a physics env at ``action_repeat`` 1 and the second
    otherwise."""

    def __init__(self, env, episode_length: int, action_repeat: int = 1,
                 mesh=None):
        from .wrappers import wrap_for_training

        self.batch_last = hasattr(env, "sys") and \
            hasattr(env, "reward_qs_b") and hasattr(env, "obs_qs_b")
        if mesh is not None and not self.batch_last:
            raise ValueError("mesh training requires the batch-last "
                             "rollout path (physics envs)")
        if self.batch_last:
            if action_repeat != 1:
                raise ValueError("a physics env trains at action_repeat 1")
            self.benv = BatchedTrainEnv(env, episode_length, mesh=mesh)
        else:
            self.wrapped = wrap_for_training(env, episode_length,
                                             action_repeat)

    def reset(self, generator: torch.Generator, num_envs: int):
        """The envs' first state (with the auto-reset pool)."""
        if self.batch_last:
            first = self.benv.reset(generator, num_envs)
            return first, first
        from .wrappers import batched_reset
        return batched_reset(self.wrapped, generator, num_envs)

    def obs(self, state) -> torch.Tensor:
        return state[0].obs if self.batch_last else state.obs

    def step(self, state, actions: torch.Tensor):
        """actions [B, nu] → (next state, reward [B], done [B],
        truncation [B])."""
        if self.batch_last:
            nxt, reward, done, trunc = self.benv.step(state[0], state[1],
                                                      actions)
            return (nxt, state[1]), reward, done, trunc
        nxt = self.wrapped.step(state, actions)
        return nxt, nxt.reward, nxt.done, nxt.metrics["truncation"]


@torch.no_grad()
def evaluate(tenv: TrainEnv, act_fn, num_envs: int, n_steps: int,
             generator: torch.Generator) -> torch.Tensor:
    """The mean over ``num_envs`` fresh envs of each one's total reward
    over ``n_steps`` steps or up to its first done, under
    ``act_fn(obs) → actions`` (the trainers' evaluation)."""
    state = tenv.reset(generator, num_envs)
    total = active = None
    for _ in range(n_steps):
        state, reward, done, _ = tenv.step(state, act_fn(tenv.obs(state)))
        if total is None:
            total, active = torch.zeros_like(reward), torch.ones_like(reward)
        total = total + reward * active
        active = active * (1.0 - done)
    return total.mean()
