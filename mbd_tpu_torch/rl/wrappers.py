"""Env wrappers for RL training, brax.training's semantics (port of
``mbd_tpu/rl/wrappers.py``).

 - ``DivergenceGuardWrapper``: a step whose state goes non-finite, or whose
   joint speed passes the engine's divergence threshold, is rolled back to
   the pre-step state with ``done = 1`` and the reward replaced by
   ``divergence_penalty``.
 - ``EpisodeWrapper``: marks ``done`` at ``episode_length`` steps and
   tracks ``truncation``, so that GAE bootstraps through time limits.
 - ``AutoResetWrapper``: when an episode ends, the cached reset state
   replaces the state (no re-randomisation: brax semantics).

JAX vmaps these over the envs; here they take the env's own batch, the
leading axes of its reward (none for one env). car2d, whose step is
analytic and takes a leading batch axis, trains through them; a physics
env trains through ``rl/batched_env.py`` on the rollout kernel, and these
wrappers are its CPU oracle only.
"""

from __future__ import annotations

import dataclasses

import torch

from ..envs.base import State
from ..sim.batched import QD_DIVERGED


def tree_map(fn, *trees):
    """``fn`` over the tensors of matching trees (tensors, dataclasses of
    them, dicts, None)."""
    head = trees[0]
    if head is None:
        return None
    if isinstance(head, torch.Tensor):
        return fn(*trees)
    if isinstance(head, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in head}
    return dataclasses.replace(head, **{
        f.name: tree_map(fn, *(getattr(t, f.name) for t in trees))
        for f in dataclasses.fields(head)})


def tree_leaves(tree):
    out = []
    tree_map(lambda x: out.append(x), tree)
    return out


def _rows(x: torch.Tensor, nb: int) -> torch.Tensor:
    """x with its axes past the first nb (the batch) flattened into one."""
    return x.reshape(x.shape[:nb] + (-1,))


def _where(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """torch.where with mask [batch] broadcast over a's trailing axes."""
    return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() -
                                                         mask.dim())), a, b)


class DivergenceGuardWrapper:
    """Failure detection for RL training: a step that leaves the validity
    envelope is rolled back with ``done = 1`` and the reward
    ``divergence_penalty`` (−10, below every env's per-step floor), so that
    auto-reset swaps in a fresh episode instead of NaNs poisoning the
    replay buffer or the advantages."""

    def __init__(self, env, divergence_penalty: float = -10.0):
        self.env = env
        self.divergence_penalty = divergence_penalty

    def reset(self, generator: torch.Generator) -> State:
        return self.env.reset(generator)

    def step(self, state: State, action: torch.Tensor) -> State:
        nxt = self.env.step(state, action)
        nb = nxt.reward.dim()
        ok = torch.isfinite(_rows(nxt.obs, nb)).all(-1) \
            & torch.isfinite(nxt.reward)
        for leaf in tree_leaves(nxt.pipeline_state):
            ok = ok & torch.isfinite(_rows(leaf, nb)).all(-1)
        qd = getattr(nxt.pipeline_state, "qd", None)
        if qd is not None:
            ok = ok & (_rows(qd, nb).abs().amax(-1) < QD_DIVERGED)
        bad = ~ok
        return nxt.replace(
            pipeline_state=tree_map(lambda p, n: _where(bad, p, n),
                                    state.pipeline_state, nxt.pipeline_state),
            obs=_where(bad, state.obs, nxt.obs),
            reward=torch.where(bad, torch.full_like(
                nxt.reward, self.divergence_penalty), nxt.reward),
            done=torch.where(bad, torch.ones_like(nxt.done), nxt.done))

    def __getattr__(self, name):
        return getattr(self.env, name)


class EpisodeWrapper:
    def __init__(self, env, episode_length: int, action_repeat: int = 1):
        self.env = env
        self.episode_length = episode_length
        self.action_repeat = action_repeat

    def reset(self, generator: torch.Generator) -> State:
        state = self.env.reset(generator)
        metrics = dict(state.metrics)
        metrics["steps"] = torch.zeros_like(state.reward)
        metrics["truncation"] = torch.zeros_like(state.reward)
        return state.replace(metrics=metrics)

    def step(self, state: State, action: torch.Tensor) -> State:
        for _ in range(self.action_repeat):
            state = self.env.step(state, action)
        steps = state.metrics["steps"] + self.action_repeat
        one = torch.ones_like(state.done)
        at_limit = steps >= self.episode_length
        done = torch.where(at_limit, one, state.done)
        truncation = torch.where(at_limit & (state.done == 0), one,
                                 torch.zeros_like(state.done))
        metrics = dict(state.metrics)
        metrics["steps"] = steps
        metrics["truncation"] = truncation
        return state.replace(done=done, metrics=metrics)

    def __getattr__(self, name):
        return getattr(self.env, name)


class AutoResetWrapper:
    """On done, revert to the cached reset state (brax AutoResetWrapper)."""

    def __init__(self, env):
        self.env = env

    def reset(self, generator: torch.Generator) -> State:
        state = self.env.reset(generator)
        metrics = dict(state.metrics)
        metrics["first_pipeline_state"] = state.pipeline_state
        metrics["first_obs"] = state.obs
        return state.replace(metrics=metrics)

    def step(self, state: State, action: torch.Tensor) -> State:
        # clear done before stepping (the step after a reset)
        state = state.replace(done=torch.zeros_like(state.done))
        metrics_in = state.metrics
        state = self.env.step(state, action)
        done = state.done > 0

        def where_done(x, y):
            return _where(done, x, y)

        metrics = dict(state.metrics)
        metrics["steps"] = where_done(torch.zeros_like(metrics["steps"]),
                                      metrics["steps"])
        metrics["first_pipeline_state"] = metrics_in["first_pipeline_state"]
        metrics["first_obs"] = metrics_in["first_obs"]
        return state.replace(
            pipeline_state=tree_map(where_done,
                                    metrics_in["first_pipeline_state"],
                                    state.pipeline_state),
            obs=where_done(metrics_in["first_obs"], state.obs),
            metrics=metrics)

    def __getattr__(self, name):
        return getattr(self.env, name)


def wrap_for_training(env, episode_length: int, action_repeat: int = 1):
    return AutoResetWrapper(EpisodeWrapper(
        DivergenceGuardWrapper(env), episode_length, action_repeat))


def batched_reset(env, generator: torch.Generator, num_envs: int) -> State:
    """``num_envs`` resets of a wrapped env stacked on a leading axis (JAX
    vmaps ``reset`` over split keys; here each reset draws from one
    generator in turn)."""
    states = [env.reset(generator) for _ in range(num_envs)]
    return tree_map(lambda *xs: torch.stack(xs), *states)
