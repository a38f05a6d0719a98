"""SAC trainer (port of ``mbd_tpu/rl/sac.py``, the replacement for
brax.training's SAC that the reference uses for hopper at
mbd/rl/train_brax.py:50-67).

A circular replay buffer resident on the device, twin Q with target
smoothing (τ), and an adaptive temperature with target entropy −0.5·nu.
One training step is one env step of ``num_envs`` envs, the buffer
insert, and ``grad_updates_per_step`` SGD updates, each the critic, the
actor and α in JAX's order (``mbd_tpu/rl/sac.py:162-184``).

JAX's SAC steps its envs through ``vmap(wrapped.step)`` (rl/wrappers.py:
the env's own step, its validity checked after the step). Here a physics
env steps through ``rl/batched_env.py``, one launch of the CUDA rollout
kernel's state-out mode per env step on the card: the wrapped path would
run the plain torch engine there, about 1.5 s a step. The one semantic
difference (ROADMAP.md, Queue 3): the validity check runs on every substep
and clamps qd, where JAX's wrapper checks after the step, which JAX's
``rl/batched_env.py`` calls "strictly at least as sensitive". car2d
steps through the wrappers, as in JAX.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from functools import partial
from typing import Callable, Optional

import torch

from . import networks
from .batched_env import TrainEnv, evaluate


@dataclass
class SACConfig:
    num_timesteps: int = 1_000_000
    num_evals: int = 20
    reward_scaling: float = 1.0
    episode_length: int = 1000
    normalize_observations: bool = True
    action_repeat: int = 1
    discounting: float = 0.99
    learning_rate: float = 6e-4
    num_envs: int = 128
    batch_size: int = 512
    grad_updates_per_step: int = 64
    max_replay_size: int = 1_048_576
    min_replay_size: int = 8192
    tau: float = 0.005
    num_eval_envs: int = 128
    seed: int = 0


class Replay:
    """A circular buffer of transitions on the device; its fill level and
    write position are kept on the host."""

    FIELDS = ("obs", "act", "reward", "next_obs", "discount")

    def __init__(self, cap: int, obs_size: int, act_size: int, device):
        self.obs = torch.zeros((cap, obs_size), device=device)
        self.act = torch.zeros((cap, act_size), device=device)
        self.reward = torch.zeros(cap, device=device)
        self.next_obs = torch.zeros((cap, obs_size), device=device)
        self.discount = torch.zeros(cap, device=device)
        self.cap, self.pos, self.size = cap, 0, 0

    def insert(self, obs, act, reward, next_obs, discount) -> None:
        n = obs.shape[0]
        idx = (self.pos + torch.arange(n, device=obs.device)) % self.cap
        for name, v in zip(self.FIELDS, (obs, act, reward, next_obs,
                                         discount)):
            getattr(self, name)[idx] = v
        self.pos = (self.pos + n) % self.cap
        self.size = min(self.size + n, self.cap)

    def sample(self, idx: torch.Tensor) -> dict:
        """The rows ``idx`` (``Draws.indices(size, batch)``)."""
        return {name: getattr(self, name)[idx] for name in self.FIELDS}


@dataclass
class SACParams:
    policy: networks.PolicyNet
    q: networks.QNet
    q_target: networks.QNet
    log_alpha: torch.Tensor
    obs_stats: networks.RunningStats


def init_params(env, seed: int) -> SACParams:
    """Fresh params on ``env``'s device, drawn on the CPU from ``seed``;
    the target critic a copy of the critic."""
    gen = torch.Generator().manual_seed(seed)
    obs_size, act_size = env.observation_size, env.action_size
    policy = networks.PolicyNet(obs_size, act_size, hidden=(256, 256),
                                generator=gen)
    q = networks.QNet(obs_size, act_size, generator=gen)
    q_target = networks.QNet(obs_size, act_size)
    q_target.load_state_dict(q.state_dict())
    return SACParams(
        policy=policy.to(env.device), q=q.to(env.device),
        q_target=q_target.to(env.device).requires_grad_(False),
        log_alpha=torch.zeros((), device=env.device, requires_grad=True),
        obs_stats=networks.RunningStats.create(obs_size, env.device))


class Learner:
    """The three losses and the SGD step of SAC over ``params``, with one
    Adam each for the actor, the critic and α."""

    def __init__(self, cfg: SACConfig, params: SACParams, act_size: int):
        self.cfg, self.params = cfg, params
        self.target_entropy = -0.5 * act_size
        # one fused kernel per step on the card
        kw = dict(lr=cfg.learning_rate, fused=params.log_alpha.is_cuda)
        self.p_opt = torch.optim.Adam(params.policy.parameters(), **kw)
        self.q_opt = torch.optim.Adam(params.q.parameters(), **kw)
        self.a_opt = torch.optim.Adam([params.log_alpha], **kw)

    def norm(self, obs):
        return networks.make_norm(self.cfg, self.params)(obs)

    def critic_loss(self, batch, noise):
        p, cfg = self.params, self.cfg
        obs_n, next_n = self.norm(batch["obs"]), self.norm(batch["next_obs"])
        with torch.no_grad():
            next_act, next_logp, _ = networks.sample_action(
                *p.policy(next_n), noise)
            q1t, q2t = p.q_target(next_n, next_act)
            target = batch["reward"] + cfg.discounting * batch["discount"] \
                * (torch.minimum(q1t, q2t) - torch.exp(p.log_alpha)
                   * next_logp)
        q1, q2 = p.q(obs_n, batch["act"])
        return 0.5 * ((q1 - target) ** 2 + (q2 - target) ** 2).mean()

    def actor_loss(self, batch, noise):
        """(loss, log-probs of the sampled actions)."""
        p = self.params
        obs_n = self.norm(batch["obs"])
        act, logp, _ = networks.sample_action(*p.policy(obs_n), noise)
        q1, q2 = p.q(obs_n, act)
        alpha = torch.exp(p.log_alpha).detach()
        return (alpha * logp - torch.minimum(q1, q2)).mean(), logp

    def alpha_loss(self, logp):
        return (-torch.exp(self.params.log_alpha)
                * (logp + self.target_entropy).detach()).mean()

    @staticmethod
    def _update(opt, loss, tensors):
        grads = torch.autograd.grad(loss, tensors)
        for t, g in zip(tensors, grads):
            t.grad = g
        opt.step()

    def sgd_step(self, batch, critic_noise, actor_noise) -> dict:
        """One update of the critic, then the actor (against the updated
        critic), then α, then the target critic; the three losses."""
        p = self.params
        c_loss = self.critic_loss(batch, critic_noise)
        self._update(self.q_opt, c_loss, list(p.q.parameters()))
        a_loss, logp = self.actor_loss(batch, actor_noise)
        self._update(self.p_opt, a_loss, list(p.policy.parameters()))
        al_loss = self.alpha_loss(logp.detach())
        self._update(self.a_opt, al_loss, [p.log_alpha])
        with torch.no_grad():
            targets = list(p.q_target.parameters())
            torch._foreach_mul_(targets, 1 - self.cfg.tau)
            torch._foreach_add_(targets, list(p.q.parameters()),
                                alpha=self.cfg.tau)
        return dict(critic_loss=c_loss.detach(), actor_loss=a_loss.detach(),
                    alpha_loss=al_loss.detach())


def train(env, cfg: SACConfig, progress_fn: Optional[Callable] = None,
          params: Optional[SACParams] = None,
          draws: Optional[networks.Draws] = None):
    """Returns (make_inference_fn, params, history), as ``ppo.train``."""
    device = env.device
    act_size = env.action_size
    params = params if params is not None else init_params(env, cfg.seed)
    draws = draws or networks.Draws(
        torch.Generator(device).manual_seed(cfg.seed))
    learner = Learner(cfg, params, act_size)
    tenv = TrainEnv(env, cfg.episode_length, cfg.action_repeat)
    env_state = tenv.reset(draws.generator, cfg.num_envs)
    replay = Replay(cfg.max_replay_size, env.observation_size, act_size,
                    device)

    @torch.no_grad()
    def env_step(env_state):
        obs = tenv.obs(env_state)
        mu, ls = params.policy(learner.norm(obs))
        act, _, _ = networks.sample_action(mu, ls, draws.action(mu.shape))
        env_state, reward, done, trunc = tenv.step(env_state, act)
        replay.insert(obs, act, reward * cfg.reward_scaling,
                      tenv.obs(env_state), 1.0 - done * (1.0 - trunc))
        return env_state, obs

    def training_step(env_state):
        env_state, obs = env_step(env_state)
        if cfg.normalize_observations:
            params.obs_stats = params.obs_stats.update(obs)
        for _ in range(cfg.grad_updates_per_step):
            batch = replay.sample(draws.indices(replay.size, cfg.batch_size))
            losses = learner.sgd_step(
                batch, draws.critic((cfg.batch_size, act_size)),
                draws.actor((cfg.batch_size, act_size)))
        return env_state, losses

    # prefill without gradient updates
    prefill_iters = max(cfg.min_replay_size // cfg.num_envs, 1)
    t0 = time.perf_counter()
    for _ in range(prefill_iters):
        env_state, _ = env_step(env_state)
    prefill_wall = time.perf_counter() - t0

    steps_per_iter = cfg.num_envs * cfg.action_repeat
    num_iters = max((cfg.num_timesteps - prefill_iters * steps_per_iter)
                    // steps_per_iter, 1)
    iters_per_eval = max(num_iters // max(cfg.num_evals, 1), 1)
    history = []
    done = 0
    while done < num_iters:
        t0 = time.perf_counter()
        for _ in range(iters_per_eval):
            env_state, losses = training_step(env_state)
        losses = {k: float(v) for k, v in losses.items()}
        train_wall = time.perf_counter() - t0
        done += iters_per_eval
        t0 = time.perf_counter()
        eval_rew = float(evaluate(
            tenv, networks.make_inference_fn(cfg, params), cfg.num_eval_envs,
            cfg.episode_length // cfg.action_repeat, draws.generator))
        entry = {"num_steps": (prefill_iters + done) * steps_per_iter,
                 "eval/episode_reward": eval_rew,
                 "train/prefill_steps": prefill_iters,
                 "train/prefill_wall_s": prefill_wall,
                 "train/iterations": iters_per_eval,
                 "train/wall_s": train_wall,
                 "eval/wall_s": time.perf_counter() - t0,
                 "train/log_alpha": float(params.log_alpha.detach()),
                 **{f"train/{k}": v for k, v in losses.items()}}
        history.append(entry)
        if progress_fn is not None:
            progress_fn(entry["num_steps"], entry)

    return partial(networks.make_inference_fn, cfg), params, history
