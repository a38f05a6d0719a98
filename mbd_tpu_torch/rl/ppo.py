"""PPO trainer (port of ``mbd_tpu/rl/ppo.py``, itself the replacement for
brax.training's PPO that the reference uses at mbd/rl/train_brax.py).

One training iteration: an unroll of ``unroll_length`` steps of
``num_envs`` persistent auto-reset envs, GAE with truncation
bootstrapping, then ``num_updates_per_batch`` epochs of shuffled
minibatches of the clipped surrogate with the value loss and the entropy
bonus, one ``torch.optim.Adam`` over policy and value together. A physics
env's unroll steps through ``rl/batched_env.py`` (one launch of the CUDA
rollout kernel's state-out mode per step on the card); car2d's through
the wrappers. Every random draw comes from ``draws`` (``networks.Draws``).

Under a ``mesh`` (``parallel.SampleMesh``) each rank steps num_envs / size
of the envs and the unroll's data is gathered onto every rank
(``batched_env.py``). Every rank then draws the same actions, shuffles and
entropy noise from the same generator and runs the same update on the
whole batch, so the parameters stay identical on every rank without a
broadcast, and equal to one process's.
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
class PPOConfig:
    num_timesteps: int = 1_000_000
    num_evals: int = 10
    reward_scaling: float = 1.0
    episode_length: int = 1000
    normalize_observations: bool = True
    action_repeat: int = 1
    unroll_length: int = 5
    num_minibatches: int = 32
    num_updates_per_batch: int = 4
    discounting: float = 0.97
    gae_lambda: float = 0.95
    clip_epsilon: float = 0.3
    learning_rate: float = 3e-4
    entropy_cost: float = 1e-2
    num_envs: int = 2048
    batch_size: int = 2048   # kept for config parity; data is split into
    # num_minibatches equal minibatches per epoch
    num_eval_envs: int = 128
    seed: int = 0


@dataclass
class PPOParams:
    policy: networks.PolicyNet
    value: networks.ValueNet
    obs_stats: networks.RunningStats


def init_params(env, seed: int) -> PPOParams:
    """Fresh params on ``env``'s device, drawn on the CPU from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    obs_size, act_size = env.observation_size, env.action_size
    return PPOParams(
        policy=networks.PolicyNet(obs_size, act_size, generator=gen).to(
            env.device),
        value=networks.ValueNet(obs_size, generator=gen).to(env.device),
        obs_stats=networks.RunningStats.create(obs_size, env.device))


def compute_gae(cfg: PPOConfig, v, v_next, data):
    """Advantages (normalised) and returns [T, B] from the values of the
    unroll's observations and next observations: GAE that bootstraps
    through truncations and does not leak across them."""
    termination = data["done"] * (1.0 - data["truncation"])
    delta = data["reward"] + cfg.discounting * v_next * (1.0 - termination) \
        - v
    gae = torch.zeros_like(delta[0])
    adv = []
    for t in reversed(range(delta.shape[0])):
        gae = delta[t] + cfg.discounting * cfg.gae_lambda \
            * (1.0 - termination[t]) * gae
        gae = gae * (1.0 - data["truncation"][t])
        adv.append(gae)
    adv = torch.stack(adv[::-1])
    returns = adv + v
    adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    return adv, returns


def loss_fn(cfg: PPOConfig, params: PPOParams, batch, noise, norm):
    """(total loss, metrics) of one minibatch: the clipped surrogate, half
    the squared value error, and the entropy bonus (``noise``, the entropy
    estimate's draws)."""
    obs_n = norm(batch["obs"])
    mu, log_sig = params.policy(obs_n)
    logp = networks.log_prob(mu, log_sig, batch["pre"])
    ratio = torch.exp(logp - batch["logp"])
    surr1 = ratio * batch["adv"]
    surr2 = torch.clamp(ratio, 1.0 - cfg.clip_epsilon,
                        1.0 + cfg.clip_epsilon) * batch["adv"]
    policy_loss = -torch.minimum(surr1, surr2).mean()
    v = params.value(obs_n)
    value_loss = 0.5 * ((batch["returns"] - v) ** 2).mean()
    ent = networks.entropy_estimate(mu, log_sig, noise).mean()
    total = policy_loss + value_loss - cfg.entropy_cost * ent
    return total, dict(policy_loss=policy_loss, value_loss=value_loss,
                       entropy=ent)


def train(env, cfg: PPOConfig, progress_fn: Optional[Callable] = None,
          params: Optional[PPOParams] = None,
          draws: Optional[networks.Draws] = None, mesh=None):
    """Returns (make_inference_fn, params, history): one history entry per
    evaluation, with the iterations' mean losses and walls beside JAX's
    two keys.

    ``params`` (default: ``init_params(env, cfg.seed)``) and ``draws``
    (default: a generator on ``env``'s device seeded with ``cfg.seed``)
    are taken as given. ``mesh``: the envs sharded over its ranks, each of
    which calls ``train`` with the same arguments; num_envs must divide
    evenly, and the env must be a physics env."""
    device = env.device
    if mesh is not None:
        mesh.shard(cfg.num_envs, "num_envs")
    tenv = TrainEnv(env, cfg.episode_length, cfg.action_repeat, mesh)
    params = params if params is not None else init_params(env, cfg.seed)
    draws = draws or networks.Draws(
        torch.Generator(device).manual_seed(cfg.seed))
    optimizer = torch.optim.Adam(
        list(params.policy.parameters()) + list(params.value.parameters()),
        lr=cfg.learning_rate, fused=device.type == "cuda")
    env_state = tenv.reset(draws.generator, cfg.num_envs)
    act_size = env.action_size

    @torch.no_grad()
    def rollout(env_state):
        norm = networks.make_norm(cfg, params)
        steps = []
        for _ in range(cfg.unroll_length):
            obs = tenv.obs(env_state)
            mu, log_sig = params.policy(norm(obs))
            act, logp, pre = networks.sample_action(
                mu, log_sig, draws.action(mu.shape))
            env_state, reward, done, trunc = tenv.step(env_state, act)
            steps.append(dict(obs=obs, act=act, logp=logp, pre=pre,
                              reward=reward * cfg.reward_scaling, done=done,
                              truncation=trunc,
                              next_obs=tenv.obs(env_state)))
        return env_state, {k: torch.stack([s[k] for s in steps])
                           for k in steps[0]}

    def training_iteration(env_state):
        env_state, data = rollout(env_state)
        if cfg.normalize_observations:
            params.obs_stats = params.obs_stats.update(data["obs"])
        norm = networks.make_norm(cfg, params)
        with torch.no_grad():
            adv, returns = compute_gae(cfg, params.value(norm(data["obs"])),
                                       params.value(norm(data["next_obs"])),
                                       data)
        flat = {k: v.reshape((-1,) + v.shape[2:]) for k, v in dict(
            obs=data["obs"], logp=data["logp"], pre=data["pre"], adv=adv,
            returns=returns).items()}
        n = cfg.unroll_length * cfg.num_envs
        mb_size = n // cfg.num_minibatches
        aux = []
        for _ in range(cfg.num_updates_per_batch):
            perm = draws.permutation(n)
            shuf = {k: v[perm] for k, v in flat.items()}
            for i in range(cfg.num_minibatches):
                mb = {k: v[i * mb_size:(i + 1) * mb_size]
                      for k, v in shuf.items()}
                total, metrics = loss_fn(cfg, params, mb,
                                         draws.entropy((mb_size, act_size)),
                                         norm)
                optimizer.zero_grad()
                total.backward()
                optimizer.step()
                aux.append({k: v.detach() for k, v in metrics.items()})
        metrics = {k: torch.stack([m[k] for m in aux]).mean()
                   for k in aux[0]}
        metrics["mean_return"] = flat["returns"].mean()
        return env_state, metrics

    steps_per_iter = cfg.num_envs * cfg.unroll_length * cfg.action_repeat
    num_iters = max(cfg.num_timesteps // steps_per_iter, 1)
    iters_per_eval = max(num_iters // max(cfg.num_evals, 1), 1)
    history = []
    done_iters = 0
    while done_iters < num_iters:
        t0 = time.perf_counter()
        for _ in range(iters_per_eval):
            env_state, metrics = training_iteration(env_state)
        metrics = {k: float(v) for k, v in metrics.items()}
        train_wall = time.perf_counter() - t0
        done_iters += iters_per_eval
        t0 = time.perf_counter()
        eval_rew = float(evaluate(
            tenv, networks.make_inference_fn(cfg, params), cfg.num_eval_envs,
            cfg.episode_length // cfg.action_repeat, draws.generator))
        entry = {"num_steps": done_iters * steps_per_iter,
                 "eval/episode_reward": eval_rew,
                 "train/iterations": iters_per_eval,
                 "train/wall_s": train_wall,
                 "eval/wall_s": time.perf_counter() - t0,
                 **{f"train/{k}": v for k, v in metrics.items()}}
        history.append(entry)
        if progress_fn is not None:
            progress_fn(entry["num_steps"], entry)

    return partial(networks.make_inference_fn, cfg), params, history
