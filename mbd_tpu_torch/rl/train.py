"""RL baseline training CLI (port of ``mbd_tpu/rl/train.py``; reference:
mbd/rl/train_brax.py).

  python -m mbd_tpu_torch.rl.train --env_name pushT         # PPO
  python -m mbd_tpu_torch.rl.train --env_name hopper        # SAC
  python -m mbd_tpu_torch.rl.train --env_name car2d --device cpu \\
      --scale 0.001 --not_render                            # on the CPU

The per-env hyperparameters are JAX's table as it is. ``--scale``
multiplies num_timesteps (and floors num_evals at 1). After training the
params go to ``<results_dir>/<env>/params_torch.npz`` (flax's key paths,
``networks.save_npz``), the policy is evaluated over 8 reset seeds × 50
steps (40 for pushT) with deterministic actions, all 8 seeds as one batch
(one launch of the rollout kernel's state-out mode per step on the card),
the learning curve and the eval go to ``--out`` (default
``<results_dir>/RESULTS_RL_torch.json``), and seed 0's rollout is rendered
to ``<results_dir>/<env>/RL_torch.html``. ``--eval_only`` loads
``params_torch.npz`` and runs the eval (and the render) alone. It runs on
the CUDA card (``--device cuda``, the default) or on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from . import networks, ppo, sac
from .batched_env import BatchedTrainEnv

# The reference's hyperparameters, train_brax.py:31-176 (as in
# mbd_tpu/rl/train.py:31-97; the reference's "pusher" config cannot run
# there and is left out there too).
PPO_CONFIGS = {
    "ant": dict(num_timesteps=100_000_000, num_evals=10, reward_scaling=10,
                episode_length=1000, normalize_observations=True,
                action_repeat=1, unroll_length=5, num_minibatches=32,
                num_updates_per_batch=4, discounting=0.97,
                learning_rate=3e-4, entropy_cost=1e-2, num_envs=4096,
                batch_size=2048, seed=0),
    "walker2d": dict(num_timesteps=50_000_000, num_evals=20,
                     reward_scaling=1, episode_length=1000,
                     normalize_observations=True, action_repeat=1,
                     unroll_length=20, num_minibatches=32,
                     num_updates_per_batch=8, discounting=0.95,
                     learning_rate=3e-4, entropy_cost=0.001, num_envs=2048,
                     batch_size=512, seed=3),
    "halfcheetah": dict(num_timesteps=50_000_000, num_evals=20,
                        reward_scaling=1, episode_length=1000,
                        normalize_observations=True, action_repeat=1,
                        unroll_length=20, num_minibatches=32,
                        num_updates_per_batch=8, discounting=0.95,
                        learning_rate=3e-4, entropy_cost=0.001,
                        num_envs=2048, batch_size=512, seed=3),
    "pushT": dict(num_timesteps=100_000_000, num_evals=10,
                  reward_scaling=1.0, episode_length=100,
                  normalize_observations=True, action_repeat=1,
                  unroll_length=20, num_minibatches=16,
                  num_updates_per_batch=8, discounting=0.99,
                  learning_rate=3e-4, entropy_cost=1e-2, num_envs=2048,
                  batch_size=1024, seed=2),
    "humanoidrun": dict(num_timesteps=100_000_000, num_evals=10,
                        reward_scaling=0.1, episode_length=100,
                        normalize_observations=True, action_repeat=1,
                        unroll_length=10, num_minibatches=32,
                        num_updates_per_batch=8, discounting=0.97,
                        learning_rate=3e-4, entropy_cost=1e-3,
                        num_envs=2048, batch_size=1024, seed=1),
    "humanoidstandup": dict(num_timesteps=100_000_000, num_evals=20,
                            reward_scaling=0.1, episode_length=1000,
                            normalize_observations=True, action_repeat=1,
                            unroll_length=15, num_minibatches=32,
                            num_updates_per_batch=8, discounting=0.97,
                            learning_rate=6e-4, entropy_cost=1e-2,
                            num_envs=2048, batch_size=1024, seed=1),
}

SAC_CONFIGS = {
    "hopper": dict(num_timesteps=6_553_600, num_evals=20,
                   reward_scaling=30, episode_length=1000,
                   normalize_observations=True, action_repeat=1,
                   discounting=0.997, learning_rate=6e-4, num_envs=128,
                   batch_size=512, grad_updates_per_step=64,
                   max_replay_size=1_048_576, min_replay_size=8192, seed=1),
}

# The port's one addition: car2d, which the reference's table lacks, with
# the smoke config of JAX's tests/test_rl.py, so that the CLI trains on the
# CPU in a minute.
CAR2D_CONFIG = dict(num_timesteps=40_000, num_evals=2, episode_length=50,
                    num_envs=64, unroll_length=10, num_minibatches=4,
                    num_updates_per_batch=2, num_eval_envs=16, seed=0)

N_EVAL_SEEDS = 8
# JAX's trained hopper SAC policy (results/hopper/params.msgpack) as the
# port's params file, with JAX's eval resets and per-seed eval rewards
# (written by ``PYTHONPATH=. python tests/test_torch_rl.py --convert``)
HOPPER_SAC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets", "hopper_sac.npz")


def eval_steps(env_name: str) -> int:
    return 40 if env_name == "pushT" else 50


def evaluate_seeds(env, inference, q0: torch.Tensor, qd0: torch.Tensor,
                   n_steps: int):
    """The post-train eval (JAX: mbd_tpu/rl/train.py:178-194): each reset
    (q0 [nq, S], qd0 [nv, S], one per seed) stepped ``n_steps`` times under
    the divergence guard with the policy's deterministic actions, all S as
    one batch. (mean step reward [S], the position trace [n_steps, nq, S])."""
    benv = BatchedTrainEnv(env, n_steps + 1)
    q, qd = q0.contiguous(), qd0.contiguous()
    rews, qs = [], []
    for _ in range(n_steps):
        u = inference(env.obs_qs_b(q, qd).t())
        q, qd, reward, _ = benv.guarded_step(q, qd, u.t().contiguous())
        rews.append(reward)
        qs.append(q)
    return torch.stack(rews).mean(0), torch.stack(qs)


def seed_resets(env, seeds):
    """q [nq, S], qd [nv, S] of ``env.reset`` from a generator seeded with
    each seed."""
    states = [env.reset_q(torch.Generator(env.device).manual_seed(s))
              for s in seeds]
    return (torch.stack([q for q, _ in states], 1),
            torch.stack([qd for _, qd in states], 1))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--env_name", default="ant")
    p.add_argument("--scale", type=float, default=1.0,
                   help="multiply num_timesteps (for smoke runs)")
    p.add_argument("--num_evals", type=int, default=0,
                   help="override the eval count (0 = scale the "
                        "reference's)")
    p.add_argument("--results_dir", default="results")
    p.add_argument("--not_render", action="store_true")
    p.add_argument("--out", default=None,
                   help="the learning curve and eval record (default "
                        "<results_dir>/RESULTS_RL_torch.json; '' = skip)")
    p.add_argument("--eval_only", action="store_true",
                   help="skip training: load <results_dir>/<env>/"
                        "params_torch.npz, rerun the eval (and the render) "
                        "and update only the eval fields in --out")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)

    from .. import envs
    from ..device import resolve

    device = resolve(args.device)
    env = envs.get_env(args.env_name, device=device)
    if args.env_name in SAC_CONFIGS:
        algo, module = "sac", sac
        hp = dict(SAC_CONFIGS[args.env_name])
        hp["num_timesteps"] = max(int(hp["num_timesteps"] * args.scale),
                                  hp["min_replay_size"] * 2)
        cfg_cls = sac.SACConfig
    elif args.env_name in PPO_CONFIGS:
        algo, module = "ppo", ppo
        hp = dict(PPO_CONFIGS[args.env_name])
        hp["num_timesteps"] = int(hp["num_timesteps"] * args.scale)
        cfg_cls = ppo.PPOConfig
    elif args.env_name == "car2d":
        algo, module = "ppo", ppo
        hp = dict(CAR2D_CONFIG)
        hp["num_timesteps"] = int(hp["num_timesteps"] * args.scale)
        cfg_cls = ppo.PPOConfig
    else:
        raise ValueError(f"no RL config for env {args.env_name}")
    hp["num_evals"] = args.num_evals or max(1, int(hp["num_evals"] *
                                                   args.scale))
    cfg = cfg_cls(**hp)

    def progress(num_steps, metrics):
        print(f"step: {num_steps}, episode return: "
              f"{metrics['eval/episode_reward']:.2f}", flush=True)

    path = os.path.join(args.results_dir, args.env_name)
    os.makedirs(path, exist_ok=True)
    params_path = os.path.join(path, "params_torch.npz")
    history, train_wall_s = [], 0.0
    params = module.init_params(env, cfg.seed)
    if args.eval_only:
        networks.load_tree(params, networks.load_npz(params_path))
    else:
        t0 = time.perf_counter()
        _, params, history = module.train(env, cfg, progress, params=params)
        train_wall_s = time.perf_counter() - t0
        networks.save_npz(params_path, networks.to_tree(params))
    inference = networks.make_inference_fn(cfg, params)

    n_steps = eval_steps(args.env_name)
    record = {"algo": algo, "scale": args.scale,
              "num_timesteps": hp["num_timesteps"],
              "learning_curve": [{"num_steps": h["num_steps"],
                                  "eval_reward": h["eval/episode_reward"]}
                                 for h in history],
              "history": history,
              "backend": device.type, "train_wall_s": train_wall_s,
              "rollout": "batch_last" if hasattr(env, "obs_qs_b")
              else "wrapped"}
    if hasattr(env, "obs_qs_b"):
        q0, qd0 = seed_resets(env, range(N_EVAL_SEEDS))
        rews, qs = evaluate_seeds(env, inference, q0, qd0, n_steps)
        rews = rews.cpu().numpy().astype(float)
        record.update(eval_mean=float(np.mean(rews)),
                      eval_std=float(np.std(rews)),
                      eval_per_seed=rews.tolist(),
                      eval_protocol=f"{N_EVAL_SEEDS} seeds x {n_steps} "
                                    "steps, mean step reward")
        print(f"eval ({N_EVAL_SEEDS} seeds x {n_steps} steps): "
              f"{np.mean(rews):.3f} ± {np.std(rews):.3f}", flush=True)
        if not args.not_render:
            from ..rollout.fused import states_from_qs
            from ..viz import html as vhtml

            states = states_from_qs(env.sys, qs[:, :, :1])
            page = vhtml.render(env.sys, states.x.pos[:, 0],
                                states.x.rot[:, 0], dt=env.dt,
                                title=f"{args.env_name} RL policy")
            with open(os.path.join(path, "RL_torch.html"), "w") as f:
                f.write(page)

    out = os.path.join(args.results_dir, "RESULTS_RL_torch.json") \
        if args.out is None else args.out
    if out:
        table = {}
        if os.path.exists(out):
            with open(out) as f:
                table = json.load(f)
        if args.eval_only and args.env_name in table:
            # keep the real run's curve and budget; refresh only the eval
            record = dict(table[args.env_name], **{
                k: v for k, v in record.items() if k.startswith("eval")})
        table[args.env_name] = record
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as f:
            json.dump(table, f, indent=2)
        print(f"wrote {out}")
    return record


if __name__ == "__main__":
    main()
