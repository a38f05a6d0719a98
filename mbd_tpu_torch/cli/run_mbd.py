"""CLI entry point: run a planner on an env and write artifacts (port of
``mbd_tpu/cli/run_mbd.py``, with the same flags and modes).

  python -m mbd_tpu_torch.cli.run_mbd --env_name hopper              # MBD
  python -m mbd_tpu_torch.cli.run_mbd --env_name ant \
      --algo path_integral --update_method mppi
  python -m mbd_tpu_torch.cli.run_mbd --env_name humanoidtrack --enable_demo
  python -m mbd_tpu_torch.cli.run_mbd --env_name hopper --mode seed \
      --batch_seeds                                                  # 8 seeds
  python -m mbd_tpu_torch.cli.run_mbd --env_name hopper --mode temp  # sweep

``single`` writes <results_dir>/<env_name>/mu_0ts.npy (the stack of
denoised means) and rollout.html (the final plan in the viewer; for
car2d rollout.png, drawn with matplotlib, which only this needs);
``seed`` plans --n_seeds seeds, serially or with --batch_seeds in one
batch; ``temp`` plans the seeds at six temperatures, one batch each, into
<results_dir>/RESULTS_TEMP.json.

It runs on the CUDA card (--device cuda, the default: it raises without a
card) or on the CPU (--device cpu). Each device has one engine: the CUDA
rollout kernel on the card, the plain torch engine on the CPU. Times are
taken after the device has finished.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

TEMPS = (0.01, 0.05, 0.1, 0.2, 0.4, 0.8)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--env_name", default="ant")
    p.add_argument("--algo", default="mbd", choices=["mbd", "path_integral"])
    p.add_argument("--mode", default="single",
                   choices=["single", "seed", "temp"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--n_seeds", type=int, default=8)
    p.add_argument("--disable_recommended_params", action="store_true")
    p.add_argument("--not_render", action="store_true",
                   help="single mode: write no artifacts")
    p.add_argument("--Nsample", type=int, default=2048)
    p.add_argument("--Hsample", type=int, default=50)
    p.add_argument("--Ndiffuse", type=int, default=100)
    p.add_argument("--temp_sample", type=float, default=0.1)
    p.add_argument("--beta0", type=float, default=1e-4)
    p.add_argument("--betaT", type=float, default=1e-2)
    p.add_argument("--enable_demo", action="store_true")
    p.add_argument("--update_method", default="mppi",
                   choices=["mppi", "cma-es", "cem"])
    p.add_argument("--chunk_size", type=int, default=10,
                   help="MBD: report progress every this many denoise "
                        "steps (0 = no report)")
    p.add_argument("--batch_seeds", action="store_true",
                   help="seed mode: plan all seeds in one batch "
                        "(plan_batch) instead of serially")
    p.add_argument("--results_dir", default="results")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the default; raises without a card) runs "
                        "every rollout in the CUDA kernel, 'cpu' in the "
                        "plain torch engine; there is no other engine")
    return p


def _make_cfg(args):
    from ..planners import mbd, path_integral

    if args.algo == "mbd":
        cfg = mbd.MBDConfig(
            Nsample=args.Nsample, Hsample=args.Hsample,
            Ndiffuse=args.Ndiffuse, temp_sample=args.temp_sample,
            beta0=args.beta0, betaT=args.betaT,
            enable_demo=args.enable_demo)
        if not args.disable_recommended_params:
            cfg = mbd.recommended_config(args.env_name, cfg)
            print(f"override temp_sample to {cfg.temp_sample}")
        return cfg
    cfg = path_integral.PathIntegralConfig(
        update_method=args.update_method, Nsample=args.Nsample,
        Hsample=args.Hsample, Nrefine=args.Ndiffuse,
        temp_sample=args.temp_sample)
    if not args.disable_recommended_params:
        cfg = path_integral.recommended_config(args.env_name, cfg)
        print(f"override temp_sample to {cfg.temp_sample}")
    return cfg


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _plans(res) -> torch.Tensor:
    return res.Ybars if hasattr(res, "Ybars") else res.mu_0ts


def run_single(args, render: bool = True) -> float:
    from .. import envs
    from ..planners import mbd, path_integral
    from ..rollout.rollout import rollout_states

    env = envs.get_env(args.env_name, device=args.device)
    cfg = _make_cfg(args)
    gen = torch.Generator(env.device).manual_seed(args.seed)
    state_init = env.reset(gen)          # what the planner draws first

    if args.algo == "mbd":
        def progress(step, rew):
            print(f"  denoise step {step}/{cfg.Ndiffuse}: rew {rew:.3e}",
                  flush=True)
        res = mbd.plan(env, cfg, gen, state_init=state_init,
                       chunk_size=args.chunk_size, progress_fn=progress)
    else:
        res = path_integral.plan(env, cfg, gen, state_init=state_init)
    if res.final_diverged:
        print("WARNING: final plan flagged DIVERGED by the engine's "
              "validity envelope — the reward below is not an earned "
              "number", flush=True)

    if render:
        path = os.path.join(args.results_dir, args.env_name)
        os.makedirs(path, exist_ok=True)
        Ybars = _plans(res)
        np.save(os.path.join(path, "mu_0ts.npy"), Ybars.cpu().numpy())
        states = rollout_states(env, state_init, Ybars[-1])
        if args.env_name == "car2d":
            render_car2d(env, state_init, states, args.enable_demo,
                         os.path.join(path, "rollout.png"))
        else:
            from ..viz import html as vhtml

            page = vhtml.render_states(env.sys, states, dt=env.dt,
                                       title=f"{args.env_name} ({args.algo})")
            with open(os.path.join(path, "rollout.html"), "w") as f:
                f.write(page)
    return float(res.final_reward)


def render_car2d(env, state_init, states, show_demo: bool, out: str) -> None:
    """car2d's plan from its start, ``states`` [H, 3], drawn by
    ``env.render`` into the PNG ``out`` (matplotlib, imported here only)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(1, 1, figsize=(4, 4))
    xs = torch.cat([state_init.pipeline_state[None], states]).cpu().numpy()
    env.render(ax, xs, show_demo=show_demo)
    fig.savefig(out, dpi=120, bbox_inches="tight")
    plt.close(fig)


def plan_seeds(args, cfg, env):
    """--n_seeds seeds from 0 on, in one batch; (final rewards [S],
    diverged [S], final plans [S, H, nu]) on the host."""
    from ..planners import mbd, path_integral

    gens = [torch.Generator(env.device).manual_seed(s)
            for s in range(args.n_seeds)]
    if args.algo == "mbd":
        def progress(step, rew):
            print(f"  denoise step {step}/{cfg.Ndiffuse}: rew {rew:.3e} "
                  f"(mean over {args.n_seeds} seeds)", flush=True)
        res = mbd.plan_batch(env, cfg, gens, chunk_size=args.chunk_size,
                             progress_fn=progress)
    else:
        res = path_integral.plan_batch(env, cfg, gens)
    return (res.final_reward.cpu().numpy(), res.final_diverged.cpu().numpy(),
            _plans(res)[:, -1].cpu().numpy())


def run_multiple_seed(args) -> dict:
    """The multi-seed harness (reference run_mbd.py:17-39); with
    ``--batch_seeds`` every seed in one batch. Returns the seeds' rewards
    and wall seconds, and from the batch their flags and final plans."""
    if args.batch_seeds:
        from .. import envs

        env = envs.get_env(args.env_name, device=args.device)
        cfg = _make_cfg(args)
        _sync(args.device)
        t0 = time.perf_counter()
        rews, divs, plans = plan_seeds(args, cfg, env)
        _sync(args.device)
        wall = time.perf_counter() - t0
        for seed, (rew, dv) in enumerate(zip(rews, divs)):
            tag = "  [DIVERGED]" if dv else ""
            print(f"seed {seed}: rew={rew:.3f}{tag}", flush=True)
        print(f"rew: {np.mean(rews):.3f} ± {np.std(rews):.3f}"
              + (f"  ({int(divs.sum())} diverged)" if divs.any() else ""))
        print(f"time: {wall:.1f} s total (batched over "
              f"{args.n_seeds} seeds)")
        return dict(rewards=rews.tolist(), diverged=divs.tolist(),
                    wall_s=wall, plans=plans)
    rews, divs, times = [], [], []
    for seed in range(args.n_seeds):
        args.seed = seed
        _sync(args.device)
        t0 = time.perf_counter()
        rew = run_single(args, render=False)
        _sync(args.device)
        dt = time.perf_counter() - t0
        rews.append(rew)
        times.append(dt)
        print(f"seed {seed}: rew={rew:.3f} time={dt:.1f}s", flush=True)
    print(f"rew: {np.mean(rews):.3f} ± {np.std(rews):.3f}")
    print(f"time: {np.mean(times):.1f} ± {np.std(times):.1f} s")
    return dict(rewards=rews, wall_s=sum(times))


def run_multiple_temp(args) -> str:
    """Temperature sweep (reference run_mbd.py:42-64): each temperature
    plans ``--n_seeds`` seeds in one batch, so the sweep reports mean ±
    std per temperature. Merged by env into
    <results_dir>/RESULTS_TEMP.json; returns its path."""
    from .. import envs

    args.disable_recommended_params = True
    env = envs.get_env(args.env_name, device=args.device)
    results = {}
    for t in TEMPS:
        args.temp_sample = t
        rews, divs, _ = plan_seeds(args, _make_cfg(args), env)
        results[t] = {
            "rew_mean": float(np.mean(rews)),
            "rew_std": float(np.std(rews)),
            "rewards": [round(float(r), 4) for r in rews],
            "diverged": [bool(d) for d in divs],
        }
        print(f"temp {t}: rew={np.mean(rews):.3f} ± {np.std(rews):.3f}"
              + (f" ({int(divs.sum())} diverged)" if divs.any() else ""),
              flush=True)
    best = max(results, key=lambda t: results[t]["rew_mean"])
    print(f"best temp: {best} (rew={results[best]['rew_mean']:.3f})")

    out = os.path.join(args.results_dir, "RESULTS_TEMP.json")
    table = {}
    if os.path.exists(out):
        with open(out) as f:
            table = json.load(f)
    table[args.env_name] = {
        "sweep": {str(t): r for t, r in results.items()},
        "best_temp": best,
        "best_reward": results[best]["rew_mean"],
        "n_seeds": args.n_seeds,
        "backend": (torch.cuda.get_device_name(env.device)
                    if env.device.type == "cuda" else "cpu"),
        "algo": args.algo if args.algo == "mbd" else args.update_method,
        "config": dict(Nsample=args.Nsample, Hsample=args.Hsample,
                       Ndiffuse=args.Ndiffuse),
    }
    os.makedirs(args.results_dir, exist_ok=True)
    with open(out, "w") as f:
        json.dump(table, f, indent=2)
    print(f"wrote {out}")
    return out


def main(argv=None):
    from ..device import resolve

    args = build_parser().parse_args(argv)
    resolve(args.device)
    if args.mode == "single":
        rew = run_single(args, render=not args.not_render)
        print(f"final reward = {rew:.2e}")
        return rew
    if args.mode == "seed":
        return run_multiple_seed(args)
    return run_multiple_temp(args)


if __name__ == "__main__":
    main()
