"""The denoising process in the viewer (port of
``mbd_tpu/cli/vis_diffusion.py``, with the same flags and ``--device``).

Loads the stack of denoised means a single run saved
(<results_dir>/<env_name>/mu_0ts.npy, from ``run_mbd --mode single``),
re-simulates ``--n_ghosts`` + 1 of the iterates from the run's reset, and
writes render_diffusion.html beside it: the last of them, with the
earlier ones as translucent ghosts.

  python -m mbd_tpu_torch.cli.vis_diffusion --env_name humanoidtrack

The reset is the one ``run_mbd --mode single --seed S`` plans from
(``torch.Generator(device).manual_seed(S)``, then ``env.reset``). Each
iterate is one rollout with the position trace: on the card (--device
cuda, the default) one launch of the rollout kernel's ``need_qs`` mode,
on the CPU (--device cpu) the plain torch engine. Physics envs only: the
viewer draws a model's geoms.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def iterates(T: int, n_ghosts: int) -> np.ndarray:
    """The indices of the iterates drawn, as JAX picks them: n_ghosts + 1
    spread over 0 … T − 1, the last one last."""
    return np.linspace(0, T - 1, n_ghosts + 1).astype(int)


def main(argv=None) -> str:
    p = argparse.ArgumentParser()
    p.add_argument("--env_name", default="humanoidtrack")
    p.add_argument("--results_dir", default="results")
    p.add_argument("--n_ghosts", type=int, default=6,
                   help="number of intermediate denoise iterates to overlay")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the default; raises without a card) or "
                        "'cpu'")
    args = p.parse_args(argv)

    import torch

    from .. import envs
    from ..rollout.rollout import rollout_states
    from ..viz import html as vhtml

    path = os.path.join(args.results_dir, args.env_name)
    mu_0ts = np.load(os.path.join(path, "mu_0ts.npy"))
    print(f"loaded mu_0ts {mu_0ts.shape}")

    env = envs.get_env(args.env_name, device=args.device)
    state_init = env.reset(torch.Generator(env.device).manual_seed(args.seed))
    trajs = []
    for i in iterates(mu_0ts.shape[0], args.n_ghosts):
        states = rollout_states(env, state_init,
                                torch.from_numpy(mu_0ts[i]).to(env.device))
        trajs.append((states.x.pos.cpu().numpy(),
                      states.x.rot.cpu().numpy()))
        print(f"re-simulated iterate {i}", flush=True)

    final_pos, final_rot = trajs[-1]
    page = vhtml.render(env.sys, final_pos, final_rot, dt=env.dt,
                        ghost_trajs=trajs[:-1],
                        title=f"{args.env_name} denoising process")
    out = os.path.join(path, "render_diffusion.html")
    with open(out, "w") as f:
        f.write(page)
    print(f"wrote {out}")
    return out


if __name__ == "__main__":
    main()
