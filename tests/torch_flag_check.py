"""The humanoids' validity flags on the last reverse step of three humanoid
plans, held sample by sample against the reference's engine.

    # on the card: plan each cell at seed 0, rebuild its last step
    # (last_step) and find each sample's first flagged substep
    # (replay.first_flags), its flags held against the kernel's and the
    # parity of the kernel with the plain engine (parity); one JSON line a
    # cell; the fixture of flagged and clean states written to OUT
    # (replay.FLAG_STATES by default)
    python tests/torch_flag_check.py --card [--out OUT]
    # on the CPU: one eager JAX substep from every fixture state, batched
    # per model, against the card's verdict (about 25 s)
    PYTHONPATH=. python tests/torch_flag_check.py --jax
    # on the CPU: 32 samples around JAX's committed humanoidrun plan of
    # seed 0 at the last step's sigma, through the port's plain engine and
    # eager JAX substep by substep (about 17 min); --out writes the table
    PYTHONPATH=. python tests/torch_flag_check.py --jax_rollout [--out F]

``--card`` imports no JAX; ``--jax`` and ``--jax_rollout`` import the JAX
package and run it on the CPU only, under ``jax.disable_jit()``: no
humanoid engine is ever compiled on JAX's CPU backend. Not collected by
pytest; ``tests/test_torch_flags.py`` pins the fixture.
"""

import argparse
import json
import os
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from mbd_tpu_torch import envs  # noqa: E402
from mbd_tpu_torch.rollout import replay  # noqa: E402
from mbd_tpu_torch.sim import batched as BT  # noqa: E402

# the cells: humanoidrun at its flagship config and at the JAX bench's
# north star of 1024 samples, and humanoidtrack with the demo; and the cell
# each model's fixture comes from
CELLS = ("humanoidrun", "humanoidrun_n1024", "humanoidtrack_demo")
FIXTURE_CELLS = {"humanoidrun": "humanoidrun",
                 "humanoidtrack": "humanoidtrack_demo"}
# fixture states a model: flagged (half each check where there are as
# many, spread over the first flags' order) and clean (half at their
# largest |qd|, half at their lowest root)
N_FLAGGED, N_CLEAN = 24, 8
# Card against the CPU after one substep from the same state: |qd| may
# differ by 0.2 (0.152 measured at |qd| = 106, tests/test_torch_replay.py)
# and the root's height by 1e-4 m. A state whose card margin lies within
# these of 0 is an edge state: reported, not judged.
QD_TOL, ROOT_TOL = 0.2, 1e-4
# --jax_rollout: samples, and the seed of their noise
ROLLOUT_SAMPLES, ROLLOUT_SEED = 32, 0


def substep_margins(sys, q, qd, u):
    """One substep of the port's plain engine from q [nq, B], qd [nv, B]
    under u [nu, B]: each check's margin after it, float64 [B] on the host
    (``replay.margins``)."""
    hs = sys.cached("height_sensors", lambda: BT.height_sensors(sys))
    q1, qd1 = BT.substep_b(sys, q, qd, u)
    low = torch.full_like(q1[0], float("inf"))
    zmin = None
    if hs is not None:
        zmin = BT.f32(hs[1] - BT.ROOT_SINK_TOL)
        for qadr, off in hs[0]:
            low = torch.minimum(low, q1[qadr] + BT.f32(off))
    return replay.margins(zmin, qd1.abs().amax(dim=0), low)


def jax_margins(model, q, qd, u):
    """The same from one eager substep of the JAX engine
    (``mbd_tpu.sim.batched.substep_b`` under ``jax.disable_jit()``, the
    model from ``mbd_tpu.envs.physics.asset_path``), its checks as its
    ``env_step_checked_b`` reads them: [B] float64 each."""
    import jax

    from mbd_tpu.envs.physics import asset_path
    from mbd_tpu.sim import batched as JB
    from mbd_tpu.sim.system import load_mjcf

    sys = load_mjcf(asset_path(f"{model}.xml"))
    with jax.disable_jit():
        q1, qd1 = JB.substep_b(sys, q, qd, u)
    q1, qd1 = np.asarray(q1), np.asarray(qd1)
    sensors, floor_z = JB._height_sensors(sys)
    # a Python float against a float32 array compares in float32
    zmin = float(np.float32(floor_z - JB.ROOT_SINK_TOL))
    low = np.min([q1[qadr] + np.float32(off) for qadr, off in sensors],
                 axis=0)
    return replay.margins(zmin, np.abs(qd1).max(axis=0), low)


def judge(card, got):
    """The card's margins (qd, root) against another engine's from the same
    states: (edge [B], agree [B]). A state agrees when each check trips in
    both or in neither and each margin is within its tolerance of the
    card's."""
    (cq, cr), (gq, gr) = card, got
    edge = (np.abs(cq) <= QD_TOL) | (np.abs(cr) <= ROOT_TOL)
    agree = ((cq > 0) == (gq > 0)) & ((cr > 0) == (gr > 0)) \
        & (np.abs(gq - cq) <= QD_TOL) & (np.abs(gr - cr) <= ROOT_TOL)
    return edge, agree


def fixture(model):
    """The fixture's arrays of ``model``: {name: array}, states [B, k]."""
    with np.load(replay.FLAG_STATES) as d:
        return {k.split("/", 1)[1]: d[k] for k in d.files
                if k.startswith(f"{model}/")}


def pick(order, k):
    """``k`` of the indices ``order``, spread evenly over it."""
    if len(order) <= k:
        return list(order)
    return [order[i] for i in np.linspace(0, len(order) - 1, k).round()
            .astype(int)]


def fixture_states(env, rec):
    """The fixture's states of one cell's ``first_flags`` record (taken
    with ``states``): ``N_FLAGGED`` flagged samples' states before their
    first flagged substep, spread over both checks and over early and late
    first flags, and ``N_CLEAN`` clean samples' states before their
    closest approach (half at the largest |qd|, half at the lowest root),
    each with the card's margins after one substep from it."""
    first = rec.first.cpu().numpy()
    root = rec.root.cpu().numpy()
    by_first = np.argsort(first, kind="stable")
    flagged = {c: [n for n in by_first if first[n] >= 0 and root[n] == r]
               for c, r in (("qd", False), ("root", True))}
    n_root = min(len(flagged["root"]),
                 max(N_FLAGGED // 2, N_FLAGGED - len(flagged["qd"])))
    picks = [(n, "flag", "qd") for n in pick(flagged["qd"],
                                             N_FLAGGED - n_root)]
    picks += [(n, "flag", "root") for n in pick(flagged["root"], n_root)]
    clean = np.flatnonzero(first < 0)
    peak = clean[np.argsort(-rec.peak.cpu().numpy()[clean],
                            kind="stable")]
    lowest = clean[np.argsort(rec.lowest.cpu().numpy()[clean],
                              kind="stable")]
    picks += [(n, "peak", "qd") for n in peak[:N_CLEAN // 2]]
    picks += [(n, "lowest", "root") for n in lowest[:N_CLEAN - N_CLEAN // 2]
              if n not in peak[:N_CLEAN // 2]]
    at = {"flag": rec.first, "peak": rec.peak_at, "lowest": rec.lowest_at}
    cols = [[rec.pre[kind][i][:, n] for n, kind, _ in picks]
            for i in range(3)]
    q, qd, u = (torch.stack(c, dim=1) for c in cols)
    qd_margin, root_margin = substep_margins(env.sys, q, qd, u)
    # the one substep reads each state's check as the record read it
    read = {("flag", "qd"): rec.speed, ("flag", "root"): rec.low,
            ("peak", "qd"): rec.peak, ("lowest", "root"): rec.lowest}
    same = all(
        replay.margins(rec.zmin, read[kind, c][n], read[kind, c][n])[
            1 if c == "root" else 0]
        == (root_margin if c == "root" else qd_margin)[j]
        for j, (n, kind, c) in enumerate(picks))
    return dict(
        q=q.T.cpu().numpy(), qd=qd.T.cpu().numpy(), u=u.T.cpu().numpy(),
        sample=np.array([n for n, _, _ in picks]),
        flagged=np.array([kind == "flag" for _, kind, _ in picks]),
        check=np.array([c for _, _, c in picks]),
        substep=np.array([int(at[kind][n]) for n, kind, _ in picks]),
        qd_margin=qd_margin, root_margin=root_margin), same


def cell_configs():
    """The cells' models and configs: {cell: (model, MBDConfig)}."""
    from mbd_tpu_torch.planners import mbd

    return {
        "humanoidrun": ("humanoidrun", mbd.recommended_config("humanoidrun")),
        "humanoidrun_n1024": ("humanoidrun", mbd.MBDConfig(
            Nsample=1024, Hsample=50, Ndiffuse=300, temp_sample=0.1)),
        "humanoidtrack_demo": ("humanoidtrack", mbd.recommended_config(
            "humanoidtrack", mbd.MBDConfig(enable_demo=True))),
    }


def last_step_samples(env, cfg, seed: int,
                      Ybars: torch.Tensor) -> torch.Tensor:
    """The samples [Nsample, H, nu] of the last reverse step of the plan
    of ``seed`` whose iterates are ``Ybars`` [T, H, nu]: its noise drawn
    again from a generator seeded as the plan's (the reset first, then a
    draw a step), formed as the planner forms them, clamp(ε·σ₁ + Ȳ, −1,
    1), Ȳ the iterate before the last step."""
    from mbd_tpu_torch.core.schedule import make_schedule

    device = Ybars.device
    gen = torch.Generator(device).manual_seed(seed)
    env.reset(gen)
    shape = (cfg.Nsample, cfg.Hsample, env.action_size)
    for _ in range(cfg.Ndiffuse - 1):
        eps = torch.randn(shape, generator=gen, device=device)
    sched = make_schedule(cfg.Ndiffuse, cfg.beta0, cfg.betaT, device=device)
    prev = Ybars[-2] if len(Ybars) > 1 else torch.zeros_like(Ybars[-1])
    return torch.clamp(eps * sched.sigmas[1] + prev, -1.0, 1.0)


def last_step(env, cfg, seed: int, Ybars: torch.Tensor):
    """The launch of the last reverse step of the plan of seeds seed… over
    Ybars [S, T, H, nu]: (the initial states of its S·Nsample samples, the
    samples), each seed's final plan in place of its sample 0."""
    from mbd_tpu_torch.planners import mbd

    S, N = Ybars.shape[0], cfg.Nsample
    gens = [torch.Generator(Ybars.device).manual_seed(seed + s)
            for s in range(S)]
    state0 = mbd.batch_states(env, [env.reset(g) for g in gens], N)
    Y0s = torch.stack([last_step_samples(env, cfg, seed + s, Ybars[s])
                       for s in range(S)])
    Y0s[:, 0] = Ybars[:, -1]
    return state0, Y0s.reshape((S * N,) + Y0s.shape[2:])


def parity(env, cfg, state0, Y0s: torch.Tensor) -> dict:
    """The kernel against the plain engine on the last step's launch
    (``last_step``): flags equal, max |Δ| ≤ 1e-5, the demo log-density
    ≤ 2.4e-7 (``chip_smoke.py``'s tolerances)."""
    from mbd_tpu_torch.ops import rollout_cuda
    from mbd_tpu_torch.rollout import fused

    demo = cfg.enable_demo
    plain = fused.rollout_outputs(env, state0, Y0s, demo=demo)
    got = rollout_cuda.rollout_rewards_cuda(env, state0, Y0s, demo=demo)
    err = float((got[0] - plain[0]).abs().max())
    out = dict(shape=f"{Y0s.shape[0]}x{Y0s.shape[1]}", max_abs_err=err,
               flags_equal=bool(torch.equal(got[1], plain[1])),
               flagged=int(got[1].sum()))
    ok = out["flags_equal"] and err <= 1e-5
    if demo:
        out["logpd_max_abs_err"] = float((got[2] - plain[2]).abs().max())
        ok = ok and out["logpd_max_abs_err"] <= 2.4e-7
    out["ok"] = ok
    return out


def card(out: str) -> int:
    """``--card``: every cell's line, then the fixture; exit 1 when a
    check fails."""
    from concurrent.futures import ThreadPoolExecutor

    from mbd_tpu_torch.ops import rollout_cuda as rc
    from mbd_tpu_torch.planners import mbd
    from mbd_tpu_torch.utils import profiling

    if not torch.cuda.is_available():
        print(json.dumps({"error": "no CUDA device"}))
        return 1
    gpu = profiling.card()
    print(gpu, flush=True)
    configs = cell_configs()
    models = sorted({model for model, _ in configs.values()})
    with ThreadPoolExecutor(len(models)) as pool:
        builds = {m: pool.submit(rc.build, envs.get_env(m, device="cuda"))
                  for m in models}
        ok, arrays = True, {"device": np.array(gpu)}
        for name in CELLS:
            model, cfg = configs[name]
            env = envs.get_env(model, device="cuda")
            builds[model].result()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = mbd.plan(env, cfg, torch.Generator("cuda").manual_seed(0))
            torch.cuda.synchronize()
            plan_s = time.perf_counter() - t0
            state0, Y0s = last_step(env, cfg, 0, res.Ybars[None])
            par = parity(env, cfg, state0, Y0s)
            kernel = rc.rollout_rewards_cuda(env, state0, Y0s)[1]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rec = replay.first_flags(env, state0, Y0s, states=True)
            torch.cuda.synchronize()
            flags_s = time.perf_counter() - t0
            line = dict(cell=name, shape=f"{Y0s.shape[0]}x{Y0s.shape[1]}",
                        n_frames=env.n_frames,
                        final_reward=float(res.final_reward),
                        **replay.summary(rec),
                        kernel_flagged=int(kernel.sum()),
                        parity_flagged=par["flagged"],
                        flags_equal_kernel=bool(torch.equal(kernel,
                                                            rec.bad)),
                        parity_ok=par["ok"], plan_s=plan_s,
                        first_flags_s=flags_s, card=gpu)
            if FIXTURE_CELLS.get(model) == name:
                states, line["fixture_equal_record"] = fixture_states(env,
                                                                      rec)
                arrays.update({f"{model}/{k}": v
                               for k, v in states.items()})
            ok = ok and line["flags_equal_kernel"] and line["parity_ok"] \
                and line["flagged"] == line["kernel_flagged"] \
                == line["parity_flagged"]
            print(json.dumps(line), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    np.savez(out, **arrays)
    print(f"wrote {out}; every check {'held' if ok else 'FAILED'}",
          flush=True)
    return 0 if ok else 1


def judge_fixture(model, engine):
    """``engine``'s substep ("port" on this CPU, or "jax") from every
    fixture state of ``model`` against the card's margins: (the fixture,
    the engine's margins, edge [B], agree [B])."""
    d = fixture(model)
    if engine == "jax":
        got = jax_margins(model, d["q"].T, d["qd"].T, d["u"].T)
    else:
        sys = envs.get_env(model, device="cpu").sys
        got = substep_margins(sys, *(torch.from_numpy(d[k].T.copy())
                                     for k in ("q", "qd", "u")))
    edge, agree = judge((d["qd_margin"], d["root_margin"]), got)
    return d, got, edge, agree


def jax_check() -> int:
    """``--jax``: one eager JAX substep per model, batched over its
    fixture states; one line a state and one a model."""
    ok = True
    for model in FIXTURE_CELLS:
        t0 = time.perf_counter()
        d, (gq, gr), edge, agree = judge_fixture(model, "jax")
        wall = time.perf_counter() - t0
        for j in range(len(edge)):
            verdict = "edge" if edge[j] else ("agrees" if agree[j]
                                              else "DIFFERS")
            print(f"{model} sample {d['sample'][j]} "
                  f"{'flagged' if d['flagged'][j] else 'clean'} "
                  f"({d['check'][j]}, substep {d['substep'][j]}): card qd "
                  f"{d['qd_margin'][j]:+.6f} root {d['root_margin'][j]:+.6f}"
                  f"; JAX qd {gq[j]:+.6f} root {gr[j]:+.6f}: {verdict}")
        judged = ~edge
        print(json.dumps(dict(
            model=model, states=len(edge), edge=int(edge.sum()),
            agree=int((agree & judged).sum()),
            differ=int((~agree & judged).sum()),
            max_qd_gap=float(np.abs(gq - d["qd_margin"]).max()),
            max_root_gap=float(np.abs(gr - d["root_margin"]).max()),
            jax_substep_s=wall, card=str(fixture_device()))), flush=True)
        ok = ok and bool(agree[judged].all())
    return 0 if ok else 1


def fixture_device():
    with np.load(replay.FLAG_STATES) as d:
        return d["device"]


def rollout_samples(env):
    """``ROLLOUT_SAMPLES`` samples around JAX's committed humanoidrun plan
    of seed 0 at the last reverse step's sigma (``make_schedule(300,
    ...).sigmas[1]``), clamped to ±1, sample 0 the plan itself: (the
    reset q [nq], qd [nv], Y [N, H, nu]) as float32 numpy."""
    from mbd_tpu_torch.core.schedule import make_schedule
    from mbd_tpu_torch.planners import mbd

    cfg = mbd.recommended_config("humanoidrun")
    sigma = float(make_schedule(cfg.Ndiffuse, cfg.beta0, cfg.betaT,
                                device="cpu").sigmas[1])
    plan = replay.harness("humanoidrun")["plans"][0]
    eps = np.random.default_rng(ROLLOUT_SEED).standard_normal(
        (ROLLOUT_SAMPLES,) + plan.shape).astype(np.float32)
    Y = np.clip(plan + np.float32(sigma) * eps, -1.0, 1.0).astype(np.float32)
    Y[0] = plan
    with np.load(replay.RESETS) as d:
        q, qd = d["humanoidrun/q"][0], d["humanoidrun/qd"][0]
    return q, qd, Y, sigma


def jax_rollout(out: str) -> int:
    """``--jax_rollout``: each sample's first flag and check in the port's
    plain engine (``first_flags``) and in eager JAX, stepped substep by
    substep up to the port's last first-flag env step."""
    import jax
    import jax.numpy as jnp

    from mbd_tpu.envs.physics import asset_path
    from mbd_tpu.sim import batched as JB
    from mbd_tpu.sim.system import load_mjcf

    env = envs.get_env("humanoidrun", device="cpu")
    q0, qd0, Y, sigma = rollout_samples(env)
    N, H = Y.shape[:2]
    nf = env.n_frames
    state0 = SimpleNamespace(pipeline_state=SimpleNamespace(
        q=torch.from_numpy(q0), qd=torch.from_numpy(qd0)))
    t0 = time.perf_counter()
    rec = replay.first_flags(env, state0, torch.from_numpy(Y))
    port_s = time.perf_counter() - t0
    port = replay.summary(rec)
    first = rec.first.numpy()
    root = rec.root.numpy()
    print(f"port: {port['flagged']} of {N} flagged {port['by_check']}, "
          f"tail share {port['tail_share']:.4f} ({port_s:.1f} s)",
          flush=True)
    steps = int(first.max()) // nf + 1 if (first >= 0).any() else H
    # JAX: env_step_checked_b's body, one substep at a time, eager
    sys = load_mjcf(asset_path("humanoidrun.xml"))
    sensors, floor_z = JB._height_sensors(sys)
    zmin = floor_z - JB.ROOT_SINK_TOL
    q = jnp.asarray(np.tile(q0[:, None], (1, N)))
    qd = jnp.asarray(np.tile(qd0[:, None], (1, N)))
    U = np.ascontiguousarray(Y.transpose(1, 2, 0))          # [H, nu, N]
    jfirst = np.full(N, -1)
    jroot = np.zeros(N, bool)
    t0 = time.perf_counter()
    with jax.disable_jit():
        for t in range(steps):
            for f in range(nf):
                q, qd = JB.substep_b(sys, q, qd, jnp.asarray(U[t]))
                fast = np.asarray(jnp.max(jnp.abs(qd), axis=0)
                                  > JB.QD_DIVERGED)
                sunk = np.zeros(N, bool)
                for qadr, off in sensors:
                    sunk |= np.asarray(q[qadr] + off < zmin)
                new = (jfirst < 0) & (fast | sunk)
                jfirst[new] = t * nf + f
                jroot[new] = ~fast[new]
                qd = jnp.clip(qd, -JB.QD_DIVERGED, JB.QD_DIVERGED)
            print(f"JAX env step {t}: {int((jfirst >= 0).sum())} flagged "
                  f"({time.perf_counter() - t0:.0f} s)", flush=True)
    jax_s = time.perf_counter() - t0

    def name(k, r):
        return "clean" if k < 0 else f"{k // nf}.{k % nf} " \
            f"{'root' if r else 'qd'}"

    rows = []
    for n in range(N):
        rows.append(dict(sample=n, port=name(first[n], root[n]),
                         jax=name(jfirst[n], jroot[n])))
        print(f"sample {n:2d}: port {rows[-1]['port']:>12s}, JAX "
              f"{rows[-1]['jax']:>12s}", flush=True)
    jhit = jfirst >= 0
    result = dict(
        samples=N, sigma=sigma, noise_seed=ROLLOUT_SEED, env_steps=steps,
        port=port, port_s=port_s,
        jax=dict(flagged=int(jhit.sum()),
                 by_check={"qd": int((jhit & ~jroot).sum()),
                           "root": int((jhit & jroot).sum())}),
        jax_s=jax_s,
        same_flag=int(((first >= 0) == jhit).sum()),
        same_substep_and_check=int(((first == jfirst)
                                    & ((root == jroot) | ~jhit)).sum()),
        rows=rows)
    print(json.dumps({k: v for k, v in result.items() if k != "rows"}),
          flush=True)
    if out:
        with open(out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    mode = p.add_mutually_exclusive_group(required=True)
    mode.add_argument("--card", action="store_true")
    mode.add_argument("--jax", action="store_true")
    mode.add_argument("--jax_rollout", action="store_true")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    if args.card:
        return card(args.out or replay.FLAG_STATES)
    import jax

    jax.config.update("jax_platforms", "cpu")
    if args.jax:
        return jax_check()
    return jax_rollout(args.out)


if __name__ == "__main__":
    raise SystemExit(main())
