"""What each rank runs in the port's mesh tests (``test_torch_mesh.py``,
``test_torch_rl_mesh.py``), and what one process runs for the same
cases with ``mesh=None``. This module imports no JAX: the spawned ranks
import it."""

import contextlib
import os

import torch

from mbd_tpu_torch import envs
from mbd_tpu_torch.envs import State
from mbd_tpu_torch.planners import mbd
from mbd_tpu_torch.planners import path_integral as pi
from mbd_tpu_torch.rl import ppo

# JAX's meshed tests' config (tests/test_mesh_engines.py); plan_batch and
# MPPI at a shorter horizon and fewer steps, which the plain engine on the
# CPU rolls out in a third of the time
CFG = dict(Nsample=64, Hsample=10, Ndiffuse=5, temp_sample=0.1)
SHORT = dict(Nsample=64, Hsample=5)
CAR2D = dict(Nsample=32, Hsample=8, Ndiffuse=12, enable_demo=True)
CHUNK, STOP = 3, 6           # car2d's checkpoint: chunks of 3, stop at 6
# tests/test_torch_planner.py's hopper plan against JAX's
JAX_CFG = dict(Nsample=16, Hsample=10, Ndiffuse=6)
PLAN_FIELDS = ("Ybars", "rews_trace", "final_reward", "final_diverged")


@contextlib.contextmanager
def one_thread():
    """One CPU thread, as each spawned rank has."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _fields(res, names=PLAN_FIELDS):
    return {k: torch.as_tensor(getattr(res, k)) for k in names}


class Interrupt(Exception):
    pass


def planner_cases(mesh, workdir, jax_inputs):
    """Every planner case, on ``mesh`` (``None``: one process), each
    result's tensors by name: hopper MBD at JAX's meshed config with the
    collectives of each reverse step (``collectives``), hopper MBD from
    JAX's reset state and noise (``jax_inputs``: q, qd and eps of
    ``JAX_CFG``), ``plan_batch`` at S = 2, MPPI, car2d with the demo, and a
    car2d plan checkpointed, interrupted after chunk 2 and resumed (with
    the steps the resume ran). On a mesh, also the error of a resume whose
    checkpoint path names other files on rank 1 than on rank 0
    (``unshared``)."""
    os.makedirs(workdir, exist_ok=True)
    hopper = envs.get_env("hopper", device="cpu")
    car = envs.get_env("car2d", device="cpu")
    out = {}
    steps = []

    def log_step(t, rew):
        if mesh is not None:
            steps.append(list(mesh.collectives))
            mesh.collectives.clear()

    res = mbd.plan(hopper, mbd.MBDConfig(**CFG),
                   torch.Generator().manual_seed(0), chunk_size=1,
                   progress_fn=log_step, mesh=mesh)
    out["mbd"] = _fields(res)
    out["collectives"] = steps
    ps = hopper.pipeline_init(jax_inputs["q"], jax_inputs["qd"])
    res = mbd.plan(hopper, mbd.MBDConfig(**JAX_CFG), torch.Generator(),
                   state_init=State(ps, hopper._obs(ps), torch.zeros(()),
                                    torch.zeros(())),
                   eps=jax_inputs["eps"], mesh=mesh)
    out["jax_inputs"] = _fields(res)
    res = mbd.plan_batch(hopper, mbd.MBDConfig(Ndiffuse=3, **SHORT),
                         [torch.Generator().manual_seed(s) for s in (0, 1)],
                         mesh=mesh)
    out["plan_batch"] = _fields(res)
    res = pi.plan(hopper, pi.PathIntegralConfig(
        update_method="mppi", Nrefine=3, **SHORT),
        torch.Generator().manual_seed(0), mesh=mesh)
    out["mppi"] = _fields(res, ("mu_0ts", "rews_trace", "final_reward",
                                "final_diverged"))
    res = mbd.plan(car, mbd.MBDConfig(**CAR2D),
                   torch.Generator().manual_seed(0), mesh=mesh)
    out["car2d_demo"] = _fields(res)

    path = os.path.join(workdir, "ckpt")

    def interrupt(t, rew):
        if t == STOP:
            raise Interrupt

    try:
        mbd.plan(car, mbd.MBDConfig(**CAR2D),
                 torch.Generator().manual_seed(4), chunk_size=CHUNK,
                 checkpoint_path=path, progress_fn=interrupt, mesh=mesh)
    except Interrupt:
        pass
    resumed = []
    res = mbd.plan(car, mbd.MBDConfig(**CAR2D),
                   torch.Generator().manual_seed(4), chunk_size=CHUNK,
                   checkpoint_path=path, mesh=mesh,
                   progress_fn=lambda t, r: resumed.append(t))
    out["checkpoint"] = dict(_fields(res), steps=torch.tensor(resumed))
    if mesh is not None:
        try:
            mbd.plan(car, mbd.MBDConfig(**CAR2D),
                     torch.Generator().manual_seed(4), chunk_size=CHUNK,
                     checkpoint_path=path if mesh.rank == 0
                     else path + ".elsewhere", mesh=mesh)
            out["unshared"] = ""
        except RuntimeError as e:
            out["unshared"] = str(e)
    return out


def tiny_ppo_config():
    """tests/test_rl_mesh.py's ``_tiny_cfg``."""
    return ppo.PPOConfig(num_timesteps=256, num_evals=1, num_envs=16,
                         unroll_length=4, num_minibatches=2,
                         num_updates_per_batch=1, episode_length=8,
                         num_eval_envs=4, seed=0)


def ppo_case(mesh):
    """PPO on hopper at the tiny config: the policy's and value's
    parameters, the running observation statistics and the eval reward."""
    env = envs.get_env("hopper", device="cpu")
    _, params, hist = ppo.train(env, tiny_ppo_config(), mesh=mesh)
    state = {f"policy.{k}": v.detach().clone()
             for k, v in params.policy.state_dict().items()}
    state.update({f"value.{k}": v.detach().clone()
                  for k, v in params.value.state_dict().items()})
    stats = params.obs_stats
    state.update({f"obs_stats.{k}": torch.as_tensor(v).clone()
                  for k, v in vars(stats).items()})
    return dict(params=state, eval=hist[0]["eval/episode_reward"])


def card_plan(mesh):
    """A short hopper plan on the card (Nsample 256, H 10, Ndiffuse 5),
    its fields on the host, and the samples of this rank's launches."""
    from mbd_tpu_torch.ops import rollout_cuda

    env = envs.get_env("hopper", device="cuda")
    launches = rollout_cuda.LAUNCHES
    res = mbd.plan(env, mbd.MBDConfig(Nsample=256, Hsample=10, Ndiffuse=5),
                   torch.Generator("cuda").manual_seed(0), mesh=mesh)
    out = {k: v.cpu() for k, v in _fields(res).items()}
    out["launches"] = torch.tensor(rollout_cuda.LAUNCHES - launches)
    return out


# test_torch_multichip.py: four ranks; the final selection of 49 plans,
# split 13/12/12/12, at a horizon of 2
FOUR = 4
FINAL_T, FINAL_H = 49, 2
EXACT_SHAPES = ((49, 12), (16, 11), (64, 18))


def jax_state(env, jax_inputs):
    """The port's State from JAX's reset (q, qd of ``jax_inputs``)."""
    ps = env.pipeline_init(jax_inputs["q"], jax_inputs["qd"])
    return State(ps, env._obs(ps), torch.zeros(()), torch.zeros(()))


def final_split(mesh):
    """``mbd.evaluate_final`` of FINAL_T random hopper plans from the
    seed-0 reset, each of them rolled out once: the chosen reward, flag
    and plan, and this rank's rows and sample-steps."""
    from mbd_tpu_torch.ops import rollout_cuda

    env = envs.get_env("hopper", device="cpu")
    gen = torch.Generator().manual_seed(0)
    state = env.reset(gen)
    plans = 0.5 * torch.randn((1, FINAL_T, FINAL_H, env.action_size),
                              generator=gen)
    steps = rollout_cuda.SAMPLE_STEPS
    reward, diverged = mbd.evaluate_final(env, [state], plans, mesh)
    return dict(final_reward=reward, final_diverged=diverged,
                plan=plans[:, -1].clone(),
                rows=torch.tensor(mesh.split(FINAL_T) if mesh is not None
                                  else (0, FINAL_T)),
                sample_steps=torch.tensor(rollout_cuda.SAMPLE_STEPS - steps))


def multichip_cases(mesh, jax_inputs):
    """``parallel.multichip`` on the CPU at ``JAX_CFG`` (``mesh``: a rank
    of four; ``None``: one process): the exact gather at
    ``EXACT_SHAPES`` (a rank only), one reverse step (``jax_inputs``'
    ``step_eps``) and the plan (``eps``), both from JAX's reset, measured
    as on the cards; then ``final_split``."""
    from mbd_tpu_torch.parallel import multichip as M

    hopper = envs.get_env("hopper", device="cpu")
    state = jax_state(hopper, jax_inputs)
    cfg = mbd.MBDConfig(**JAX_CFG)
    cpu = torch.device("cpu")
    out = {}
    if mesh is not None:
        out["exact"] = M.exact_gather(mesh, EXACT_SHAPES)
        out["shard"] = mesh.shard(cfg.Nsample)
    out["step"] = M.measure(M.Case("hopper", "step", cfg), cpu, mesh, 1,
                            state_init=state, eps=jax_inputs["step_eps"])
    out["plan"] = M.measure(M.Case("hopper", "plan", cfg), cpu, mesh, 1,
                            state_init=state, eps=jax_inputs["eps"])
    out["final"] = final_split(mesh)
    return out


# tests/test_torch_tracing.py's tiny plan_batch: hopper, 2 seeds
TRACE_CFG = dict(Nsample=16, Hsample=4, Ndiffuse=4)
TRACE_SEEDS = (0, 1)


def traced_plan(mesh=None, device="cpu"):
    """The tiny ``plan_batch`` of ``TRACE_CFG`` over the mesh (or in one
    process), recorded by the recorder with its counters
    (``profiling.recording``); its fields."""
    from mbd_tpu_torch.utils import profiling

    device = mesh.device if mesh is not None else device
    env = envs.get_env("hopper", device=device)
    gens = [torch.Generator(device).manual_seed(s) for s in TRACE_SEEDS]
    with profiling.recording(counters=True):
        res = mbd.plan_batch(env, mbd.MBDConfig(**TRACE_CFG), gens,
                             mesh=mesh)
    return _fields(res)
