"""``mbd_tpu_torch.parallel.multichip`` on the CPU: four gloo ranks against
one process and against JAX's meshed step and plan on a 4-device CPU mesh.

The counterpart of ``dryrun_multichip`` (``__graft_entry__.py``) and of
``tests/test_mesh_engines.py`` at four devices. The ranks run
``torch_mesh_ranks.multichip_cases`` (one spawn for the module): the
exact gather, then ``multichip``'s step and plan cases at hopper's
``JAX_CFG`` from JAX's reset state and JAX's noise, measured as on the
cards, then the final selection of 49 plans split 13/12/12/12. This
process runs the same cases without a mesh, with one CPU thread, and
JAX runs its own meshed reverse step and plan
(``make_reverse_once(..., mesh=Mesh(jax.devices()[:4], ("sample",)))``)
on the same inputs. Tolerances: the port's ranks against one process
bit for bit (each rank rolls out its shard and the gather is exact);
against JAX 5e-3, the bound JAX holds its own meshed plans to against
the unsharded ones (GSPMD may reassociate the reductions), and
``final_diverged`` equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_mesh_ranks as R
from mbd_tpu import envs as jax_envs
from mbd_tpu.core.schedule import make_schedule as jax_schedule
from mbd_tpu.planners import mbd as jax_mbd
from mbd_tpu_torch.parallel import SampleMesh, multichip, start_ranks
from mbd_tpu_torch.planners import mbd

JAX_ATOL = 5e-3


def _jax_inputs():
    """JAX's hopper reset state, its plan's noise stream for ``R.JAX_CFG``
    (as tests/test_torch_mesh.py reproduces it) and the noise of its
    reverse step from the key PRNGKey(1) (``dryrun_multichip``'s)."""
    cfg, jenv = R.JAX_CFG, jax_envs.get_env("hopper")
    shape = (cfg["Nsample"], cfg["Hsample"], jenv.action_size)
    rng, rng_reset = jax.random.split(jax.random.PRNGKey(0))   # mbd.py:668
    jstate = jenv.reset(rng_reset)
    rng_exp, _ = jax.random.split(rng)                          # mbd.py:671
    eps = []
    for _ in range(cfg["Ndiffuse"] - 1):
        rng_exp, key = jax.random.split(rng_exp)                # mbd.py:224
        eps.append(np.asarray(jax.random.normal(key, shape)))
    _, key = jax.random.split(jax.random.PRNGKey(1))
    step_eps = np.asarray(jax.random.normal(key, shape))
    return jstate, dict(q=torch.tensor(np.asarray(jstate.pipeline_state.q)),
                        qd=torch.tensor(np.asarray(jstate.pipeline_state.qd)),
                        eps=torch.tensor(np.stack(eps)),
                        step_eps=torch.tensor(step_eps))


def _jax_meshed(jstate):
    """JAX's reverse step from Ybar = 0 at i = Ndiffuse − 1 with the key
    PRNGKey(1), and its plan from PRNGKey(0), both on a 4-device mesh."""
    jenv = jax_envs.get_env("hopper")
    cfg = jax_mbd.MBDConfig(**R.JAX_CFG)
    mesh = Mesh(np.asarray(jax.devices()[:R.FOUR]), ("sample",))
    sched = jax_schedule(cfg.Ndiffuse, cfg.beta0, cfg.betaT)
    reverse_once = jax_mbd.make_reverse_once(jenv, cfg, jstate, sched,
                                             mesh=mesh, engine="fused")

    @jax.jit
    def step(rng, Ybar):
        (_, Ybar_next), (_, rew) = reverse_once(
            (rng, Ybar), jnp.asarray(cfg.Ndiffuse - 1))
        return Ybar_next, rew

    Ybar, rew = step(jax.random.PRNGKey(1),
                     jnp.zeros((cfg.Hsample, jenv.action_size)))
    plan = jax_mbd.plan(jenv, cfg, jax.random.PRNGKey(0), mesh=mesh,
                        engine="fused")
    return dict(Ybar=np.asarray(Ybar), rew=float(rew), plan=plan)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(one process's results, [each of four ranks'], JAX's meshed step
    and plan)."""
    jstate, inputs = _jax_inputs()
    ranks = start_ranks(R.multichip_cases, R.FOUR, inputs, device="cpu")
    jres = _jax_meshed(jstate)
    with R.one_thread():
        single = R.multichip_cases(None, inputs)
    return single, ranks.wait(), jres


@pytest.mark.parametrize("case", ("step", "plan"))
def test_four_ranks_equal_one_process(runs, case):
    """``multichip.judge`` of the four ranks against one process: every
    field bit for bit on every rank, the same launches, and the ranks'
    sample-steps adding up to one process's; each rank rolls out its
    quarter of the 16 samples."""
    single, ranks, _ = runs
    row = multichip.judge(multichip.Case("hopper", case,
                                         mbd.MBDConfig(**R.JAX_CFG)),
                          single[case], [o[case] for o in ranks])
    assert row["ok"], row["checks"]
    assert row["exact"] and row["cards"] == R.FOUR
    assert [tuple(o["shard"]) for o in ranks] == [
        (0, 4), (4, 8), (8, 12), (12, 16)]
    H = R.JAX_CFG["Hsample"]
    assert [o[case]["sample_steps"] for o in ranks] == (
        [4 * H] * 4 if case == "step" else
        # 5 steps of 4 samples, then the final selection's 5 split 2/1/1/1
        [(5 * 4 + n) * H for n in (2, 1, 1, 1)])


def test_step_on_four_ranks_matches_jax_meshed_step(runs):
    """Every rank's reverse step (``dryrun``'s kind) from JAX's reset and
    noise against JAX's meshed ``make_reverse_once`` on 4 CPU devices:
    Ybar and the mean reward to 5e-3."""
    _, ranks, jres = runs
    for out in ranks:
        res = out["step"]["result"]
        np.testing.assert_allclose(res["Ybar"].numpy(), jres["Ybar"],
                                   rtol=0, atol=JAX_ATOL)
        assert abs(float(res["rew"]) - jres["rew"]) <= JAX_ATOL


def test_plan_on_four_ranks_matches_jax_meshed_plan(runs):
    """Every rank's plan from JAX's reset and noise against JAX's plan on
    a 4-device mesh: rews_trace and final_reward to 5e-3, final_diverged
    equal."""
    _, ranks, jres = runs
    jplan = jres["plan"]
    for out in ranks:
        res = out["plan"]["result"]
        np.testing.assert_allclose(np.asarray(jplan.rews_trace),
                                   res["rews_trace"].numpy(), rtol=0,
                                   atol=JAX_ATOL)
        assert abs(float(jplan.final_reward)
                   - float(res["final_reward"])) <= JAX_ATOL
        assert bool(res["final_diverged"]) == bool(jplan.final_diverged)


def test_final_selection_splits_unevenly_over_four_ranks(runs):
    """The final selection of 49 plans over four ranks: rows 13/12/12/12
    (``SampleMesh.split``), each rank rolling out only its own, and the
    chosen plan, reward and flag equal to one process's bit for bit."""
    single, ranks, _ = runs
    assert [tuple(o["final"]["rows"].tolist()) for o in ranks] == [
        (0, 13), (13, 25), (25, 37), (37, 49)]
    assert [int(o["final"]["sample_steps"]) for o in ranks] == [
        n * R.FINAL_H for n in (13, 12, 12, 12)]
    for out in ranks:
        for k in ("final_reward", "final_diverged", "plan"):
            assert multichip.same_bits(out["final"][k], single["final"][k]), k


def test_exact_gather_over_four_ranks(runs):
    """The gather of rows holding NaN, ±inf, ±0.0 and subnormals over four
    gloo ranks, each giving its split of the rows: equal bit for bit,
    sign bits included, NaN where NaN, at every shape."""
    _, ranks, _ = runs
    for out in ranks:
        assert [c["shape"] for c in out["exact"]] == [
            list(s) for s in R.EXACT_SHAPES]
        for check in out["exact"]:
            assert check["ok"], check


def test_special_rows_hold_every_kind():
    """The exact gather's rows hold quiet NaNs with and without payload
    and sign, ±inf, ±0.0, ±subnormals and ±the largest float32."""
    x = multichip.special_rows((64, 18))
    bits = set(x.view(torch.int32).view(-1).tolist())
    for b in (0x7FC00000, 0x7FC00123, -0x00400000, 0x7F800000, -0x00800000,
              0, -(1 << 31), 1, -0x7F800001, 0x7F7FFFFF, -0x00800001):
        assert b in bits, hex(b)
    assert torch.isfinite(x).sum() > 0.9 * x.numel()


def test_expected_samples_split_each_launch():
    """A rank's expected launches are the split of one process's: 8192
    over 4 is 2048 each, 299 is 75/75/75/74."""
    single = [8192, 8192, 299]
    assert [multichip.expected_samples(single, r, 4) for r in range(4)] == [
        [2048, 2048, 75], [2048, 2048, 75], [2048, 2048, 75],
        [2048, 2048, 74]]


def test_same_bits_tells_signed_zeros_and_nans_apart():
    z = torch.tensor([0.0])
    assert not multichip.same_bits(z, -z)
    nan = torch.tensor([float("nan")])
    assert multichip.same_bits(dict(a=nan), dict(a=nan.clone()))
    assert not multichip.same_bits(dict(a=nan), dict(b=nan))
    assert not multichip.same_bits(torch.ones(2), torch.ones(3))


@pytest.mark.parametrize("name", multichip.CASES)
def test_case_config_is_the_reference_config(name):
    """Each case at the JAX package's own config: the planners' at their
    models' ``recommended_config`` (humanoidrun 8192 / 50 / 300, hopper
    over 8 seeds, humanoidtrack with the demo), MPPI at
    ``path_integral.recommended_config``, and PPO at ``train.PPO_CONFIGS``'
    pushT for 2 iterations and one eval."""
    import dataclasses

    from mbd_tpu.planners import path_integral as jax_pi
    from mbd_tpu.rl import train as jax_train

    table = multichip.cases()
    assert tuple(table) == multichip.CASES
    case = table[name]
    fields = dataclasses.asdict(case.cfg)
    if case.kind in ("step", "plan"):
        ref = dataclasses.asdict(jax_mbd.recommended_config(
            case.model, jax_mbd.MBDConfig(
                enable_demo=name == "humanoidtrack_demo")))
    elif case.kind == "mppi":
        ref = dataclasses.asdict(jax_pi.recommended_config(
            case.model, jax_pi.PathIntegralConfig(update_method="mppi")))
    else:
        ref = dict(jax_train.PPO_CONFIGS[case.model])
        assert fields.pop("num_timesteps") == 2 * fields["num_envs"] \
            * fields["unroll_length"]
        assert fields.pop("num_evals") == 1
        fields = {k: v for k, v in fields.items() if k in ref}
        ref.pop("num_timesteps")
        ref.pop("num_evals")
    assert fields == ref
    assert case.seeds == (8 if name == "hopper_seeds8" else 1)
    samples = {"dryrun": 8192, "humanoidrun": 8192, "hopper_seeds8": 16384,
               "humanoidtrack_demo": 2048, "hopper_mppi": 2048}
    if name in samples:
        assert case.samples() == samples[name]


def test_main_needs_two_cards(capsys):
    """Without a card, or with fewer than 2, the module says why and
    exits with 2."""
    assert multichip.main(["--cards", "4"]) == 2
    assert "at least 2" in capsys.readouterr().err


def test_timed_run_reads_the_gathers_from_their_spans(tmp_path):
    """``timed_run`` records the run (``profiling.recording``) and reads
    its gathers from the ``mesh.gather`` spans: a tiny hopper plan on a
    gloo mesh of one rank gathers once a step and once for the final
    selection, each time the [S·N, H + 1] rewards and flags (on the CPU
    without a time); the recorder holds that run alone."""
    import torch.distributed as dist

    from mbd_tpu_torch import envs
    from mbd_tpu_torch.parallel.mesh import sample_mesh
    from mbd_tpu_torch.utils import profiling

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = sample_mesh(device="cpu")
        case = multichip.Case("hopper", "plan", mbd.MBDConfig(
            Nsample=8, Hsample=2, Ndiffuse=3))
        env = envs.get_env("hopper", device="cpu")
        with profiling.recording():
            with profiling.span("mbd.step", t=0):
                pass
        with R.one_thread():
            out = multichip.timed_run(case, env, mesh, [])
    finally:
        dist.destroy_process_group()
    rec = profiling.recorded()
    profiling.clear()
    assert out["gathers"] == 3
    assert out["gather_bytes"] == [2 * 3 * 4, 8 * 3 * 4]
    assert out["gather_ms"] is None
    assert sum(s.name == "mbd.plan" for s in rec.spans) == 1
    assert sum(s.name == "mesh.gather" for s in rec.spans) == 3
    # the timed run keeps no counter, so the rollout fills no first flags
    assert rec.counts == {}
    assert not profiling.on()


@pytest.mark.parametrize("size", (1, 2, 4, 8))
def test_warm_form_leaves_each_rank_a_final_rollout(size):
    """The short form run before the timed ones keeps every case's
    config but its steps, and leaves each of ``size`` ranks at least one
    rollout of the final selection (the Ndiffuse − 1 or Nrefine − 1
    iterates, split by ``SampleMesh.split``)."""
    for name, case in multichip.cases().items():
        warm = case.warm(size)
        if case.kind in ("plan", "mppi"):
            steps = warm.cfg.Ndiffuse if case.kind == "plan" \
                else warm.cfg.Nrefine
            T = warm.seeds * (steps - 1)
            for rank in range(size):
                lo, hi = SampleMesh(group=None, rank=rank, size=size,
                                    device=torch.device("cpu")).split(T)
                assert hi > lo, (name, size, rank)
            assert 3 <= steps <= max(2, size) + 1
        elif case.kind == "ppo":
            assert warm.cfg.num_timesteps == warm.cfg.num_envs \
                * warm.cfg.unroll_length
        else:
            assert warm == case
