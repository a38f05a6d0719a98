"""The benchmark's work table (``benchmark/work/count.py``) against the
port's plain engine: ``WORK`` equals the live count of the plain version
for every model the kernel builds and its demo mode, exactly, and
``ROW_WORK`` the live count of an idle row's work; the bounds it gives
are the digits the smoke printed before the table existed; the rows the
plain engine records and the work they leave out add up; and the rollout
wrapper counts the sample-steps it rolls out on the CPU too.

The tables are a yardstick, so they are fixed and not counted at run
time: the live count (``_live_count``) may shift with the torch version
or an edit of the plain engine, and these tests hold it equal to the
tables, so that such a change updates them in the open. The counts were
taken with torch 2.13 on the CPU."""

import functools
import sys

import pytest
import torch

from benchmark.work import count
from mbd_tpu_torch import envs
from mbd_tpu_torch.ops import rollout_cuda
from mbd_tpu_torch.rollout.fused import rollout_outputs
from mbd_tpu_torch.sim import batched

# aten ops that move or make data and compute nothing; every other op is
# counted at one operation per output element (per input element for a
# reduction)
MOVES = {
    "view", "_unsafe_view", "_reshape_alias", "reshape", "expand", "permute",
    "transpose", "t", "select", "slice", "unsqueeze", "squeeze", "cat",
    "stack", "clone", "copy_", "_to_copy", "contiguous", "empty",
    "empty_like", "empty_strided", "zeros", "zeros_like", "ones",
    "ones_like", "full", "full_like", "new_zeros", "new_ones", "new_full",
    "new_empty", "lift_fresh", "lift_fresh_copy", "detach", "alias",
    "as_strided", "split", "split_with_sizes", "unbind", "index",
    "index_select", "_local_scalar_dense", "scalar_tensor", "fill_", "zero_",
    "arange", "repeat"}
REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "argmin",
              "argmax", "linalg_vector_norm", "prod"}


def _rows(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` with the plain engine's rows recorded
    (``sim/batched.py``'s ``ROW_LOG``): (its result, [contacts acting,
    contact rows, limits acting, limit rows] over every substep it ran)."""
    batched.ROW_LOG = log = []
    try:
        out = fn(*args, **kwargs)
    finally:
        batched.ROW_LOG = None
    return out, [int(sum(e[0].sum() for e in log)), sum(e[1] for e in log),
                 int(sum(e[2].sum() for e in log)), sum(e[3] for e in log)]


@functools.lru_cache(maxsize=None)
def _live_count(name: str, demo: bool):
    """One rollout at N = 1, H = 1 through the kernel's plain version
    (``rollout/fused.py::rollout_outputs``), its operations counted by a
    dispatch mode: one per output element of each computing aten op, one
    per input element of a reduction, a sine or a square root as one.
    Returns (all operations, those of the contact rows' directions, those
    of every row's solve and sweep)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    dirs = batched._contact_dirs.__code__
    per_row = {batched._row_solve.__code__, batched._gs_sweep.__code__}

    class Count(TorchDispatchMode):
        ops = {"all": 0, "dirs": 0, "row": 0}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            op = func.overloadpacket.__name__
            n = 0
            if op in REDUCTIONS:
                n = args[0].numel()
            elif op not in MOVES:
                outs = out if isinstance(out, (tuple, list)) else (out,)
                n = sum(o.numel() for o in outs
                        if isinstance(o, torch.Tensor))
            self.ops["all"] += n
            # the phases call the ops at most a few frames down
            frame = sys._getframe(1)
            for _ in range(6):
                if frame is None:
                    break
                if frame.f_code is dirs:
                    self.ops["dirs"] += n
                    break
                if frame.f_code in per_row:
                    self.ops["row"] += n
                    break
                frame = frame.f_back
            return out

    env = envs.get_env(name, device="cpu")
    state0 = env.reset(torch.Generator().manual_seed(0))
    with Count() as counted:
        rollout_outputs(env, state0, torch.zeros((1, 1, env.action_size)),
                        demo=demo)
    return counted.ops["all"], counted.ops["dirs"], counted.ops["row"]


def row_ops(name: str):
    """The live count behind ``ROW_WORK[name]``: the operations of one
    contact row and of one limit row in one substep that the row needs
    only when it acts. The plain version computes each phase for all rows
    at once, as much for each row, so a phase's count divides evenly by
    its rows."""
    _, dirs, row = _live_count(name, False)
    env = envs.get_env(name, device="cpu")
    _, (_, contacts, _, limits) = _rows(
        rollout_outputs, env, env.reset(torch.Generator().manual_seed(0)),
        torch.zeros((1, 1, env.action_size)))
    every = contacts + limits
    assert dirs % max(contacts, 1) == 0 and row % max(every, 1) == 0, \
        (name, dirs, row, contacts, limits)
    per_row = row // every if every else 0
    return (dirs // contacts + per_row if contacts else 0,
            per_row if limits else 0)


@pytest.mark.parametrize("key", sorted(count.WORK),
                         ids=lambda k: k[0] + "+demo" * k[1])
def test_work_is_the_live_count(key):
    """A change to the plain engine or to torch's dispatch that moves the
    count must update the table in the open."""
    assert _live_count(*key)[0] == count.WORK[key]


@pytest.mark.parametrize("name", sorted(count.ROW_WORK))
def test_row_work_is_the_live_count(name):
    assert row_ops(name) == count.ROW_WORK[name]


def test_work_holds_the_published_counts():
    assert count.WORK["hopper", False] == 229_745
    assert count.WORK["pushT", False] == 37_035
    assert count.WORK["humanoidrun", False] == 412_475
    assert count.WORK["humanoidtrack", False] == 390_205
    assert count.WORK["humanoidtrack", True] == 394_014


@pytest.mark.parametrize("name,N,H,demo,ms", [
    ("hopper", 2048, 50, False, "0.3511"),
    ("humanoidrun", 8192, 50, False, "2.5216"),
    ("humanoidtrack", 2048, 50, True, "0.6022"),
    ("pushT", 2048, 40, False, "0.0453")])
def test_bound_digits(name, N, H, demo, ms):
    """The smoke's bound lines at the paths' shapes: ``least_s`` of
    ``WORK`` · N · H and a launch's bytes; operations bound them."""
    sys_ = envs.get_env(name, device="cpu").sys
    ops = count.WORK[name, demo] * N * H
    nbytes = count.launch_bytes(sys_.nq, sys_.nv, sys_.nu, N, H)
    assert f"{count.least_s(ops, nbytes) * 1e3:.4f}" == ms
    assert ops / count.PEAK_FLOPS > nbytes / count.PEAK_BYTES


def test_bound_by_bytes():
    assert count.least_s(1.0, count.PEAK_BYTES / 1e3) == 1e-3
    assert count.least_s(count.PEAK_FLOPS / 1e3, 1.0) == 1e-3


def test_wrapper_counts_sample_steps_on_the_cpu():
    """``SAMPLE_STEPS`` gains N·H a rollout on a CPU tensor
    (``DEMO_SAMPLE_STEPS`` N·H with the demo); ``LAUNCHES`` stays the
    card's."""
    env = envs.get_env("cartpole", device="cpu")
    state0 = env.reset(torch.Generator().manual_seed(0))
    before = (rollout_cuda.SAMPLE_STEPS, rollout_cuda.DEMO_SAMPLE_STEPS,
              rollout_cuda.LAUNCHES)
    rollout_cuda.rollout_rewards_cuda(env, state0, torch.zeros((3, 2, 1)))
    track = envs.get_env("humanoidtrack", device="cpu")
    rollout_cuda.rollout_rewards_cuda(
        track, track.reset(None), torch.zeros((2, 1, track.action_size)),
        demo=True)
    assert (rollout_cuda.SAMPLE_STEPS, rollout_cuda.DEMO_SAMPLE_STEPS,
            rollout_cuda.LAUNCHES) == (before[0] + 6 + 2, before[1] + 2,
                                       before[2])


def test_acting_rows_of_a_rollout():
    """The rows recorded over a hopper rollout: every row of every substep
    and sample, the acting ones among them, the contact ones each
    sample's rows buffer (``rows=True``) sums; the record is off again
    after; and the work they leave out is ``ROW_WORK`` per idle row
    (``count.needed_ops``)."""
    env = envs.get_env("hopper", device="cpu")
    gen = torch.Generator().manual_seed(0)
    state0 = env.reset(gen)
    N, H = 3, 4
    Y0s = 2.0 * torch.rand((N, H, env.action_size), generator=gen) - 1.0
    (rews, bad), (c_act, c_all, l_act, l_all) = _rows(rollout_outputs, env,
                                                      state0, Y0s)
    assert batched.ROW_LOG is None
    assert torch.equal(rews, rollout_outputs(env, state0, Y0s)[0])
    # hopper: 11 contact rows and 6 limit rows a substep
    substeps = env.n_frames * N * H
    assert (c_all, l_all) == (11 * substeps, 6 * substeps)
    assert 0 < c_act < c_all and 0 <= l_act < l_all
    assert not bool(bad.any())
    per_sample = rollout_outputs(env, state0, Y0s, rows=True)[2]
    assert batched.ROW_LOG is None
    assert int(per_sample.sum()) == c_act
    tally = count.Tally(N * H, c_act, l_act, 11, 6)
    idle = (c_all - c_act) * 393 + (l_all - l_act) * 209
    assert count.needed_ops("hopper", env.n_frames, tally) == \
        229_745 * N * H - idle
    every = count.Tally(1, 11 * env.n_frames, 6 * env.n_frames, 11, 6)
    assert count.needed_ops("hopper", env.n_frames, every) == 229_745
    none = count.Tally(1, 0, 0, 11, 6)
    assert count.needed_ops("hopper", env.n_frames, none) == \
        229_745 - env.n_frames * (11 * 393 + 6 * 209)
