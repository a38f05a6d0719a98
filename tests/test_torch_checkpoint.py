"""Checkpoint and resume of the port's ``mbd.plan`` (``checkpoint_path``,
JAX's layout: mbd_tpu/planners/mbd.py:705-750), on the CPU.

A plan is interrupted by raising from ``progress_fn`` after a chunk, then
called again with the same arguments: it resumes from the checkpoint and
must equal the uninterrupted plan bit for bit (iterates, rewards, the
final reward), since Ȳ and the generator's state are restored exactly.
"""

import numpy as np
import pytest
import torch

from mbd_tpu_torch import envs
from mbd_tpu_torch.planners import mbd


class Interrupt(Exception):
    pass


def _interrupt_after(step):
    def progress(t, rew):
        if t == step:
            raise Interrupt
    return progress


@pytest.mark.parametrize("name, cfg, chunk, stop", [
    ("car2d", mbd.MBDConfig(Nsample=32, Hsample=8, Ndiffuse=12,
                            enable_demo=True), 3, 6),
    ("hopper", mbd.MBDConfig(Nsample=4, Hsample=1, Ndiffuse=6), 2, 2)])
def test_resume_equals_uninterrupted(name, cfg, chunk, stop, tmp_path):
    """Interrupted after ``stop`` steps and resumed: the iterates and
    rewards equal the uninterrupted plan's bit for bit, the resume runs
    only the steps after ``stop``, and the files have JAX's layout (the
    memmaps padded to whole chunks)."""
    env = envs.get_env(name, device="cpu")
    T = cfg.Ndiffuse - 1
    full = mbd.plan(env, cfg, torch.Generator().manual_seed(4),
                    chunk_size=chunk)
    path = str(tmp_path / "ckpt")
    with pytest.raises(Interrupt):
        mbd.plan(env, cfg, torch.Generator().manual_seed(4),
                 chunk_size=chunk, checkpoint_path=path,
                 progress_fn=_interrupt_after(stop))
    with np.load(path + ".npz") as meta:
        assert int(meta["next_chunk"]) == stop
        assert meta["Ybar"].shape == (cfg.Hsample, env.action_size)
        assert meta["generator"].dtype == np.uint8
    steps = []
    res = mbd.plan(env, cfg, torch.Generator().manual_seed(4),
                   chunk_size=chunk, checkpoint_path=path,
                   progress_fn=lambda t, r: steps.append(t))
    assert steps == [t for t in range(stop + chunk, T + 1, chunk)] + (
        [T] if T % chunk else [])
    assert torch.equal(res.Ybars, full.Ybars)
    assert torch.equal(res.rews_trace, full.rews_trace)
    assert float(res.final_reward) == float(full.final_reward)
    assert res.final_diverged == full.final_diverged
    padded = T + (-T) % chunk
    Y = np.load(path + ".Ybars.npy")
    assert Y.shape == (padded, cfg.Hsample, env.action_size)
    np.testing.assert_array_equal(Y[:T], full.Ybars.numpy())
    assert np.load(path + ".rews.npy").shape == (padded,)


def test_finished_checkpoint_runs_no_step(tmp_path):
    """A checkpoint of a finished plan resumes to the same plan without
    running a step."""
    env = envs.get_env("car2d", device="cpu")
    cfg = mbd.MBDConfig(Nsample=16, Hsample=6, Ndiffuse=6)
    path = str(tmp_path / "done.npz")
    first = mbd.plan(env, cfg, torch.Generator().manual_seed(1),
                     chunk_size=2, checkpoint_path=path)
    steps = []
    again = mbd.plan(env, cfg, torch.Generator().manual_seed(1),
                     chunk_size=2, checkpoint_path=path,
                     progress_fn=lambda t, r: steps.append(t))
    assert steps == []
    assert torch.equal(first.Ybars, again.Ybars)
    assert torch.equal(first.rews_trace, again.rews_trace)


def test_checkpoint_needs_chunks(tmp_path):
    """JAX ignores the path when chunk_size is 0; the port refuses it."""
    env = envs.get_env("car2d", device="cpu")
    with pytest.raises(ValueError, match="chunk_size"):
        mbd.plan(env, mbd.MBDConfig(Nsample=8, Hsample=4, Ndiffuse=3),
                 torch.Generator(), checkpoint_path=str(tmp_path / "c"))
