"""Faults planted under the program for the tests of ``correct``
(``test_bench_faults.py``): each patches one module of the program in the
process that calls it, and returns the function that undoes it. A rank of
the mesh plants one through ``rank_main``'s ``prepare``, so each has a
form that takes no argument."""

from __future__ import annotations

import torch


def _patch(module, name, value):
    old = getattr(module, name)
    setattr(module, name, value)
    return lambda: setattr(module, name, old)


def unchanged_state():
    """Every reverse step returns the iterate it was given."""
    from mbd_tpu_torch.planners import mbd

    make = mbd.make_reverse_once_batch

    def broken(*args, **kwargs):
        step = make(*args, **kwargs)

        def reverse_once(Ybar_i, i, eps):
            return Ybar_i, step(Ybar_i, i, eps)[1]
        return reverse_once

    return _patch(mbd, "make_reverse_once_batch", broken)


def half_batch():
    """Each seed's statistics and barycenter over the first half of its
    samples only."""
    from mbd_tpu_torch.planners import mbd

    per_seed = mbd.per_seed

    def broken(fn, *args):
        n = args[0].shape[1] // 2
        return per_seed(fn, *(a[:, :n] for a in args))

    return _patch(mbd, "per_seed", broken)


def altered_answer():
    """The rollout's rewards altered where they are produced: sample n's
    scaled by 1 + 1e-3·n/N."""
    from mbd_tpu_torch.planners import mbd

    rollout = mbd.rollout_rewards_cuda

    def broken(env, state0, Y0s, *args, **kwargs):
        out = rollout(env, state0, Y0s, *args, **kwargs)
        n = out[0].shape[0]
        scale = 1 + 1e-3 * torch.arange(n, device=out[0].device) / n
        return (out[0] * scale[:, None],) + tuple(out[1:])

    return _patch(mbd, "rollout_rewards_cuda", broken)


def no_exchange():
    """The gather between ranks left out: each rank keeps its own rows and
    −0.0 for the others'."""
    from mbd_tpu_torch.parallel.mesh import SampleMesh

    def broken(self, local, n, lo):
        full = torch.full((n,) + tuple(local.shape[1:]), -0.0,
                          dtype=local.dtype, device=local.device)
        full[lo:lo + local.shape[0]] = local
        return full

    return _patch(SampleMesh, "gather", broken)
