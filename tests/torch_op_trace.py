"""Every aten op of the plain engine's env step, with its inputs and
outputs, on the CPU and on the card from the same state: the diagnosis of
hopper seed 0's CPU replay fault (``replay.FAULTS``, ROADMAP.md Queue 3).

The engine is untouched: a ``TorchDispatchMode`` records, in call order,
each op's name and copies of its tensor inputs and outputs while
``sim/batched.py::env_step_checked_b`` takes one env step of seed 0's
committed plan, from the state the CPU's replay reaches before that step.
Comparing the two logs op by op finds the first op whose inputs are
equal bit for bit and whose outputs are not.

    # here: the CPU's state and the digests of its ops
    python tests/torch_op_trace.py --state S.pt --digests D.pt
    # on the card's machine, with S.pt and D.pt beside it: the first op
    # whose inputs are equal and outputs not, its tensors into O.pt
    python tests/torch_op_trace.py --state S.pt --device cuda \\
        --compare D.pt --out O.pt

This module imports no JAX, so that it runs on the card's machine.
"""

import argparse
import hashlib
import os
import sys

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from mbd_tpu_torch import envs  # noqa: E402
from mbd_tpu_torch.rollout import replay  # noqa: E402
from mbd_tpu_torch.sim import batched as TB  # noqa: E402


class OpLog(TorchDispatchMode):
    """(op name, inputs, outputs) of every aten op inside the ``with``,
    the tensors copied to the CPU."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))

        def tensors(x):
            return [t.detach().cpu().contiguous() for t in tree_leaves(x)
                    if isinstance(t, torch.Tensor)]

        self.ops.append((str(func), tensors((args, kwargs)), tensors(out)))
        return out


def digest(t: torch.Tensor) -> str:
    """The tensor's dtype, shape and bytes, hashed."""
    h = hashlib.blake2b(digest_size=8)
    h.update(f"{t.dtype}{tuple(t.shape)}".encode())
    h.update(t.numpy().tobytes())
    return h.hexdigest()


def digests(ops):
    """Each op's (name, input digests, output digests)."""
    return [(name, [digest(x) for x in ins], [digest(x) for x in outs])
            for name, ins, outs in ops]


def seed0(step: int):
    """hopper seed 0: (its env, its control at ``step`` [nu, 1], and the
    CPU replay's (q, qd, bad) before that step)."""
    env = envs.get_env("hopper", device="cpu")
    with np.load(replay.RESETS) as d:
        q, qd = d["hopper/q"][:1].T.copy(), d["hopper/qd"][:1].T.copy()
    U = replay.harness("hopper")["plans"][0][:, :, None]
    q, qd, bad = torch.tensor(q), torch.tensor(qd), torch.zeros(1)
    for t in range(step):
        q, qd, bad = TB.env_step_checked_b(env.sys, q, qd,
                                           torch.tensor(U[t]), env.n_frames,
                                           bad)
    return env, torch.tensor(U[step]), (q, qd, bad)


def trace(state, u, device):
    """The op log of one env step on ``device`` from ``state``."""
    env = envs.get_env("hopper", device=device)
    q, qd, bad = (t.to(device) for t in state)
    with OpLog() as log:
        TB.env_step_checked_b(env.sys, q, qd, u.to(device), env.n_frames,
                              bad)
    return log.ops


def align(a, b, window: int = 64):
    """Pairs (i, j) of the ops of two digest logs with the same name, in
    order: where the names part (one torch's composite op decomposes into
    other ops than another's), the shorter skip within ``window`` ops
    that brings them together again."""
    pairs, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        if a[i][0] == b[j][0]:
            pairs.append((i, j))
            i, j = i + 1, j + 1
            continue
        skips = [(di + dj, di, dj) for di in range(window)
                 for dj in range(window)
                 if i + di < len(a) and j + dj < len(b)
                 and a[i + di][0] == b[j + dj][0]
                 and a[i + di + 1:i + di + 4] and b[j + dj + 1:j + dj + 4]
                 and [x[0] for x in a[i + di:i + di + 4]]
                 == [x[0] for x in b[j + dj:j + dj + 4]]]
        if not skips:
            break
        _, di, dj = min(skips)
        i, j = i + di, j + dj
    return pairs


def first_difference(a, b):
    """Over two digest logs, aligned (``align``): the first pair of ops
    whose inputs are equal and whose outputs are not (None if none), the
    number of pairs whose outputs differ, and the number of ops of each
    log left unpaired."""
    pairs = align(a, b)
    first, n_diff = None, 0
    for i, j in pairs:
        if a[i][2] != b[j][2]:
            n_diff += 1
            if first is None and a[i][1] == b[j][1]:
                first = (i, j)
    return first, n_diff, (len(a) - len(pairs), len(b) - len(pairs))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--step", type=int, default=7)
    p.add_argument("--state", required=True,
                   help="the CPU's state before --step (written if absent)")
    p.add_argument("--device", default="cpu")
    p.add_argument("--digests", help="write this run's digest log here")
    p.add_argument("--compare", help="another device's digest log")
    p.add_argument("--out", help="write the first differing op here")
    args = p.parse_args(argv)
    if os.path.exists(args.state):
        saved = torch.load(args.state)
        u, state = saved["u"], saved["state"]
    else:
        _, u, state = seed0(args.step)
        torch.save(dict(u=u, state=state), args.state)
    ops = trace(state, u, args.device)
    log = digests(ops)
    print(f"{len(log)} ops on {args.device}")
    if args.digests:
        torch.save(log, args.digests)
    if args.compare:
        other = torch.load(args.compare)
        first, n_diff, unpaired = first_difference(log, other)
        print(f"{n_diff} of {len(log)} ops give other outputs; unpaired "
              f"ops here and there: {unpaired}")
        if first is not None:
            i, j = first
            name, ins, outs = ops[i]
            print(f"first op with equal inputs and other outputs: #{i} "
                  f"here, #{j} there: {name}")
            for k, x in enumerate(ins):
                print(f"  input {k}: {x.dtype} {tuple(x.shape)} "
                      f"{x.flatten()[:12].tolist()}")
            for k, x in enumerate(outs):
                print(f"  output {k} on {args.device}: "
                      f"{x.flatten()[:12].tolist()}")
            ctx = [(k, ops[k][0]) for k in range(max(i - 8, 0), i + 3)]
            print("  around it:", ctx)
            if args.out:
                torch.save(dict(index=i, op=ops[i], around=ctx), args.out)

if __name__ == "__main__":
    main()
