"""The reference's rollout: Y0s [N, H, nu] from per-sample initial states
rolled out through the engine's checked env step, scored by the model's
reward (a copy of ``mbd_tpu_torch/rollout/fused.py::rollout_rewards`` at
commit f68a38a). With ``record``, it also counts the work each sample
needs: the env steps up to and including its first flagged one, and the
constraint rows that acted in them (``engine.Recorder``).

On the card the env step is captured once as a CUDA graph and replayed
for each of the H steps: the same kernels on the same buffers, so the
same values as running it op by op, without the host's cost of
dispatching each of the engine's tens of thousands of small operations a
substep.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional

import torch

from . import engine


class Work(NamedTuple):
    """Per sample [N]: the env steps it was live in (not flagged at the
    step's start), and the contact and limit row-substeps that acted
    then; with the rows a substep has."""
    live_steps: torch.Tensor
    contacts: torch.Tensor
    limits: torch.Tensor
    n_contacts: int
    n_limits: int


def _graphed(step: Callable[[], None], state: List[torch.Tensor]
             ) -> Callable[[], None]:
    """``step`` (which updates the tensors of ``state`` in place) as a
    replay of its CUDA graph. It runs once first on a side stream, so
    that every constant and workspace exists before the capture, and
    ``state`` is then put back as it was."""
    kept = [t.clone() for t in state]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    for t, k in zip(state, kept):
        t.copy_(k)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step()
    return graph.replay


def rollout(model, q0: torch.Tensor, qd0: torch.Tensor, Y0s: torch.Tensor,
            record: bool = False):
    """q0 [nq, N], qd0 [nv, N], Y0s [N, H, nu] → (rews [N, H], the
    transpose of an [H, N] tensor; bad [N]; ``Work`` or None)."""
    sys = model.sys
    U = Y0s.permute(1, 2, 0).contiguous()                # [H, nu, N]
    q, qd = q0.clone().contiguous(), qd0.clone().contiguous()
    u = U[0].clone()
    bad = torch.zeros_like(q[0])
    live_steps = torch.zeros_like(bad)
    rec: Optional[engine.Recorder] = engine.Recorder(
        torch.ones_like(bad)) if record else None

    def step():
        if rec is not None:
            rec.live.copy_((bad == 0).to(bad.dtype))
            live_steps.add_(rec.live)
        engine.RECORD = rec
        try:
            q1, qd1, bad1 = engine.env_step_checked_b(sys, q, qd, u,
                                                      model.n_frames, bad)
        finally:
            engine.RECORD = None
        q.copy_(q1)
        qd.copy_(qd1)
        bad.copy_(bad1)

    run = step
    if Y0s.is_cuda:
        state = [q, qd, u, bad, live_steps]
        if rec is not None:
            state += [rec.live, rec.contacts, rec.limits]
        run = _graphed(step, state)
    qs = []
    for t in range(U.shape[0]):
        u.copy_(U[t])
        run()
        qs.append(q.clone())
    rews = model.reward(torch.stack(qs))                 # [H, N]
    work = None if rec is None else Work(
        live_steps, rec.contacts, rec.limits, rec.n_contacts, rec.n_limits)
    return rews.transpose(0, 1), bad, work
