"""The 1-D "sample" mesh on ``torch.distributed`` (port of
``mbd_tpu/parallel/mesh.py``).

JAX shards the Nsample axis over a device mesh and lets GSPMD turn the
cross-sample reductions into collectives. Here each rank of a process
group rolls out a contiguous shard of the samples, and the per-sample
outputs are gathered back onto every rank, where the statistics run on
the full vectors exactly as in one process. So a sharded plan equals the
single-process plan bit for bit wherever each sample's rollout does not
depend on how many samples share its launch (the kernel's and the plain
engine's do not).

The gather is one ``all_reduce(SUM)`` of a full-length tensor filled with
−0.0, into which each rank writes its slice: every element has one
summand that is not −0.0, and x + (−0.0) = x for every float x, so the
gather is exact, NaN, inf and the sign of zero included. ``all_reduce``
(SUM, and MAX to check that the ranks agree) and ``barrier`` are the only
collectives used: they work on the three
backends the port meets (NCCL on the card, gloo on CUDA tensors, which
takes only ``all_reduce`` and ``broadcast``, and gloo on the CPU).
Nothing here catches a collective's failure or falls back to one process.

    # K cards, one rank each (NCCL):
    #   torchrun --nproc_per_node=K script.py, and in it:
    torch.distributed.init_process_group("nccl")
    mesh = sample_mesh()
    res = mbd.plan(env, cfg, gen, mesh=mesh)   # the same on every rank

    # K ranks on one card, or on the CPU (gloo), from one script:
    results = start_ranks(fn, 2, backend="gloo", device="cuda").wait()
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Callable, List, Tuple

import torch
import torch.distributed as dist

from ..device import resolve
from ..utils import profiling


@dataclass
class SampleMesh:
    """One rank's view of the sample mesh: its process group, ``rank`` and
    ``size`` in it, and the device its tensors live on. ``collectives``
    logs (operation, element count) of every collective it issues."""
    group: Any
    rank: int
    size: int
    device: torch.device
    collectives: List[Tuple[str, int]] = field(default_factory=list)

    def shard(self, n: int, name: str = "Nsample") -> Tuple[int, int]:
        """This rank's contiguous [lo, hi) of an axis of length ``n`` that
        divides evenly over the mesh; ``name`` names the axis in the
        error."""
        if n % self.size != 0:
            raise ValueError(
                f"{name}={n} must be divisible by the mesh device count "
                f"{self.size}; otherwise the per-device shard sizes "
                f"diverge")
        k = n // self.size
        return self.rank * k, (self.rank + 1) * k

    def split(self, n: int) -> Tuple[int, int]:
        """This rank's [lo, hi) of ``n`` items split as evenly as they go
        (the first n % size ranks take one more, as ``torch.tensor_split``
        does); every rank gets at least one."""
        if n < self.size:
            raise ValueError(f"{n} items cannot be split over "
                             f"{self.size} ranks")
        k, r = divmod(n, self.size)
        lo = self.rank * k + min(self.rank, r)
        return lo, lo + k + (self.rank < r)

    def gather(self, local: torch.Tensor, n: int, lo: int) -> torch.Tensor:
        """The full [n, ...] tensor of which this rank holds rows
        [lo, lo + len(local)): an exact all_reduce(SUM) over −0.0. The
        all_reduce is the span ``mesh.gather`` (with its bytes), timed on
        a card by CUDA events, its wait for the other ranks included."""
        full = torch.full((n,) + tuple(local.shape[1:]), -0.0,
                          dtype=local.dtype, device=local.device)
        full[lo:lo + local.shape[0]] = local
        self.collectives.append(("all_reduce", full.numel()))
        with profiling.span("mesh.gather", device=full.is_cuda,
                            bytes=full.numel() * full.element_size()):
            dist.all_reduce(full, op=dist.ReduceOp.SUM, group=self.group)
        return full

    def barrier(self) -> None:
        self.collectives.append(("barrier", 0))
        dist.barrier(group=self.group)

    def first(self, fn: Callable) -> None:
        """``fn()`` on rank 0 while the other ranks wait at a barrier: for
        work whose result every rank then finds cached (a kernel's build,
        one nvcc rather than one a rank)."""
        if self.rank == 0:
            fn()
        self.barrier()

    def agree(self, value: int, what: str) -> int:
        """``value`` when every rank holds the same one, else a
        ``RuntimeError`` naming ``what`` and the ranks' least and largest
        values: one all_reduce(MAX) of (value, −value), in float32, exact
        for |value| < 2²⁴."""
        both = torch.tensor([value, -value], dtype=torch.float32,
                            device=self.device)
        self.collectives.append(("all_reduce", 2))
        dist.all_reduce(both, op=dist.ReduceOp.MAX, group=self.group)
        hi, lo = int(both[0]), -int(both[1])
        if lo != hi:
            raise RuntimeError(f"the ranks disagree on {what}: from {lo} to "
                               f"{hi}")
        return value


def sample_mesh(group=None, device=None) -> SampleMesh:
    """The mesh of an initialised process group (the default group unless
    ``group`` is given). ``device``: where this rank's tensors live; by
    default the card ``rank % cuda.device_count()`` (one card a rank
    under torchrun), which raises without a card. Under NCCL the rank's
    card becomes the current one."""
    if not dist.is_initialized():
        raise RuntimeError("sample_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group)")
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    if device is None:
        resolve("cuda")
        device = f"cuda:{rank % torch.cuda.device_count()}"
    device = resolve(device)
    if device.type == "cuda" and dist.get_backend(group) == "nccl":
        torch.cuda.set_device(device)
    return SampleMesh(group=group, rank=rank, size=size, device=device)


def _rank_main(rank: int, fn: Callable, size: int, backend: str, device,
               workdir: str, args: tuple) -> None:
    """One spawned rank: joins the group through the file store in
    ``workdir``, runs ``fn(mesh, *args)`` and saves what it returns, and
    beside it what the rank's recorder holds."""
    torch.set_num_threads(1)
    dist.init_process_group(
        backend, init_method="file://" + os.path.join(workdir, "store"),
        rank=rank, world_size=size)
    try:
        out = fn(sample_mesh(device=device), *args)
        torch.save((out, profiling.recorded()),
                   os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


class Ranks:
    """Spawned ranks running one function (``start_ranks``)."""

    def __init__(self, context, workdir: str, size: int):
        self.context, self.workdir, self.size = context, workdir, size
        self.t0 = time.perf_counter()
        self.wall_s = None

    def wait(self) -> list:
        """Each rank's return value, in rank order, once all have ended
        (on the CPU); raises if a rank failed. What each rank recorded
        goes into this process's recorder, tagged by its rank."""
        try:
            while not self.context.join():
                pass
            self.wall_s = time.perf_counter() - self.t0
            outs = []
            for r in range(self.size):
                out, rec = torch.load(
                    os.path.join(self.workdir, f"rank{r}.pt"),
                    map_location="cpu", weights_only=False)
                profiling.merge(rec, r)
                outs.append(out)
            return outs
        finally:
            shutil.rmtree(self.workdir, ignore_errors=True)


def start_ranks(fn: Callable, size: int, *args, backend: str = "gloo",
                device="cuda") -> Ranks:
    """Spawn ``size`` ranks that each run ``fn(mesh, *args)`` in a process
    group of their own (a ``file://`` store in a fresh temporary
    directory, so that concurrent groups never meet), with one CPU thread
    each; ``device`` is every rank's (``None``: one card a rank). ``fn``
    must be importable by the spawned processes, and what it returns is
    saved with ``torch.save``. Returns at once; ``wait()`` gives the
    results."""
    workdir = tempfile.mkdtemp(prefix="mbd_mesh_")
    context = torch.multiprocessing.start_processes(
        _rank_main, args=(fn, size, backend, device, workdir, args),
        nprocs=size, join=False, start_method="spawn")
    return Ranks(context, workdir, size)
