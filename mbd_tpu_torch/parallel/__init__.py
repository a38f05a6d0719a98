"""Sharding the samples over ranks (port of ``mbd_tpu/parallel``)."""

from .mesh import SampleMesh, sample_mesh, start_ranks

__all__ = ["SampleMesh", "sample_mesh", "start_ranks"]
