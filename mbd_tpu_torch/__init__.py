"""mbd_tpu_torch — the PyTorch/CUDA port of mbd_tpu.

The same Model-Based Diffusion planner and batch-last rigid-body engine,
on PyTorch tensors; on an NVIDIA Hopper card the whole rollout runs in one
hand-written CUDA kernel (``ops/rollout_cuda.py``, ``csrc/rollout.cu``).
The JAX package ``mbd_tpu`` is the reference this port is held against.
"""

__version__ = "0.1.0"
