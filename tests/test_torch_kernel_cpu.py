"""The CUDA rollout kernel's source (mbd_tpu_torch/csrc/rollout.cu) run as
plain C++ on the CPU, against the torch engine it follows term for term.

The kernel body needs nothing of CUDA but its keywords and thread
indices, so a tiny shim turns ``__global__``/``__device__`` into nothing,
drops the launch code after ``extern "C"`` and calls ``rollout_kernel``
for every (block, thread). g++ builds it with ``-ffp-contract=off`` (no
fused multiply–add, as ``nvcc --fmad=false``); float arithmetic on x86-64
is IEEE single, as on the card. Only sin and cos come from another
library than torch's, so the inputs take no sine or cosine of a nonzero
angle: every hinge at its init angle, the free roots with zero angular
velocity, one substep. The roots' positions, quaternions and slides
differ per sample, with some feet in the floor, so the contact and limit
rows are live.

Flags must be equal and rewards agree to atol 2e-6. The one difference
left is torch's own CPU sqrt, which on an AVX-512 build is not always
correctly rounded (682 of 100,000 random floats came out one ulp off),
where g++'s sqrtf, like the card's in both the kernel and the plain
version, is. Measured: 0 on hopper, walker2d, halfcheetah and the
humanoids; 1.2e-7 on cartpole (the cosine of its pole angle in the
reward); 7.2e-7 on ant, where one sample's friction direction took that
ulp and the reward divides the step's displacement by dt = 0.01.

Skips where g++ is missing.
"""

import ctypes
import os
import shutil
import subprocess
from types import SimpleNamespace

import pytest
import torch

from mbd_tpu_torch import envs
from mbd_tpu_torch.ops import rollout_cuda
from mbd_tpu_torch.rollout.fused import rollout_rewards
from mbd_tpu_torch.sim.system import FREE, HINGE, SLIDE

SHIM = """
#include <cmath>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
struct dim3 { int x, y, z; };
static dim3 blockIdx, threadIdx, blockDim;
"""
DRIVER = """
extern "C" void cpu_rollout(const float* q0, const float* qd0,
                            int per_sample, const float* U, float* rews,
                            float* bad, int N, int H) {
  blockDim.x = kThreads;
  for (int b = 0; b < (N + kThreads - 1) / kThreads; ++b)
    for (int t = 0; t < kThreads; ++t) {
      blockIdx.x = b;
      threadIdx.x = t;
      rollout_kernel(q0, qd0, per_sample, U, rews, bad, N, H);
    }
}
"""
ATOL = 2e-6
N = 130          # two blocks of 128 threads, the second ragged


def _cpu_kernel(env, out_dir):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    with open(os.path.join(rollout_cuda.CSRC, "rollout.cu")) as f:
        src = f.read()
    src = src.replace("#include <cuda_runtime.h>", SHIM)
    src = src.replace('#include "model.h"', rollout_cuda.model_header(env))
    src = src[:src.index('extern "C" {')] + DRIVER
    cpp, so = os.path.join(out_dir, "k.cpp"), os.path.join(out_dir, "k.so")
    with open(cpp, "w") as f:
        f.write(src)
    subprocess.run([gxx, "-O1", "-ffp-contract=off", "-std=c++17",
                    "-shared", "-fPIC", "-Wno-unknown-pragmas", "-o", so,
                    cpp], check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    lib.cpu_rollout.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] + \
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
    lib.cpu_rollout.restype = None
    return lib


def _inputs(sys, gen):
    """Per-sample q0/qd0 whose substep takes no sine or cosine of a
    nonzero angle (module docstring)."""
    q = sys.init_q[:, None].repeat(1, N).clone()
    qd = torch.randn((sys.nv, N), generator=gen) * 0.5
    for j in range(sys.njnt):
        qa, da = sys.jnt_qposadr[j], sys.jnt_dofadr[j]
        if sys.jnt_type[j] == FREE:
            q[qa:qa + 2] += torch.randn((2, N), generator=gen) * 0.1
            q[qa + 2] = torch.rand(N, generator=gen) * 1.2 * q[qa + 2]
            quat = torch.randn((4, N), generator=gen) * 0.1
            quat[0] += 1.0
            q[qa + 3:qa + 7] = quat / quat.norm(dim=0)
            qd[da + 3:da + 6] = 0.0
        elif sys.jnt_type[j] == SLIDE:
            q[qa] += torch.randn(N, generator=gen) * 0.05
        else:
            assert sys.jnt_type[j] == HINGE     # stays at its init angle
    return q.contiguous(), qd.contiguous()


@pytest.mark.parametrize("name", ["hopper", "walker2d", "halfcheetah",
                                  "cartpole", "ant", "humanoidrun",
                                  "humanoidstandup"])
def test_kernel_source_matches_plain_version(name, tmp_path):
    env = envs.get_env(name)
    env.n_frames = 1
    lib = _cpu_kernel(env, str(tmp_path))
    gen = torch.Generator().manual_seed(0)
    q0, qd0 = _inputs(env.sys, gen)
    Y0s = 2 * torch.rand((N, 1, env.action_size), generator=gen) - 1
    U = Y0s.permute(1, 2, 0).contiguous()
    rews, bad = torch.empty((1, N)), torch.empty(N)
    lib.cpu_rollout(q0.data_ptr(), qd0.data_ptr(), 1, U.data_ptr(),
                    rews.data_ptr(), bad.data_ptr(), N, 1)
    state = SimpleNamespace(pipeline_state=SimpleNamespace(q=q0, qd=qd0))
    r_p, _, bad_p = rollout_rewards(env, state, Y0s)
    assert torch.isfinite(rews).all()
    assert torch.equal(bad, bad_p)
    assert float((rews.t() - r_p).abs().max()) <= ATOL
