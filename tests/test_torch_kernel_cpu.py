"""The CUDA rollout kernel's source (mbd_tpu_torch/csrc/rollout.cu) run as
plain C++ on the CPU, against the torch engine it follows term for term.

The kernel body needs nothing of CUDA but its keywords and its group's
barrier, broadcast, ballot and warp maximum, so a tiny shim turns
``__global__``/``__device__`` into nothing, puts 32 threads with a
barrier in place of a warp's lanes (``GROUP``), drops the launch code and
runs ``rollout_sample`` warp by warp, 32/G samples each, the ragged
tail's groups as on the card, at the env's G (``kernel_group``) unless a
case names another. g++ builds it with ``-ffp-contract=off`` (no
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

The position trace (``need_qs``) and the demo log-density (``demo``) read
what the rewards do not: every q after the step, where the free root's
integrator takes the sine and cosine of its new angular speed, and, for
the demo, the forward kinematics of the moved hinges. Those cases give
the plain engine sqrt, sin and cos taken in double and rounded once
(``rounded_math``), and then hold the trace bit for bit.

pushT's sphere–box pairs take their own inputs (``_pusht_inputs``): the
pusher's centre inside a bar (each bar, with the x and the y face the
nearest in some samples), outside one within the sphere's radius, and
clear of both; the test checks that the inside and the outside branch
were both taken. The pusher and the slider sit at one height, so the z
face never wins in-plane (it ties the y face of the long bar and loses,
as torch.argmin takes the lowest index); a case with the pusher's geom
raised by 0.03 makes it the nearest. That case, and a rotated slider,
whose angle's sine and cosine the substep takes, run under
``rounded_math`` and are held bit for bit.

humanoidrun with hinges past their limits and feet in the floor in some
samples (``_past_limits``) puts active and inactive rows of both kinds in
one batch, at G = 8, 16 and 32; its hinge angles are not 0, so the plain
version takes the C library's sqrtf, sinf and cosf (``libm_math``), as the
card's plain version takes the card's, and the rewards and trace are held
bit for bit.

Skips where g++ is missing.
"""

import ctypes
import ctypes.util
import math
import os
import shutil
import subprocess
from types import SimpleNamespace

import pytest
import torch

from mbd_tpu_torch import envs
from mbd_tpu_torch.ops import rollout_cuda
from mbd_tpu_torch.rollout.fused import rollout_outputs
from mbd_tpu_torch.sim.system import FREE, HINGE, SLIDE

SHIM = """
#include <barrier>
#include <cmath>
#include <cstring>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __shared__
"""
# A warp's 32 lanes as threads: one barrier for __syncwarp, and shared
# words for __shfl_sync (one per group), __ballot_sync and
# __reduce_max_sync (one per lane).
GROUP = """
template <int G>
struct Group {
  int lane, base;
  std::barrier<>* bar;
  float* words;
  unsigned* bits;
  int* ints;
  void sync() const { bar->arrive_and_wait(); }
  float bcast(float v, int src) const {
    sync();
    if (lane == src) words[base / G] = v;
    sync();
    return words[base / G];
  }
  unsigned ballot(bool p) const {
    sync();
    bits[base + lane] = p ? 1u : 0u;
    sync();
    unsigned m = 0;
    for (int l = 0; l < G; ++l) m |= bits[base + l] << l;
    return m;
  }
  int warp_max(int v) const {
    sync();
    ints[base + lane] = v;
    sync();
    int m = ints[0];
    for (int l = 1; l < 32; ++l) m = ints[l] > m ? ints[l] : m;
    return m;
  }
};
inline int popc(unsigned m) { return __builtin_popcount(m); }
"""
# Warp by warp, 32 threads each, as on the card (groups of kG lanes, the
# ragged tail's groups rolling sample N − 1 out again and writing
# nothing), in slices filled with NaN first, so that a read before a write
# shows in the output.
DRIVER = """
}  // namespace
extern "C" void cpu_rollout(const float* q0, const float* qd0,
                            int per_sample, const float* U, float* rews,
                            float* bad, float* qs, const float* xref,
                            float* logpd, int N, int H) {
  std::memcpy(&tables, &kTablesInit, sizeof(Tables));
  constexpr int W = 32 / kG;
  std::vector<Slice> slice(W);
  for (int w = 0; w * W < N; ++w) {
    std::memset(slice.data(), 0xff, W * sizeof(Slice));
    std::barrier<> bar(32);
    float words[W] = {};
    unsigned bits[32] = {};
    int ints[32] = {};
    std::vector<std::thread> lanes;
    for (int t = 0; t < 32; ++t)
      lanes.emplace_back([&, t] {
        const int grp = t / kG, n = w * W + grp;
        const Group<kG> g{t % kG, t - t % kG, &bar, words, bits, ints};
        rollout_sample<kG>(g, slice[grp], n < N ? n : N - 1, n < N, q0, qd0,
                           per_sample, U, rews, bad, qs, xref, logpd, N, H);
      });
    for (auto& t : lanes) t.join();
  }
}
"""
ATOL = 2e-6
N = 130


def _cpu_kernel(env, out_dir, G):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    with open(os.path.join(rollout_cuda.CSRC, "rollout.cu")) as f:
        src = f.read()
    src = src.replace("#include <cuda_runtime.h>", SHIM)
    src = src.replace('#include "model.h"',
                      rollout_cuda.model_header(env, G))
    a = src.index("// --- begin group ---")
    b = src.index("// --- end group ---")
    src = src[:a] + GROUP + src[b:src.index("// --- launch ---")] + DRIVER
    cpp, so = os.path.join(out_dir, "k.cpp"), os.path.join(out_dir, "k.so")
    with open(cpp, "w") as f:
        f.write(src)
    proc = subprocess.run(
        [gxx, "-O1", "-ffp-contract=off", "-std=c++20", "-pthread",
         "-shared", "-fPIC", "-Wno-unknown-pragmas", "-o", so,
         cpp], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lib = ctypes.CDLL(so)
    lib.cpu_rollout.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] + \
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2
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


# pushT: the slider's bars as (centre in the slider's frame, half-sizes)
# in the model's geom order, and the pusher's radius
PUSHT_BARS = (((0.0, 0.0), (0.15, 0.05)), ((-0.1, 0.0), (0.05, 0.15)))
PUSHER_R = 0.05


def _pusht_inputs(sys, gen, rotate):
    """Per-sample q0/qd0 for pushT (module docstring), cycling over four
    placements of the pusher in the slider's frame: inside the long bar,
    inside the cross bar, within the radius outside the long bar's end or
    side, and clear of the T; unrotated, the last two samples tie two
    faces exactly."""
    def u(lo, hi):
        return torch.rand(N, generator=gen) * (hi - lo) + lo

    kind = torch.arange(N) % 4
    side = torch.rand(N, generator=gen) < 0.5
    gap = u(0.002, 0.045)
    local = torch.stack([
        torch.where(kind == 0, u(-0.145, 0.145), torch.where(
            kind == 1, u(-0.145, -0.055), torch.where(
                kind == 2, torch.where(side, 0.15 + gap, u(-0.05, 0.14)),
                u(0.3, 0.5)))),
        torch.where(kind == 0, u(-0.045, 0.045), torch.where(
            kind == 1, u(-0.145, 0.145), torch.where(
                kind == 2, torch.where(side, u(-0.045, 0.045), 0.05 + gap),
                u(-0.5, 0.5))))])
    q = sys.init_q[:, None].repeat(1, N).clone()
    q[2:4] = u(-0.3, 0.3)[None].repeat(2, 1) * torch.tensor([[1.0], [-1.0]])
    q[4] = u(-math.pi, math.pi) if rotate else 0.0
    c, s = torch.cos(q[4].double()), torch.sin(q[4].double())
    q[0] = q[2] + (c * local[0] - s * local[1]).float()
    q[1] = q[3] + (s * local[0] + c * local[1]).float()
    q[5:7] = u(-0.5, 0.5)[None].repeat(2, 1)
    if not rotate:
        # two exact ties of the long bar's x and y faces (both 1/32 deep,
        # the slider at the origin): the x face must win, as in argmin
        tie = torch.tensor([0.15, 0.05]) - 1.0 / 32
        q[:5, -2:] = 0.0
        q[:2, -2] = tie
        q[:2, -1] = -tie
    qd = torch.randn((sys.nv, N), generator=gen) * 0.5
    return q.contiguous(), qd.contiguous()


def _pusht_branches(q, lift=0.0):
    """Per sample and bar, whether the pusher's centre lies inside the bar
    and, if so, the axis of its nearest face (0, 1 or 2, ties to the lowest,
    as torch.argmin), or −1 outside; and whether a pair outside is within
    the pusher's radius."""
    q = q.double()
    c, s = torch.cos(q[4]), torch.sin(q[4])
    dx, dy = q[0] - q[2], q[1] - q[3]
    faces, touching = [], []
    for (ox, oy), (hx, hy) in PUSHT_BARS:
        lx, ly = c * dx + s * dy - ox, -s * dx + c * dy - oy
        pl = torch.stack([lx, ly, torch.full_like(lx, lift)])
        half = torch.tensor([hx, hy, 0.05], dtype=q.dtype)[:, None]
        inside = (pl.abs() <= half).all(0)
        faces.append(torch.where(inside, torch.argmin(half - pl.abs(), 0),
                                 -1))
        out = (pl.abs() - half).clamp_min(0).norm(dim=0)
        touching.append(~inside & (out < PUSHER_R))
    return torch.stack(faces), torch.stack(touching)


def _run(name, out_dir, need_qs=False, demo=False, sys=None, inputs=None,
         G=None):
    """One substep of the kernel source and of the plain version from the
    same inputs: (kernel outputs, plain outputs), each (rews [N, 1],
    bad[, qs][, logpd]). ``sys`` replaces the env's model; ``inputs(sys,
    gen)`` makes q0/qd0 (default ``_inputs``); G lanes per sample (default
    the env's)."""
    env = envs.get_env(name, device="cpu")
    env.n_frames = 1
    if sys is not None:
        env.sys = sys
    lib = _cpu_kernel(env, out_dir, G or env.kernel_group)
    gen = torch.Generator().manual_seed(0)
    q0, qd0 = (inputs or _inputs)(env.sys, gen)
    Y0s = 2 * torch.rand((N, 1, env.action_size), generator=gen) - 1
    U = Y0s.permute(1, 2, 0).contiguous()
    rews, bad = torch.empty((1, N)), torch.empty(N)
    qs = torch.empty((1, env.sys.nq, N)) if need_qs else None
    logpd = torch.empty(N) if demo else None
    xref = env.xref_frames if demo else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib.cpu_rollout(q0.data_ptr(), qd0.data_ptr(), 1, U.data_ptr(),
                    rews.data_ptr(), bad.data_ptr(), ptr(qs), ptr(xref),
                    ptr(logpd), N, 1)
    state = SimpleNamespace(pipeline_state=SimpleNamespace(q=q0, qd=qd0))
    plain = rollout_outputs(env, state, Y0s, need_qs=need_qs, demo=demo)
    kernel = (rews.t(), bad) + tuple(t for t in (qs, logpd) if t is not None)
    assert torch.isfinite(rews).all()
    assert torch.equal(kernel[1], plain[1])
    assert float((kernel[0] - plain[0]).abs().max()) <= ATOL
    return kernel, plain, q0


@pytest.mark.parametrize("name", ["hopper", "walker2d", "halfcheetah",
                                  "cartpole", "ant", "humanoidrun",
                                  "humanoidstandup", "humanoidtrack",
                                  "pushT"])
def test_kernel_source_matches_plain_version(name, tmp_path):
    if name != "pushT":
        _run(name, str(tmp_path))
        return
    _, _, q0 = _run(name, str(tmp_path),
                    inputs=lambda sys, gen: _pusht_inputs(sys, gen, False))
    faces, touching = _pusht_branches(q0)
    assert set(faces.unique().tolist()) == {-1, 0, 1}   # both branches
    assert bool(touching.any())


def test_kernel_source_sphere_box_z_face(tmp_path, rounded_math):
    """The pusher's geom raised by 0.03 (pl_z = 0.03): the z face is the
    nearest for some samples inside a bar. The pusher has no z slide, so a
    z-face contact's row has a near-zero effective inverse mass and sends
    those samples off at ~1e7; the rewards are held bit for bit, so their
    size does not loosen the check."""
    sys = envs.get_env("pushT", device="cpu").sys
    gpos = sys.geom_pos.clone()
    gpos[1, 2] = 0.03                      # geom 1: the pusher
    kernel, plain, q0 = _run(
        "pushT", str(tmp_path), sys=sys.replace(geom_pos=gpos),
        inputs=lambda sys, gen: _pusht_inputs(sys, gen, False))
    assert torch.equal(kernel[0], plain[0])
    faces, _ = _pusht_branches(q0, lift=0.03)
    assert {0, 1, 2} <= set(faces.unique().tolist())


def test_kernel_source_sphere_box_rotated(tmp_path, rounded_math):
    """pushT with the slider turned by an angle in (−π, π) per sample: the
    box frame's columns are live, and the trace is held bit for bit."""
    kernel, plain, q0 = _run(
        "pushT", str(tmp_path), need_qs=True,
        inputs=lambda sys, gen: _pusht_inputs(sys, gen, True))
    assert torch.equal(kernel[0], plain[0])
    assert torch.equal(kernel[2], plain[2])
    faces, touching = _pusht_branches(q0)
    assert set(faces.unique().tolist()) == {-1, 0, 1}
    assert bool(touching.any())


@pytest.fixture
def rounded_math(monkeypatch):
    """The plain engine with float32 sqrt, sin and cos taken in double and
    rounded once. The position trace reads what the one-substep inputs
    avoid elsewhere: the integrator's sin and cos of the root's new
    angular speed, and torch's CPU sqrt (module docstring). With these,
    the kernel source and the plain version agreed exactly on every model
    tried (hopper, ant, humanoidrun, humanoidtrack: trace, rewards and
    demo score)."""
    for name in ("sqrt", "sin", "cos"):
        fn = getattr(torch, name)
        monkeypatch.setattr(torch, name,
                            lambda x, fn=fn: fn(x.double()).float())


@pytest.mark.parametrize("name", ["hopper", "humanoidtrack"])
def test_kernel_source_trace_is_plain_trace(name, tmp_path, rounded_math):
    """need_qs: the kernel's position trace is the plain version's, bit
    for bit."""
    kernel, plain, _ = _run(name, str(tmp_path), need_qs=True)
    assert torch.equal(kernel[2], plain[2])


def test_kernel_source_demo_logpd(tmp_path, rounded_math):
    """demo on humanoidtrack: the kernel's running score against
    ``traj_xref_logpd_qs`` of the plain trace, at atol 2e-6 (the order of
    the sums differs: a left-to-right running sum in the kernel,
    ``linalg.norm`` and ``mean`` in torch)."""
    kernel, plain, _ = _run("humanoidtrack", str(tmp_path), need_qs=True,
                            demo=True)
    assert torch.equal(kernel[2], plain[2])
    assert float((kernel[3] - plain[3]).abs().max()) <= 2e-6
    assert float(kernel[3].std()) > 0


def _past_limits(sys, gen):
    """``_inputs`` with every limited hinge below its range in a fifth of
    the samples, above it in another fifth, and inside it in the rest."""
    q, qd = _inputs(sys, gen)
    jrange = sys.host("jnt_range")
    for j in range(sys.njnt):
        if sys.jnt_type[j] != HINGE or not sys.jnt_limited[j]:
            continue
        lo, hi = (float(v) for v in jrange[j])
        pick = torch.rand(N, generator=gen)
        past = torch.rand(N, generator=gen) * 0.1
        inside = lo + (hi - lo) * torch.rand(N, generator=gen)
        q[sys.jnt_qposadr[j]] = torch.where(
            pick < 0.2, lo - past, torch.where(pick < 0.4, hi + past, inside))
    return q.contiguous(), qd


@pytest.fixture
def libm_math(monkeypatch):
    """The plain engine with float32 sqrt, sin and cos from the C library
    the kernel source calls (sqrtf, sinf, cosf), element by element. The
    hinges' angles below are not 0, and on some of them glibc's sinf is not
    the correctly rounded value that ``rounded_math`` takes, so the plain
    version takes the kernel's own, as on the card, where both call the
    same sinf."""
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    for name in ("sqrt", "sin", "cos"):
        fn = getattr(libm, name + "f")
        fn.restype, fn.argtypes = ctypes.c_float, [ctypes.c_float]
        monkeypatch.setattr(torch, name, lambda x, fn=fn: torch.tensor(
            [fn(v) for v in x.reshape(-1).tolist()],
            dtype=x.dtype).reshape(x.shape))


@pytest.mark.parametrize("G", [8, 16, 32])
def test_kernel_source_active_and_inactive_rows(G, tmp_path, libm_math):
    """humanoidrun with hinges past their limits and feet in the floor in
    some samples, within range and clear in others: active and inactive
    rows of both kinds in one batch, the inactive ones dropped from the
    solves and the sweep; rewards and the trace bit for bit."""
    from mbd_tpu_torch.sim import batched as BT

    kernel, plain, q0 = _run("humanoidrun", str(tmp_path), need_qs=True,
                             inputs=_past_limits, G=G)
    assert torch.equal(kernel[0], plain[0])
    assert torch.equal(kernel[2], plain[2])
    sys = envs.get_env("humanoidrun", device="cpu").sys
    jrange = sys.host("jnt_range")
    past = torch.stack([(q0[sys.jnt_qposadr[j]] < float(jrange[j, 0])) |
                        (q0[sys.jnt_qposadr[j]] > float(jrange[j, 1]))
                        for j in range(sys.njnt)
                        if sys.jnt_type[j] == HINGE and sys.jnt_limited[j]])
    depth = torch.stack([c.depth for c in BT.collide_b(sys, BT.fk_b(sys,
                                                                   q0))])
    # per sample, some limit rows and some contacts active, others not
    assert bool((past.any(0) & ~past.all(0)).all())
    assert bool((depth > 0).any()) and bool((depth <= 0).any())
