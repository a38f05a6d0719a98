"""The CUDA rollout kernel's source (mbd_tpu_torch/csrc/rollout.cu) run as
plain C++ on the CPU, against the torch engine it follows term for term.

The kernel body needs nothing of CUDA but its keywords and its group's
barrier, broadcast, ballot and warp maximum, so a tiny shim turns
``__global__``/``__device__`` into nothing, puts 32 fibers on one thread
in place of a warp's lanes (``SHIM``'s ``fiber``: each lane started on its
own stack by glibc's ``ucontext``, switched by ``_setjmp``/``_longjmp``; a
barrier hands over to the next lane, so no lane leaves one before its
whole warp has reached it, and a warp whose lanes took unequal numbers of
barriers is an error), drops the launch code and runs ``rollout_sample``
warp by warp, 32/G samples each, the ragged tail's groups as on the card,
at the env's G (``kernel_group``) unless a case names another; cases of
one model, G and substeps share one build.
g++ builds it with ``-ffp-contract=off`` (no fused multiply–add, as
``nvcc --fmad=false``) and ``-std=c++17``, as nvcc; float arithmetic on
x86-64 is IEEE single, as on the card. Only sin and cos come from another
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

The retiring form (``rollout_retiring``) runs on the card's humanoid states
with fewer warps resident than its samples need, side by side, each
warp's groups taking samples from one queue (``atomicAdd`` as a
``__atomic_fetch_add``), and is held against the whole form and the
plain version's ``retire`` output. The fibers interleave the warps in one
fixed order, a phase of each in turn, so races between warps do not show
here: the card's retiring cases (``tests/test_torch_cuda.py``) test them.

Skips where g++ is missing.
"""

import ctypes
import ctypes.util
import math
import os
import shutil
import subprocess
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mbd_tpu_torch import envs
from mbd_tpu_torch.ops import rollout_cuda
from mbd_tpu_torch.rollout.fused import rollout_outputs, rollout_qs
from mbd_tpu_torch.sim.system import FREE, HINGE, SLIDE

SHIM = """
#include <setjmp.h>
#include <sys/mman.h>
#include <ucontext.h>
#include <cmath>
#include <cstring>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __shared__
inline int atomicAdd(int* p, int v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
inline float __int_as_float(int i) {
  float f;
  std::memcpy(&f, &i, sizeof f);
  return f;
}
// The lanes of the resident warps as fibers on one thread, each with its
// own stack. A lane runs to its next barrier (sync) and hands over to the
// next lane in the ring that has not finished: lane 31 of a warp to lane 0
// of the next warp, the last warp's to the first's. So every lane moves
// one phase a turn, warp by warp, and no lane leaves a barrier before
// every lane of its warp has reached it. A lane starts on its stack by
// ucontext (makecontext, setcontext) and switches by _setjmp / _longjmp,
// which leave the signal mask alone: swapcontext would set it, a system
// call at every one of the tens of millions of switches the cases take.
namespace fiber {
constexpr size_t kPage = 4096, kStack = size_t{1} << 20;
struct Lane {
  ucontext_t start;
  jmp_buf at;
  char* stack;
  long syncs;
  bool started, done;
};
std::vector<Lane>* ring;
void (*body)(void*, int, int);
void* arg;
int cur;
jmp_buf home;

// to lane i: its start the first time, then where it left
[[noreturn]] inline void go(int i) {
  Lane& l = (*ring)[cur = i];
  if (l.started) _longjmp(l.at, 1);
  l.started = true;
  setcontext(&l.start);
  __builtin_unreachable();
}
// from lane cur to the next lane that has not finished, or home
inline void pass() {
  const int n = static_cast<int>(ring->size()), from = cur;
  for (int k = 1; k <= n; ++k) {
    const int i = (from + k) % n;
    if ((*ring)[i].done) continue;
    if (i == from) return;
    if (!_setjmp((*ring)[from].at)) go(i);
    return;
  }
  _longjmp(home, 1);
}
inline void sync() {
  ++(*ring)[cur].syncs;
  pass();
}
inline void entry() {
  body(arg, cur / 32, cur % 32);
  (*ring)[cur].done = true;
  pass();
}
// `warps` warps' lanes, their stacks (below each, a page that faults)
// kept from one run to the next
struct Warps {
  std::vector<Lane> lanes;
  explicit Warps(int warps) : lanes(32 * warps) {
    for (auto& l : lanes) {
      l.stack = static_cast<char*>(
          mmap(nullptr, kPage + kStack, PROT_READ | PROT_WRITE,
               MAP_PRIVATE | MAP_ANONYMOUS | MAP_NORESERVE, -1, 0));
      mprotect(l.stack, kPage, PROT_NONE);
    }
  }
  ~Warps() {
    for (auto& l : lanes) munmap(l.stack, kPage + kStack);
  }
  // f(warp, lane) on every lane to its end: 0, or 1 where the lanes of a
  // warp took unequal numbers of barriers (on the card, undefined)
  template <class F>
  int run(F f) {
    for (auto& l : lanes) {
      l.syncs = 0;
      l.started = l.done = false;
      getcontext(&l.start);
      l.start.uc_stack.ss_sp = l.stack + kPage;
      l.start.uc_stack.ss_size = kStack;
      l.start.uc_link = nullptr;  // entry ends in pass(), never returns
      makecontext(&l.start, entry, 0);
    }
    ring = &lanes;
    body = [](void* p, int w, int l) { (*static_cast<F*>(p))(w, l); };
    arg = &f;
    if (!_setjmp(home)) go(0);
    for (size_t i = 0; i < lanes.size(); ++i)
      if (lanes[i].syncs != lanes[i - i % 32].syncs) return 1;
    return 0;
  }
};
}  // namespace fiber
"""
# A warp's lanes as fibers: sync hands over to the next lane
# (``fiber::sync``); shared words for __shfl_sync (one per group),
# __ballot_sync and __reduce_max_sync (one per lane).
GROUP = """
template <int G>
struct Group {
  int lane, base;
  float* words;
  unsigned* bits;
  int* ints;
  void sync() const { fiber::sync(); }
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
# Warp by warp, as on the card (groups of kG lanes, the ragged tail's
# groups rolling sample N − 1 out again and writing nothing), in slices
# filled with NaN first, so that a read before a write shows in the
# output. The ``_rows`` entry points also take the rows buffer, the others
# pass none; ``cpu_rollout_kin`` also copies out each sample's link poses
# and motion subspaces as its last substep left them in its slice
# (kin [N, NB · 7 + NV · 6]: xpos [NB, 3], xquat [NB, 4], S [NV, 6]).
# Each returns ``fiber::Warps::run``'s 0 or 1.
DRIVER = """
}  // namespace
extern "C" int cpu_rollout_kin(const float* q0, const float* qd0,
                               int per_sample, const float* U, float* rews,
                               float* bad, float* qs, const float* xref,
                               float* logpd, float* qd_out, int* first,
                               int* rows, float* kin, int N, int H) {
  std::memcpy(&tables, &kTablesInit, sizeof(Tables));
  constexpr int W = 32 / kG;
  std::vector<Slice> slice(W);
  fiber::Warps warp(1);
  for (int w = 0; w * W < N; ++w) {
    std::memset(slice.data(), 0xff, W * sizeof(Slice));
    float words[W] = {};
    unsigned bits[32] = {};
    int ints[32] = {};
    const int fault = warp.run([&](int, int t) {
      const int grp = t / kG, n = w * W + grp;
      const Group<kG> g{t % kG, t - t % kG, words, bits, ints};
      rollout_sample<kG>(g, slice[grp], n < N ? n : N - 1, n < N, q0, qd0,
                         per_sample, U, rews, bad, qs, xref, logpd, qd_out,
                         first, rows, N, H);
    });
    if (fault) return fault;
    for (int grp = 0; kin != nullptr && grp < W && w * W + grp < N; ++grp) {
      float* k = kin + (w * W + grp) * (NB * 7 + NV * 6);
      std::memcpy(k, slice[grp].xpos, sizeof slice[grp].xpos);
      std::memcpy(k + NB * 3, slice[grp].xquat, sizeof slice[grp].xquat);
      std::memcpy(k + NB * 7, slice[grp].S, sizeof slice[grp].S);
    }
  }
  return 0;
}
extern "C" int cpu_rollout_rows(const float* q0, const float* qd0,
                                int per_sample, const float* U, float* rews,
                                float* bad, float* qs, const float* xref,
                                float* logpd, float* qd_out, int* first,
                                int* rows, int N, int H) {
  return cpu_rollout_kin(q0, qd0, per_sample, U, rews, bad, qs, xref, logpd,
                         qd_out, first, rows, nullptr, N, H);
}
extern "C" int cpu_rollout(const float* q0, const float* qd0, int per_sample,
                           const float* U, float* rews, float* bad, float* qs,
                           const float* xref, float* logpd, float* qd_out,
                           int* first, int N, int H) {
  return cpu_rollout_rows(q0, qd0, per_sample, U, rews, bad, qs, xref, logpd,
                          qd_out, first, nullptr, N, H);
}
// The retiring form with `warps` warps resident at once, side by side:
// their groups start with samples 0 … warps · 32/kG − 1 and take the rest
// from queue[0] (queue[1]: the env steps run), each warp leaving when its
// groups find it empty.
extern "C" int cpu_rollout_retire_rows(const float* q0, const float* qd0,
                                       int per_sample, const float* U,
                                       float* rews, float* bad, int* first,
                                       int* rows, int* queue, int N, int H,
                                       int warps) {
  std::memcpy(&tables, &kTablesInit, sizeof(Tables));
  constexpr int W = 32 / kG;
  std::vector<Slice> slice(warps * W);
  std::vector<Book> book(warps * W);
  std::memset(slice.data(), 0xff, warps * W * sizeof(Slice));
  std::memset(book.data(), 0xff, warps * W * sizeof(Book));
  std::vector<float> words(warps * W);
  std::vector<unsigned> bits(warps * 32);
  std::vector<int> ints(warps * 32);
  queue[0] = queue[1] = 0;
  return fiber::Warps(warps).run([&](int w, int l) {
    const int grp = w * W + l / kG;
    const Group<kG> g{l % kG, l - l % kG, &words[w * W], &bits[w * 32],
                      &ints[w * 32]};
    rollout_retiring<kG>(g, slice[grp], book[grp], grp, q0, qd0, per_sample,
                         U, rews, bad, first, rows, queue, warps * W, N, H);
  });
}
extern "C" int cpu_rollout_retire(const float* q0, const float* qd0,
                                  int per_sample, const float* U, float* rews,
                                  float* bad, int* first, int* queue, int N,
                                  int H, int warps) {
  return cpu_rollout_retire_rows(q0, qd0, per_sample, U, rews, bad, first,
                                 nullptr, queue, N, H, warps);
}
"""
# each entry point's arguments: pointers, ints
ENTRIES = {
    "cpu_rollout": [ctypes.c_void_p] * 2 + [ctypes.c_int] +
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 2,
    "cpu_rollout_rows": [ctypes.c_void_p] * 2 + [ctypes.c_int] +
    [ctypes.c_void_p] * 9 + [ctypes.c_int] * 2,
    "cpu_rollout_kin": [ctypes.c_void_p] * 2 + [ctypes.c_int] +
    [ctypes.c_void_p] * 10 + [ctypes.c_int] * 2,
    "cpu_rollout_retire": [ctypes.c_void_p] * 2 + [ctypes.c_int] +
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3,
    "cpu_rollout_retire_rows": [ctypes.c_void_p] * 2 + [ctypes.c_int] +
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3,
}
# The group's shuffle, ballot and warp maximum alone: `warps` warps of
# groups of kG lanes side by side, `rounds` of each op back to back from
# every lane, in [round, warp, lane] order; with extra ≥ 0, warp 0's lane
# extra takes one barrier more than the others.
GROUP_DRIVER = """
extern "C" int cpu_group_ops(const float* v, const int* p, const int* x,
                             const int* src, float* bc, unsigned* bal,
                             int* mx, int rounds, int warps, int extra) {
  std::vector<float> words(warps * 32 / kG);
  std::vector<unsigned> bits(warps * 32);
  std::vector<int> ints(warps * 32);
  return fiber::Warps(warps).run([&](int w, int l) {
    const Group<kG> g{l % kG, l - l % kG, &words[w * 32 / kG], &bits[w * 32],
                      &ints[w * 32]};
    const auto at = [&](int r) { return (r * warps + w) * 32 + l; };
    for (int r = 0; r < rounds; ++r) bc[at(r)] = g.bcast(v[at(r)], src[r]);
    for (int r = 0; r < rounds; ++r) bal[at(r)] = g.ballot(p[at(r)] != 0);
    for (int r = 0; r < rounds; ++r) mx[at(r)] = g.warp_max(x[at(r)]);
    if (w == 0 && l == extra) g.sync();
  });
}
"""
ATOL = 2e-6
N = 130
# the libraries built, by source: cases of one model, G and substeps share
# one build
BUILT = {}


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
    if src not in BUILT:
        BUILT[src] = _build(gxx, src, out_dir, ENTRIES)
    return BUILT[src]


def _build(gxx, src, out_dir, entries):
    """g++'s shared library of ``src``, its ``entries`` (name: argument
    types) as functions that raise where the shim returns 1. Without
    ``_FORTIFY_SOURCE``, whose checked longjmp refuses a jump to another
    lane's stack."""
    cpp, so = os.path.join(out_dir, "k.cpp"), os.path.join(out_dir, "k.so")
    with open(cpp, "w") as f:
        f.write(src)
    proc = subprocess.run(
        [gxx, "-O1", "-U_FORTIFY_SOURCE", "-ffp-contract=off", "-std=c++17",
         "-shared", "-fPIC", "-Wno-unknown-pragmas", "-o", so, cpp],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lib = ctypes.CDLL(so)

    def checked(fn):
        def call(*args):
            assert fn(*args) == 0, \
                "the lanes of a warp took unequal numbers of barriers"
        return call

    out = {}
    for name, argtypes in entries.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        out[name] = checked(fn)
    return SimpleNamespace(**out)


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
         G=None, state_out=False):
    """One substep of the kernel source and of the plain version from the
    same inputs: (kernel outputs, plain outputs), each (rews [N, 1],
    bad[, qs][, logpd][, qd']). ``sys`` replaces the env's model;
    ``inputs(sys, gen)`` makes q0/qd0 (default ``_inputs``); G lanes per
    sample (default the env's); ``state_out``, the state-out mode: the
    velocities after the step, against ``rollout_qs``'s."""
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
    qd_out = torch.empty((env.sys.nv, N)) if state_out else None
    xref = env.xref_frames if demo else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib.cpu_rollout(q0.data_ptr(), qd0.data_ptr(), 1, U.data_ptr(),
                    rews.data_ptr(), bad.data_ptr(), ptr(qs), ptr(xref),
                    ptr(logpd), ptr(qd_out), None, N, 1)
    state = SimpleNamespace(pipeline_state=SimpleNamespace(q=q0, qd=qd0))
    plain = rollout_outputs(env, state, Y0s, need_qs=need_qs, demo=demo)
    if state_out:
        plain += (rollout_qs(env.sys, 1, q0, qd0, U)[1][0],)
    kernel = (rews.t(), bad) + tuple(t for t in (qs, logpd, qd_out)
                                     if t is not None)
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


@pytest.mark.parametrize("name", ["hopper", "humanoidrun", "pushT"])
def test_kernel_source_state_out(name, tmp_path, libm_math):
    """The state-out mode (``env_step_cuda``'s launch: H = 1 with the
    trace and the velocities after the step): q' and qd' are
    ``rollout_qs``'s at H = 1 bit for bit, clamped as it clamps them, and
    the rewards the plain version's; hopper (a planar chain), humanoidrun
    (a free root) and pushT (the sphere–box pairs, the slider turned). The
    plain version takes the C library's sqrtf, sinf and cosf
    (``libm_math``): under ``rounded_math`` the turned slider's qd' was
    off by up to 1.4e-6 in a few samples, where glibc's sinf of its angle
    is not the correctly rounded value (its q' still agreed)."""
    inputs = (lambda sys, gen: _pusht_inputs(sys, gen, True)) \
        if name == "pushT" else None
    kernel, plain, _ = _run(name, str(tmp_path), need_qs=True,
                            inputs=inputs, state_out=True)
    assert torch.equal(kernel[2], plain[2])
    assert torch.equal(kernel[3], plain[3])
    assert float(kernel[3].abs().max()) > 0


def _flag_fixture(H=3):
    """humanoidrun one substep an env step, and the card's humanoid states
    (``assets/humanoid_flags.npz``) with their recorded controls first and
    uniform ones after: (env, fixture, q0 [nq, n], qd0 [nv, n],
    U [H, nu, n])."""
    import torch_flag_check as F

    env = envs.get_env("humanoidrun", device="cpu")
    env.n_frames = 1
    d = F.fixture("humanoidrun")
    q0 = torch.from_numpy(np.ascontiguousarray(d["q"].T))
    qd0 = torch.from_numpy(np.ascontiguousarray(d["qd"].T))
    U = torch.rand((H, env.action_size, q0.shape[1]),
                   generator=torch.Generator().manual_seed(0)) * 2 - 1
    U[0] = torch.from_numpy(d["u"].T)
    return env, d, q0, qd0, U.contiguous()


def test_kernel_source_first_flag(tmp_path):
    """The kernel's first-flag buffer on the card's humanoidrun states
    (``assets/humanoid_flags.npz``), one substep an env step over 3 steps:
    each sample's first flagged env step is the plain version's
    (``rollout_qs``), its flagged states at step 0, and the rewards and
    flags are those of the launch without the buffer, bit for bit."""
    env, d, q0, qd0, U = _flag_fixture()
    lib = _cpu_kernel(env, str(tmp_path), env.kernel_group)
    n, H = q0.shape[1], U.shape[0]
    outs = []
    for first in (None, torch.empty(n, dtype=torch.int32)):
        rews, bad = torch.empty((H, n)), torch.empty(n)
        lib.cpu_rollout(q0.data_ptr(), qd0.data_ptr(), 1, U.data_ptr(),
                        rews.data_ptr(), bad.data_ptr(), None, None, None,
                        None, None if first is None else first.data_ptr(),
                        n, H)
        outs.append((rews, bad, first))
    (rews, bad, _), (rews_c, bad_c, first) = outs
    assert torch.equal(rews.view(torch.int32), rews_c.view(torch.int32))
    assert torch.equal(bad, bad_c)
    assert torch.equal(first,
                       rollout_qs(env.sys, 1, q0, qd0, U, first=True)[3])
    assert torch.equal(first[torch.from_numpy(d["flagged"])],
                       torch.zeros(int(d["flagged"].sum()),
                                   dtype=torch.int32))


def _retiring(tmp_path, warps):
    """The retiring form (``rollout_retiring``) on the fixture's states,
    one substep an env step over 4 steps, with ``warps`` warps resident
    (``warps`` · 32/16 groups of 16 lanes) for 32 samples, so that groups
    take most samples from the queue, the flagged ones ending at step 0:
    flags and first flags are the whole form's; each sample's rewards up
    to and including its first flagged step, and every reward of a clean
    sample, are the whole form's bit for bit; the rest are the NaN of bits
    0x7fffffff; every sample asked the queue once, and the kernel counted
    the steps it ran, each sample's up to its first flag; and all of it is
    the plain version's ``retire`` output (under ``libm_math``, for the
    hinges' angles)."""
    env, d, q0, qd0, U = _flag_fixture(H=4)
    lib = _cpu_kernel(env, str(tmp_path), env.kernel_group)
    n, H = q0.shape[1], U.shape[0]
    assert warps * 32 // env.kernel_group < n
    rews, bad = torch.empty((H, n)), torch.empty(n)
    first = torch.empty(n, dtype=torch.int32)
    lib.cpu_rollout(q0.data_ptr(), qd0.data_ptr(), 1, U.data_ptr(),
                    rews.data_ptr(), bad.data_ptr(), None, None, None, None,
                    first.data_ptr(), n, H)
    rews_r, bad_r = torch.full((H, n), 7.0), torch.empty(n)
    first_r, queue = (torch.empty(k, dtype=torch.int32) for k in (n, 2))
    lib.cpu_rollout_retire(q0.data_ptr(), qd0.data_ptr(), 1, U.data_ptr(),
                           rews_r.data_ptr(), bad_r.data_ptr(),
                           first_r.data_ptr(), queue.data_ptr(), n, H, warps)
    assert queue.tolist() == [n, int(torch.where(first >= 0, first + 1,
                                                 H).sum())]
    assert torch.equal(bad_r, bad) and torch.equal(first_r, first)
    assert bool((first == 0).any()) and bool((first < 0).any())
    flagged = torch.from_numpy(d["flagged"])
    assert bool((first[flagged] == 0).all())
    after = (torch.arange(H)[:, None] > first[None]) & (first >= 0)[None]
    bits, bits_r = rews.view(torch.int32), rews_r.view(torch.int32)
    assert torch.equal(bits_r[~after], bits[~after])
    assert bool((bits_r[after] == 0x7FFFFFFF).all()) and bool(after.any())
    state = SimpleNamespace(pipeline_state=SimpleNamespace(q=q0, qd=qd0))
    plain = rollout_outputs(env, state, U.permute(2, 0, 1).contiguous(),
                            first=True, retire=True)
    assert torch.equal(plain[0].view(torch.int32), bits_r.t())
    assert torch.equal(plain[1], bad_r) and torch.equal(plain[2], first_r)


def test_kernel_source_retiring_form(tmp_path, libm_math):
    """``_retiring`` with 2 warps resident."""
    _retiring(tmp_path, 2)


@pytest.mark.parametrize("warps", [1, 4])
def test_kernel_source_retiring_form_resident_warps(warps, tmp_path,
                                                    libm_math):
    """``_retiring`` with 1 warp resident, whose groups alone drain the
    queue, and with 4 side by side."""
    _retiring(tmp_path, warps)


def _flagging(sys, gen):
    """``_past_limits`` with every fourth sample's first dof at 150, past
    the speed that flags, so that it flags at env step 0 and its later
    env steps start flagged."""
    q, qd = _past_limits(sys, gen)
    qd[0, ::4] = 150.0
    return q, qd.contiguous()


# the models the plain reference (benchmark/reference/models/) carries
REFERENCE_MODELS = ("hopper", "humanoidrun", "humanoidstandup")


@pytest.mark.parametrize("name", ["humanoidstandup", "hopper", "humanoidrun",
                                  "ant", "pushT", "walker2d"])
def test_kernel_source_counts_acting_contact_rows(name, tmp_path, libm_math):
    """The rows buffer: each sample's contact-row substeps whose force
    cap is not 0, in the env steps that start with it unflagged, at the
    env's own substeps over 3 env steps, from states with limits passed,
    capsules (humanoidrun's spheres, ant's) in the floor in some samples
    and clear in others (pushT's pusher inside a bar, touching one or
    clear, the slider turned), and a quarter of the samples flagged at
    step 0. The whole form's and the retiring form's (2 warps resident,
    the rest refills) equal the plain version's count, and where the
    plain reference carries the model its recorder's
    (``benchmark/reference/engine.py``'s ``Recorder``), sample by sample;
    rewards, flags and first flags are the plain version's bit for bit
    (under ``libm_math``, for the moved hinges' angles)."""
    from mbd_tpu_torch.sim import batched as BT

    env = envs.get_env(name, device="cpu")
    lib = _cpu_kernel(env, str(tmp_path), env.kernel_group)
    gen = torch.Generator().manual_seed(0)
    if name == "pushT":
        q0, qd0 = _pusht_inputs(env.sys, gen, True)
        qd0[0, ::4] = 150.0
    else:
        q0, qd0 = _flagging(env.sys, gen)
    H = 3
    Y0s = 2 * torch.rand((N, H, env.action_size), generator=gen) - 1
    U = Y0s.permute(1, 2, 0).contiguous()
    rews, bad = torch.empty((H, N)), torch.empty(N)
    rews_r, bad_r = torch.empty((H, N)), torch.empty(N)
    first, rows, first_r, rows_r = (torch.empty(N, dtype=torch.int32)
                                    for _ in range(4))
    queue = torch.empty(2, dtype=torch.int32)
    lib.cpu_rollout_rows(q0.data_ptr(), qd0.data_ptr(), 1, U.data_ptr(),
                         rews.data_ptr(), bad.data_ptr(), None, None, None,
                         None, first.data_ptr(), rows.data_ptr(), N, H)
    lib.cpu_rollout_retire_rows(
        q0.data_ptr(), qd0.data_ptr(), 1, U.data_ptr(), rews_r.data_ptr(),
        bad_r.data_ptr(), first_r.data_ptr(), rows_r.data_ptr(),
        queue.data_ptr(), N, H, 2)
    state = SimpleNamespace(pipeline_state=SimpleNamespace(q=q0, qd=qd0))
    plain = rollout_outputs(env, state, Y0s, first=True, rows=True)
    assert torch.equal(rews.t().contiguous().view(torch.int32),
                       plain[0].contiguous().view(torch.int32))
    assert torch.equal(bad, plain[1]) and torch.equal(bad_r, bad)
    assert torch.equal(first, plain[2]) and torch.equal(first_r, first)
    assert bool((first == 0).any()) and bool((first < 0).any())
    live = torch.where(first >= 0, first + 1, H)
    assert queue.tolist() == [N, int(live.sum())]
    assert torch.equal(rows, plain[3]) and torch.equal(rows_r, rows)
    n_contacts = len(BT.collide_b(env.sys, BT.fk_b(env.sys, q0)))
    if name in REFERENCE_MODELS:
        from benchmark.reference import models
        from benchmark.reference.rollout import rollout

        _, _, work = rollout(models.load(name, "cpu"), q0, qd0, Y0s,
                             record=True)
        assert torch.equal(work.live_steps, live.float())
        assert torch.equal(rows.float(), work.contacts)
        assert work.n_contacts == n_contacts
    # rows act in some substeps and not in others
    assert 0 < int(rows.sum()) < int(live.sum()) * env.n_frames * n_contacts


def _bent(sys, gen):
    """``_inputs`` with every hinge turned by an angle in (−1, 1) from its
    init angle, so that every joint of forward kinematics moves its body."""
    q, qd = _inputs(sys, gen)
    for j in range(sys.njnt):
        if sys.jnt_type[j] == HINGE:
            q[sys.jnt_qposadr[j]] += torch.rand(N, generator=gen) * 2 - 1
    return q.contiguous(), qd


@pytest.mark.parametrize("G", [8, 16, 32])
@pytest.mark.parametrize("name", ["humanoidrun", "ant", "humanoidtrack",
                                  "pushT", "walker2d"])
def test_kernel_source_fk_by_tree_level(name, G, tmp_path, libm_math,
                                        monkeypatch):
    """Forward kinematics a tree level a phase across the group's lanes
    (``fk_levels``), on the branching trees: the humanoid (levels of 1, 3,
    3, 2, 2, 2 bodies), ant (4 legs), humanoidtrack (its free root beside
    five slid markers) and, split here although the rule keeps them on
    lane 0 (``FK_MIN_SAVED``), pushT (a forest of three roots on slides)
    and walker2d (2 legs), every hinge turned. One substep's link poses and
    motion subspaces, as the substep left them in each sample's slice,
    are the plain engine's ``fk_b`` of the initial state, and its rewards
    and flags the plain version's, bit for bit (under ``libm_math``, for
    the hinges' angles)."""
    from mbd_tpu_torch.sim import batched as BT

    env = envs.get_env(name, device="cpu")
    env.n_frames = 1
    if name in ("pushT", "walker2d"):
        monkeypatch.setattr(rollout_cuda, "FK_MIN_SAVED", 1)
        env.sys = env.sys.replace()       # a model with no stages cached
    assert rollout_cuda.fk_stages(env.sys)
    lib = _cpu_kernel(env, str(tmp_path), G)
    sys, nb, nv = env.sys, env.sys.nbody, env.sys.nv
    gen = torch.Generator().manual_seed(0)
    q0, qd0 = _bent(sys, gen)
    Y0s = 2 * torch.rand((N, 1, env.action_size), generator=gen) - 1
    U = Y0s.permute(1, 2, 0).contiguous()
    rews, bad = torch.empty((1, N)), torch.empty(N)
    kin = torch.empty((N, nb * 7 + nv * 6))
    lib.cpu_rollout_kin(q0.data_ptr(), qd0.data_ptr(), 1, U.data_ptr(),
                        rews.data_ptr(), bad.data_ptr(), None, None, None,
                        None, None, None, kin.data_ptr(), N, 1)
    plain = BT.fk_b(sys, q0)
    xpos, xquat, S = kin.split([nb * 3, nb * 4, nv * 6], dim=1)
    for got, want in ((xpos.reshape(N, nb, 3), plain.xpos),
                      (xquat.reshape(N, nb, 4), plain.xquat),
                      (S.reshape(N, nv, 6), plain.S)):
        want = torch.stack(want).permute(2, 0, 1)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    state = SimpleNamespace(pipeline_state=SimpleNamespace(q=q0, qd=qd0))
    out = rollout_outputs(env, state, Y0s)
    assert torch.equal(rews.t().contiguous().view(torch.int32),
                       out[0].contiguous().view(torch.int32))
    assert torch.equal(bad, out[1])


@pytest.mark.parametrize("G", [8, 16, 32])
def test_fiber_group_ops(G, tmp_path):
    """The shim's ``Group`` on its fibers: 2 warps side by side, 3 rounds
    back to back of a broadcast from a lane of each group, then of a ballot
    and of a warp maximum from every lane, so that a round's shared words
    are written while lanes may still read the last round's: each lane
    gets its own group's lane's value, its group's bits and its own warp's
    maximum (negative ones too); a lane that takes one barrier more than
    the rest of its warp is an error, as on the card it is undefined."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib = _build(gxx, SHIM + f"constexpr int kG = {G};\n" + GROUP +
                 GROUP_DRIVER, str(tmp_path),
                 {"cpu_group_ops": [ptr] * 7 + [i32] * 3})
    rounds, warps = 3, 2
    gen = torch.Generator().manual_seed(G)
    shape = (rounds, warps, 32)
    v = torch.randn(shape, generator=gen)
    p = (torch.rand(shape, generator=gen) < 0.5).to(torch.int32)
    x = torch.randint(-1000, 1000, shape, generator=gen, dtype=torch.int32)
    src = torch.randint(0, G, (rounds,), generator=gen, dtype=torch.int32)
    bc, mx = torch.empty(shape), torch.empty(shape, dtype=torch.int32)
    bal = torch.empty(shape, dtype=torch.int32)
    args = [t.data_ptr() for t in (v, p, x, src, bc, bal, mx)]
    lib.cpu_group_ops(*args, rounds, warps, -1)
    base = torch.arange(32) - torch.arange(32) % G
    lanes = (base[None] + src[:, None]).long()[:, None].expand(shape)
    assert torch.equal(bc, v.gather(2, lanes))
    bit = p.view(rounds, warps, 32 // G, G) << torch.arange(G)
    want = bit.sum(-1).repeat_interleave(G, dim=-1).to(torch.int32)
    assert torch.equal(bal, want)
    assert torch.equal(mx, x.amax(-1, keepdim=True).expand(shape))
    with pytest.raises(AssertionError, match="unequal numbers"):
        lib.cpu_group_ops(*args, rounds, warps, 5)


# the serial steps of forward kinematics a substep: the tree's levels
# where the split engages, else its bodies one after another
FK_STAGES = {"hopper": 4, "cartpole": 2, "walker2d": 7, "halfcheetah": 7,
             "ant": 4, "humanoidrun": 6, "humanoidstandup": 6,
             "humanoidtrack": 7, "pushT": 3}


@pytest.mark.parametrize("name", list(FK_STAGES))
def test_fk_stages_follow_the_tree(name):
    """The header's stages of forward kinematics (``fk_stages``): none
    along a chain (hopper, cartpole), nor where the stages would take
    fewer than ``FK_MIN_SAVED`` bodies off lane 0's chain (walker2d and
    halfcheetah 3, pushT 1), whose builds keep ``fk`` on lane 0 with no
    table of it in shared memory; where the split engages, each depth's
    bodies split by their joints' kinds (humanoidtrack's free root beside
    its five slid markers), every parent one depth up, a barrier after
    each depth's last stage but the deepest; and the serial steps the
    counter reads."""
    env = envs.get_env(name, device="cpu")
    sys = env.sys
    stages = rollout_cuda.fk_stages(sys)
    header = rollout_cuda.model_header(env)
    assert rollout_cuda.fk_serial_stages(sys) == FK_STAGES[name]
    assert f"#define NFK {len(stages)}" in header
    if name in ("hopper", "cartpole", "walker2d", "halfcheetah", "pushT"):
        assert stages == []
        assert "t_fk_body" not in header and "t_body_pos" not in header
        return
    assert "t_fk_body" in header and "t_hinge_pos" in header
    assert sys.nbody - 1 - len(stages) >= rollout_cuda.FK_MIN_SAVED
    depth = {0: 0}
    for b in range(1, sys.nbody):
        depth[b] = depth[sys.body_parentid[b]] + 1
    seen = [b for _, bodies in stages for b in bodies]
    assert sorted(seen) == list(range(1, sys.nbody))
    kinds = rollout_cuda.BT.topo(sys).body_joints
    for d, bodies in stages:
        assert {depth[b] for b in bodies} == {d}
        assert len({tuple(sys.jnt_type[j] for j in kinds[b])
                    for b in bodies}) == 1
    assert [d for d, _ in stages] == sorted(d for d, _ in stages)
    assert max(len(bodies) for _, bodies in stages) >= 2
    sync = dict((t[0], t[2]) for t in rollout_cuda.model_tables(
        sys, env.n_frames, env.kernel_reward)["tables"])["fk_sync"]
    assert sync == [int(a[0] < b[0]) for a, b in zip(stages, stages[1:])] \
        + [0]
