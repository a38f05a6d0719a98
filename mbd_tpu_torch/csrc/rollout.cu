// Whole-rollout kernel for NVIDIA Hopper (sm_90a): every sample's H env
// steps × NFRAMES physics substeps, with the env reward, in one launch.
//
// Replaces the TPU kernel mbd_tpu/ops/rollout_pallas.py::make_rollout_kernel
// (the body `kernel`, launched by `rollout_fn` through pl.pallas_call):
// per-step rewards rews[H, N] and the validity flag bad[N], from a shared
// (q0[nq]) or per-sample (q0[nq, N]) initial state; with need_qs the
// post-step position trace qs[H, nq, N]; with demo the demo-tracking
// log-density logpd[N] against the env's demo frames xref, read at run
// time so that every clip of a model shares one build. A fifth mode of
// the port's own, with no Pallas counterpart, writes the velocities after
// the last step, qd_out[nv, N]: at H = 1 with the trace, one env step
// from a per-sample state, (q', qd'), which RL training steps through
// (mbd_tpu_torch/rl/batched_env.py; JAX takes that step with XLA outside
// Pallas, mbd_tpu/rl/batched_env.py:83-86). Where the caller passes a
// buffer first[N], the launch also writes each sample's first flagged env
// step into it (the recorder's tail count, utils/profiling.py), and where
// it passes rows[N], each sample's contact-row substeps that acted while it
// was live (below). The retiring form (below) stops each sample at its
// first flag.
//
// What bounds it on this card: latency, not bytes. A substep of one sample
// is a few thousand dependent float operations (tens of thousands on the
// humanoids) over a working set of a few KB, and the samples share nothing.
//
// Design. A group of G lanes (a power of two up to 32, kG in model.h,
// the env's kernel_group) serves one sample, so the card
// holds G times as many threads as samples and a substep's latency is
// spread over lanes. The group's working set lives in its slice of shared
// memory (Slice): the state, link poses, motion subspaces, spatial
// inertias, the tree-sparse LᵀDL factor (packed lower triangle), the
// velocities, accelerations and forces of the bodies, and the contact rows.
// A substep runs in phases separated by the group's barrier; within a
// phase the lanes take independent outputs (a body, a dof, a component of
// every body's spatial quantity, a mass-matrix entry, an entry of the
// factor's column update where the factor is large, a contact pair, a
// limit row), and every scalar is
// computed by one lane in the order of the torch engine
// (mbd_tpu_torch/sim/batched.py), term for term. No sum is split across
// lanes, and the library is built with --fmad=false, so the kernel's
// outputs equal the plain version's bit for bit. Forward kinematics runs a
// tree level a phase, the level's bodies across the lanes, where the body
// tree branches (fk_levels), and body after body on lane 0 along a chain;
// the hinges' half-angle sines and cosines, which it needs, are taken
// first, a hinge a lane. The passes that the tree does not let split (the
// final solve and the integrator, the reward and the demo score) run on
// lane 0. Every lane of a warp takes every barrier,
// so the group's barrier is the warp's and a warp's groups keep in step,
// each on its own sample.
//
// Two forms. The whole form (rollout_kernel, every mode) gives each group
// one sample for all H env steps, the groups past N on a copy of the last
// sample with their writes masked. The retiring form
// (rollout_kernel_retire, the planner's reverse step: rewards, flags and
// first flags only) ends a sample at the end of its first flagged env
// step, whose later rewards no planner reads, and hands its group the next
// unstarted sample from a launch-wide queue (one atomicAdd), so that a
// group, and with it its warp and block, is freed for work that is read.
// It runs no more blocks than reside at once, each group to the queue's
// end: under that, the whole form's grid, and only the exit engages.
//
// Only the active constraint rows are solved. A row acts only where its
// force cap is positive (a contact in penetration with a positive reference
// acceleration, a limit past its bound); where the cap is 0, its projected
// force is 0 in every Gauss–Seidel pass and adds exactly nothing to the
// right-hand side, so the row is dropped, as is its M⁻¹Jᵀ solve. A row whose
// cap is NaN stays in. The active rows, in row order (contacts in pair
// order, then limits), go to the lanes in turn; each lane keeps the M⁻¹Jᵀ
// of its rows in registers (⌈NC/G⌉ slots), and in the sweep the lane that
// holds a row sums its M⁻¹Jᵀ·rhs in dof order, broadcasts the force step,
// and the lanes update the right-hand side by dof. Counted (rows passed),
// lane 0 adds after each substep the contact rows whose cap is not 0 to
// its slice's count, in the env steps that start with the sample unflagged,
// as benchmark/reference/engine.py's Recorder counts them: shared memory,
// read and written only then, so that the substep holds no register more.
//
// The model arrives as a generated header ("model.h", see
// ops/rollout_cuda.py) of sizes and tables, each with a constexpr accessor
// for the loops over the topology, which unroll at compile time over
// per-model lists (static_for), and, for the tables a lane reads at a
// run-time index, an accessor t_<name> into a copy that each block keeps
// in shared memory. Joints: free, hinge and slide, in one tree or a
// forest of roots. Pairs: plane–sphere, plane–capsule, capsule–capsule and
// sphere–box (pushT's pusher against the slider's bars). Rewards: one
// branch per env (kReward, model.h).

#include <cuda_runtime.h>

#include <atomic>
#include <type_traits>

#include "model.h"

namespace {

constexpr int kThreads = 128;
// Up to this many updates the LᵀDL factor runs on lane 0, above it column
// by column across lanes: on an H100 lane 0 was the faster on hopper (35
// updates) and pushT (9), the columns on the humanoids (778) (PERF.md,
// PR 5).
constexpr int kSerialFactor = 100;
// the push reward's |Δθ|/π as a product with the float32 reciprocal
constexpr float kInvPi = 1.0f / 3.14159265358979323846f;

// fn(std::integral_constant<int, i>()) for i = Begin, Begin + Step, …
// short of End, unrolled by the compiler's front end. Each index is a
// constant expression, so a loop over one of the model's lists (model.h)
// makes code for the list's entries only: nvcc's own unroller would first
// copy the loop body for every index pair and only then drop the copies
// that a test rules out, which made the humanoids' builds take minutes.
template <int Begin, int End, int Step = 1, class Fn>
__device__ __forceinline__ void static_for(Fn&& fn) {
  if constexpr (Step > 0 ? Begin < End : Begin > End) {
    fn(std::integral_constant<int, Begin>());
    static_for<Begin + Step, End, Step>(fn);
  }
}
#define IDX(c) decltype(c)::value

__device__ __forceinline__ float tmax(float a, float b) {
  // NaN-propagating max (torch.maximum / clamp_min semantics)
  return (a != a) ? a : ((b != b) ? b : (a > b ? a : b));
}

__device__ __forceinline__ float tmin(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : (a < b ? a : b));
}

__device__ __forceinline__ void cross3(const float* a, const float* b,
                                       float* o) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

__device__ __forceinline__ void qmul(const float* a, const float* b,
                                     float* o) {
  o[0] = a[0] * b[0] - a[1] * b[1] - a[2] * b[2] - a[3] * b[3];
  o[1] = a[0] * b[1] + a[1] * b[0] + a[2] * b[3] - a[3] * b[2];
  o[2] = a[0] * b[2] - a[1] * b[3] + a[2] * b[0] + a[3] * b[1];
  o[3] = a[0] * b[3] + a[1] * b[2] - a[2] * b[1] + a[3] * b[0];
}

// v + w·t + qv×t with t = 2·(qv×v)
__device__ __forceinline__ void qrot(const float* q, const float* v,
                                     float* o) {
  float t[3], c[3];
  cross3(q + 1, v, t);
  t[0] = 2.0f * t[0];
  t[1] = 2.0f * t[1];
  t[2] = 2.0f * t[2];
  cross3(q + 1, t, c);
#pragma unroll
  for (int k = 0; k < 3; ++k) o[k] = v[k] + q[0] * t[k] + c[k];
}

// third column of R(q): the geom's local z axis in the world
__device__ __forceinline__ void zhat(const float* q, float* o) {
  const float w = q[0], x = q[1], y = q[2], z = q[3];
  o[0] = 2.0f * (x * z + w * y);
  o[1] = 2.0f * (y * z - w * x);
  o[2] = 1.0f - 2.0f * (x * x + y * y);
}

// the columns of R(q): col[k] is the body's local k axis in the world
__device__ __forceinline__ void quat_cols(const float* q, float (&col)[3][3]) {
  const float w = q[0], x = q[1], y = q[2], z = q[3];
  col[0][0] = 1.0f - 2.0f * (y * y + z * z);
  col[0][1] = 2.0f * (x * y + w * z);
  col[0][2] = 2.0f * (x * z - w * y);
  col[1][0] = 2.0f * (x * y - w * z);
  col[1][1] = 1.0f - 2.0f * (x * x + z * z);
  col[1][2] = 2.0f * (y * z + w * x);
  col[2][0] = 2.0f * (x * z + w * y);
  col[2][1] = 2.0f * (y * z - w * x);
  col[2][2] = 1.0f - 2.0f * (x * x + y * y);
}

// Spatial inertia about the world origin, stored as
// [R (3×3 row-major), h = m·c (3), m]: I = [[R, h×ᵀ... ], ...] with the
// top-right block m·c× and the bottom-right block m·1 (see
// sim/batched.py::spatial_inertia_all).
constexpr int kIn = 13;

// I·v for a spatial inertia in the packed form; zero blocks are skipped
// (adding ±0 leaves a finite sum unchanged).
__device__ __forceinline__ void matvec6(const float* I, const float* v,
                                        float* o) {
  const float* R = I;
  const float hx = I[9], hy = I[10], hz = I[11], m = I[12];
  o[0] = R[0] * v[0] + R[1] * v[1] + R[2] * v[2] + (-hz) * v[4] + hy * v[5];
  o[1] = R[3] * v[0] + R[4] * v[1] + R[5] * v[2] + hz * v[3] + (-hx) * v[5];
  o[2] = R[6] * v[0] + R[7] * v[1] + R[8] * v[2] + (-hy) * v[3] + hx * v[4];
  o[3] = hz * v[1] + (-hy) * v[2] + m * v[3];
  o[4] = (-hz) * v[0] + hx * v[2] + m * v[4];
  o[5] = hy * v[0] + (-hx) * v[1] + m * v[5];
}

// [va×ma, va×ml + vl×ma]
__device__ __forceinline__ void crm(const float* v, const float* m,
                                    float* o) {
  float a[3], b[3];
  cross3(v, m, o);
  cross3(v, m + 3, a);
  cross3(v + 3, m, b);
#pragma unroll
  for (int k = 0; k < 3; ++k) o[3 + k] = a[k] + b[k];
}

// [va×fa + vl×fl, va×fl]
__device__ __forceinline__ void crf(const float* v, const float* f,
                                    float* o) {
  float a[3], b[3];
  cross3(v, f, a);
  cross3(v + 3, f + 3, b);
#pragma unroll
  for (int k = 0; k < 3; ++k) o[k] = a[k] + b[k];
  cross3(v, f + 3, o + 3);
}

// the packed lower triangle of an NV × NV matrix: entry (i, j ≤ i)
__host__ __device__ constexpr int tri(int i, int j) {
  return i * (i + 1) / 2 + j;
}
constexpr int kTri = NV * (NV + 1) / 2;
// no zero-length arrays
constexpr int kNC1 = NC > 0 ? NC : 1;
constexpr int kNCon1 = NCON > 0 ? NCON : 1;
constexpr int kNU1 = NU > 0 ? NU : 1;
constexpr int kNH1 = kNH > 0 ? kNH : 1;

// Solve (LᵀDL) x = x in place along the dof tree (sim/batched.py::ldl_solve
// with structural zeros as 0), F the packed factor. anc(i, ·) walks i's
// dof-tree ancestors from the parent up, the order of the torch engine's
// parent loop. The empty asm at each dof keeps the compiler from loading
// the whole factor ahead into registers, which on the humanoids spilled
// to local memory.
__device__ __forceinline__ void ldl_solve(const float* F, float* x) {
  static_for<NV - 1, -1, -1>([&](auto I) {
    constexpr int i = IDX(I);
    asm volatile("" ::: "memory");
    static_for<0, n_anc(i)>([&](auto M) {
      constexpr int j = anc(IDX(I), IDX(M));
      x[j] = x[j] - F[tri(IDX(I), j)] * x[IDX(I)];
    });
  });
#pragma unroll
  for (int i = 0; i < NV; ++i) x[i] = x[i] / F[tri(i, i)];
  static_for<0, NV>([&](auto I) {
    constexpr int i = IDX(I);
    asm volatile("" ::: "memory");
    static_for<0, n_anc(i)>([&](auto M) {
      constexpr int j = anc(IDX(I), IDX(M));
      x[IDX(I)] = x[IDX(I)] - F[tri(IDX(I), j)] * x[j];
    });
  });
}

// A body's pose before its joints: its parent's (ppos, pquat) moved by the
// body's offset (bp, bq) (sim/batched.py::fk_b).
__device__ __forceinline__ void body_frame(const float* ppos,
                                           const float* pquat,
                                           const float* bp, const float* bq,
                                           float* pos, float* quat) {
  float c[3];
  qrot(pquat, bp, c);
#pragma unroll
  for (int k = 0; k < 3; ++k) pos[k] = ppos[k] + c[k];
  qmul(pquat, bq, quat);
}

// One joint of forward kinematics (sim/batched.py::fk_b): a joint of kind
// kKind at q[qa] and dof da, with its axis ax and anchor jp in the body's
// frame and q0 its initial coordinate, moves the body's pose (pos, quat) in
// place and, with kMotion, writes its dofs' motion subspaces S ([angular,
// linear] about the world origin). dq_pre is a hinge's half-angle rotation
// where it was taken beforehand (the substep), else null.
template <int kKind, bool kMotion>
__device__ __forceinline__ void joint_fk(const float* q, int qa, int da,
                                         const float* ax, const float* jp,
                                         float q0, const float* dq_pre,
                                         float* pos, float* quat,
                                         float (*S)[6]) {
  if constexpr (kKind == kFree) {
    // position and unit quaternion from q; 3 linear, then 3 angular
    // columns (the rotation's columns c_k, paired with pos × c_k)
#pragma unroll
    for (int k = 0; k < 3; ++k) pos[k] = q[qa + k];
    const float qn = sqrtf(q[qa + 3] * q[qa + 3] + q[qa + 4] * q[qa + 4] +
                           q[qa + 5] * q[qa + 5] + q[qa + 6] * q[qa + 6]);
#pragma unroll
    for (int k = 0; k < 4; ++k) quat[k] = q[qa + 3 + k] / qn;
    const float w = quat[0], x = quat[1], y = quat[2], z = quat[3];
    const float col[3][3] = {
        {1.0f - 2.0f * (y * y + z * z), 2.0f * (x * y + w * z),
         2.0f * (x * z - w * y)},
        {2.0f * (x * y - w * z), 1.0f - 2.0f * (x * x + z * z),
         2.0f * (y * z + w * x)},
        {2.0f * (x * z + w * y), 2.0f * (y * z - w * x),
         1.0f - 2.0f * (x * x + y * y)}};
    if constexpr (kMotion) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
#pragma unroll
        for (int m = 0; m < 3; ++m) {
          S[da + k][m] = 0.0f;
          S[da + k][3 + m] = (m == k) ? 1.0f : 0.0f;
          S[da + 3 + k][m] = col[k][m];
        }
        cross3(pos, col[k], S[da + 3 + k] + 3);
      }
    }
  } else {
    float axis_w[3];
    qrot(quat, ax, axis_w);
    if constexpr (kKind == kHinge) {
      float c[3], anchor[3], dq[4], nq[4];
      qrot(quat, jp, c);
#pragma unroll
      for (int k = 0; k < 3; ++k) anchor[k] = pos[k] + c[k];
      if (dq_pre != nullptr) {
#pragma unroll
        for (int k = 0; k < 4; ++k) dq[k] = dq_pre[k];
      } else {
        const float theta = q[qa] - q0;
        const float s = sinf(0.5f * theta);
        dq[0] = cosf(0.5f * theta);
        dq[1] = ax[0] * s;
        dq[2] = ax[1] * s;
        dq[3] = ax[2] * s;
      }
      qmul(quat, dq, nq);
#pragma unroll
      for (int k = 0; k < 4; ++k) quat[k] = nq[k];
      qrot(quat, jp, c);
#pragma unroll
      for (int k = 0; k < 3; ++k) pos[k] = anchor[k] - c[k];
      if constexpr (kMotion) {
#pragma unroll
        for (int k = 0; k < 3; ++k) S[da][k] = axis_w[k];
        cross3(anchor, axis_w, S[da] + 3);
      }
    } else {  // slide
      const float d = q[qa] - q0;
#pragma unroll
      for (int k = 0; k < 3; ++k) pos[k] = pos[k] + axis_w[k] * d;
      if constexpr (kMotion) {
        S[da][0] = S[da][1] = S[da][2] = 0.0f;
#pragma unroll
        for (int k = 0; k < 3; ++k) S[da][3 + k] = axis_w[k];
      }
    }
  }
}

// Forward kinematics (sim/batched.py::fk_b) on one lane: every body's world
// position and orientation and, with kMotion, every dof's motion subspace
// S, body after body. Bodies whose parent is the world start from its
// identity pose, so a forest needs nothing more. hq: the hinges'
// half-angle rotations, where taken beforehand.
template <bool kMotion>
__device__ __forceinline__ void fk(const float* q, float (&xpos)[NB][3],
                                   float (&xquat)[NB][4], float (*S)[6],
                                   const float (*hq)[4] = nullptr) {
  xpos[0][0] = xpos[0][1] = xpos[0][2] = 0.0f;
  xquat[0][0] = 1.0f;
  xquat[0][1] = xquat[0][2] = xquat[0][3] = 0.0f;
  static_for<1, NB>([&](auto B) {
    constexpr int b = IDX(B), p = body_parent(b);
    float pos[3], quat[4];
    const float bp[3] = {body_pos(b, 0), body_pos(b, 1), body_pos(b, 2)};
    const float bq[4] = {body_quat(b, 0), body_quat(b, 1), body_quat(b, 2),
                         body_quat(b, 3)};
    body_frame(xpos[p], xquat[p], bp, bq, pos, quat);
    static_for<0, n_body_jnt(b)>([&](auto M) {
      constexpr int j = body_jnt(IDX(B), IDX(M)), h = jnt_hinge(j);
      const float ax[3] = {jnt_axis(j, 0), jnt_axis(j, 1), jnt_axis(j, 2)};
      const float jp[3] = {jnt_pos(j, 0), jnt_pos(j, 1), jnt_pos(j, 2)};
      joint_fk<jnt_type(j), kMotion>(
          q, jnt_qadr(j), jnt_dadr(j), ax, jp, init_q(jnt_qadr(j)),
          (h >= 0 && hq != nullptr) ? hq[h] : nullptr, pos, quat, S);
    });
#pragma unroll
    for (int k = 0; k < 3; ++k) xpos[b][k] = pos[k];
#pragma unroll
    for (int k = 0; k < 4; ++k) xquat[b][k] = quat[k];
  });
}

// One group's working set, in shared memory. Spatial vectors are
// [angular, linear] about the world origin; sd holds each dof's Ṡ·q̇ and Fi
// each dof's Ic·S (CRBA); fsub holds the body forces, then the subtree
// forces; Jc and Rc the contact rows' Jacobian and force direction (a limit
// row's are ±e_da, not stored); vn, vbias and cap every row's normal
// velocity, velocity target and force cap; act the active rows.
struct Work {
  float q[NQ], qd[NV], u[kNU1];
  float xpos[NB][3], xquat[NB][4], S[NV][6], hq[kNH1][4];
  float Ib[NB][kIn];
  float vb[NB][6], ab[NB][6], fsub[NB][6], sd[NV][6], Fi[NV][6];
  // the composite inertias are spent (Fi) before the mass matrix is built
  union {
    float Ic[NB][kIn];
    float F[kTri];
  };
  float rhs[NV];
  float Jc[kNCon1][NV], Rc[kNCon1][NV];
  float vn[kNC1], vbias[kNC1], cap[kNC1];
  int act[kNC1];
};
// The working set and the sample's acting contact-row substeps so far
// (read and written in counted launches only), in an odd number of words,
// so that the groups of a warp, reading the same field, fall on different
// banks. The count takes a word that the padding took before it, so every
// model's slice keeps its size.
struct Counted : Work {
  int rows;
};
struct Padded : Counted {
  float pad;
};
using Slice =
    std::conditional_t<(sizeof(Counted) / 4) % 2 == 1, Counted, Padded>;

// --- begin group ---
// The G lanes of one sample: lanes base … base + G − 1 of a warp. Every
// lane of a warp stays alive to the end and takes every barrier, so the
// barrier, the broadcast and the ballot span the whole warp, and the
// warp's groups run their phases side by side.
template <int G>
struct Group {
  int lane, base;
  __device__ __forceinline__ void sync() const { __syncwarp(0xffffffffu); }
  // v of the group's lane src, on every lane of the group
  __device__ __forceinline__ float bcast(float v, int src) const {
    return __shfl_sync(0xffffffffu, v, src, G);
  }
  // bit l: the group's lane l's p
  __device__ __forceinline__ unsigned ballot(bool p) const {
    const unsigned m = __ballot_sync(0xffffffffu, p) >> base;
    return (G == 32) ? m : (m & ((1u << G) - 1u));
  }
  // the largest v over the warp's groups
  __device__ __forceinline__ int warp_max(int v) const {
    return __reduce_max_sync(0xffffffffu, v);
  }
};
__device__ __forceinline__ int popc(unsigned m) { return __popc(m); }
// --- end group ---

// ---- phases of a substep: each fills one output for one lane's index ----

// body b's own spatial inertia about the world origin
// (sim/batched.py::spatial_inertia_all)
__device__ __forceinline__ void own_inertia(Work& s, int b) {
  const float ip[3] = {t_body_ipos(b, 0), t_body_ipos(b, 1),
                       t_body_ipos(b, 2)};
  const float iqc[4] = {t_body_iquat(b, 0), t_body_iquat(b, 1),
                        t_body_iquat(b, 2), t_body_iquat(b, 3)};
  const float m = t_body_mass(b);
  const float in[3] = {t_body_inertia(b, 0), t_body_inertia(b, 1),
                       t_body_inertia(b, 2)};
  float c[3], com[3], iq[4];
  qrot(s.xquat[b], ip, c);
#pragma unroll
  for (int k = 0; k < 3; ++k) com[k] = s.xpos[b][k] + c[k];
  qmul(s.xquat[b], iqc, iq);
  float col[3][3];
  quat_cols(iq, col);
  const float c2sum = com[0] * com[0] + com[1] * com[1] + com[2] * com[2];
  float* I = s.Ib[b];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int bb = 0; bb < 3; ++bb) {
      const float irot = in[0] * col[0][a] * col[0][bb] +
                         in[1] * col[1][a] * col[1][bb] +
                         in[2] * col[2][a] * col[2][bb];
      const float extra = (a == bb) ? m * (c2sum - com[a] * com[bb])
                                    : m * (-(com[a] * com[bb]));
      I[3 * a + bb] = irot + extra;
    }
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) I[9 + k] = m * com[k];
  I[12] = m;
}

// component k of every body's velocity: the parent's plus S·q̇ of its dofs
__device__ __forceinline__ void velocities(Work& s, int k) {
  s.vb[0][k] = 0.0f;
  static_for<1, NB>([&](auto B) {
    constexpr int b = IDX(B);
    s.vb[b][k] = s.vb[body_parent(b)][k];
    static_for<0, n_own(b)>([&](auto M) {
      constexpr int i = own(IDX(B), IDX(M));
      s.vb[IDX(B)][k] = s.vb[IDX(B)][k] + s.S[i][k] * s.qd[i];
    });
  });
}

// component k of every composite (subtree) inertia, leaves first
__device__ __forceinline__ void composite(Work& s, int k) {
  static_for<NB - 1, 0, -1>([&](auto B) {
    constexpr int b = IDX(B);
    s.Ic[b][k] = s.Ib[b][k];
    static_for<0, n_child(b)>([&](auto M) {
      constexpr int c = child(IDX(B), IDX(M));
      s.Ic[IDX(B)][k] = s.Ic[IDX(B)][k] + s.Ic[c][k];
    });
  });
}

// dof i's Ṡ·q̇ = v_partial ×m (S·q̇), v_partial the parent body's velocity
// plus S·q̇ of the body's earlier dofs
__device__ __forceinline__ void sdot(Work& s, int i) {
  const int p = t_body_parent(t_dof_body(i));
  float vp[6], w[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) vp[k] = s.vb[p][k];
  const int n = t_n_prev(i);
  for (int m = 0; m < n; ++m) {
    const int j = t_prev(i, m);
#pragma unroll
    for (int k = 0; k < 6; ++k) vp[k] = vp[k] + s.S[j][k] * s.qd[j];
  }
#pragma unroll
  for (int k = 0; k < 6; ++k) w[k] = s.S[i][k] * s.qd[i];
  crm(vp, w, s.sd[i]);
}

// component k of every body's bias acceleration, from −g at the world
__device__ __forceinline__ void accelerations(Work& s, int k) {
  s.ab[0][k] = (k < 3) ? 0.0f : -t_gravity(k - 3);
  static_for<1, NB>([&](auto B) {
    constexpr int b = IDX(B);
    s.ab[b][k] = s.ab[body_parent(b)][k];
    static_for<0, n_own(b)>([&](auto M) {
      constexpr int i = own(IDX(B), IDX(M));
      s.ab[IDX(B)][k] = s.ab[IDX(B)][k] + s.sd[i][k];
    });
  });
}

// mass-matrix entry e, (i, j) with j ≤ i: Σ_k (Ic·S_i)_k S_j,k; on the
// diagonal + armature, then + the implicit joint damping h·b and, past a
// limit, the limit damping
__device__ __forceinline__ void mass_entry(Work& s, int e) {
  const int i = t_mp_i(e), j = t_mp_j(e);
  float acc = s.Fi[i][0] * s.S[j][0];
#pragma unroll
  for (int k = 1; k < 6; ++k) acc = acc + s.Fi[i][k] * s.S[j][k];
  if (i == j) {
    acc = acc + t_armature(i);
    float extra = t_h_damping(i);
    const int l = t_dof_limj(i);
    if (l >= 0) {
      const int qa = t_limj_qadr(l);
      const float below = tmax(t_limj_lo(l) - s.q[qa], 0.0f);
      const float above = tmax(s.q[qa] - t_limj_hi(l), 0.0f);
      const float active = (below > 0.0f || above > 0.0f) ? 1.0f : 0.0f;
      extra = extra + t_limj_dlim(l) * active;
    }
    acc = acc + extra;
  }
  s.F[tri(i, j)] = acc;
}

// body b's force I·a + v ×f (I·v), into fsub
__device__ __forceinline__ void body_force(Work& s, int b) {
  float Ia[6], Iv[6], cf[6];
  matvec6(s.Ib[b], s.ab[b], Ia);
  matvec6(s.Ib[b], s.vb[b], Iv);
  crf(s.vb[b], Iv, cf);
#pragma unroll
  for (int k = 0; k < 6; ++k) s.fsub[b][k] = Ia[k] + cf[k];
}

// component k of every subtree force, leaves first
__device__ __forceinline__ void subtree_force(Work& s, int k) {
  static_for<NB - 1, 0, -1>([&](auto B) {
    constexpr int b = IDX(B);
    static_for<0, n_child(b)>([&](auto M) {
      constexpr int c = child(IDX(B), IDX(M));
      s.fsub[IDX(B)][k] = s.fsub[IDX(B)][k] + s.fsub[c][k];
    });
  });
}

// dof i's right-hand side: actuators and springs, minus the bias S·f and
// the joint damping
__device__ __forceinline__ void generalized_force(Work& s, int i) {
  const float* f = s.fsub[t_dof_body(i)];
  float bias = s.S[i][0] * f[0];
#pragma unroll
  for (int k = 1; k < 6; ++k) bias = bias + s.S[i][k] * f[k];
  float qfrc = 0.0f;
  const int na = t_n_dact(i);
  for (int m = 0; m < na; ++m) {
    const int a = t_dact(i, m);
    const float uc = tmin(tmax(s.u[a], t_act_lo(a)), t_act_hi(a));
    qfrc = qfrc + t_act_gear(a) * uc;
  }
  const int ns = t_n_dspring(i);
  for (int m = 0; m < ns; ++m) {
    const int sp = t_dspring(i, m);
    qfrc = qfrc - t_spring_k(sp) * (s.q[t_spring_qadr(sp)] - t_spring_q0(sp));
  }
  s.rhs[i] = qfrc - bias - t_damping(i) * s.qd[i];
}

// limit row lr (of joint lr / 2, below for even lr, above for odd): normal
// velocity, velocity target and force cap
__device__ __forceinline__ void limit_row(Work& s, int lr) {
  const int l = lr / 2, e = lr % 2, ci = NCON + lr;
  const int qa = t_limj_qadr(l), da = t_limj_dadr(l);
  const float sg = (e == 0) ? 1.0f : -1.0f;
  const float vio = (e == 0) ? tmax(t_limj_lo(l) - s.q[qa], 0.0f)
                             : tmax(s.q[qa] - t_limj_hi(l), 0.0f);
  s.vn[ci] = sg * s.qd[da];
  s.vbias[ci] = tmin(vio * kBetaInvH, kVPushMax);
  s.cap[ci] = kLimitK * vio * (vio > 0.0f ? 1.0f : 0.0f);
}

// geom pose in the world: the pair's geom on body gb at (gp, gq) locally
__device__ __forceinline__ void geom_pose(const Work& s, int gb,
                                          const float* gp, const float* gq,
                                          float* p, float* q) {
  if (gb == 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) p[k] = gp[k];
#pragma unroll
    for (int k = 0; k < 4; ++k) q[k] = gq[k];
  } else {
    float c[3];
    qrot(s.xquat[gb], gp, c);
#pragma unroll
    for (int k = 0; k < 3; ++k) p[k] = s.xpos[gb][k] + c[k];
    qmul(s.xquat[gb], gq, q);
  }
}

// contact pair p (sim/batched.py::collide_b and _precompute_rows_stacked):
// its points' normal velocities, velocity targets and force caps and, for
// a point whose cap is not 0, its Jacobian row and force direction
__device__ void contact_pair(Work& s, int p) {
  const int ga = t_pair_body_a(p), gb = t_pair_body_b(p);
  const int kind = t_pair_kind(p);
  float pa[3], qa[4], pb[3], qb[4];
  {
    const float gp[3] = {t_pair_pos_a(p, 0), t_pair_pos_a(p, 1),
                         t_pair_pos_a(p, 2)};
    const float gq[4] = {t_pair_quat_a(p, 0), t_pair_quat_a(p, 1),
                         t_pair_quat_a(p, 2), t_pair_quat_a(p, 3)};
    geom_pose(s, ga, gp, gq, pa, qa);
  }
  {
    const float gp[3] = {t_pair_pos_b(p, 0), t_pair_pos_b(p, 1),
                         t_pair_pos_b(p, 2)};
    const float gq[4] = {t_pair_quat_b(p, 0), t_pair_quat_b(p, 1),
                         t_pair_quat_b(p, 2), t_pair_quat_b(p, 3)};
    geom_pose(s, gb, gp, gq, pb, qb);
  }
  // contact points of this pair: position, normal, depth
  float cpos[2][3], cn[2][3], cdep[2];
  int npts = 0;
  if (kind == kPlaneSphere) {
    float n[3], d[3];
    zhat(qa, n);
    const float r = t_pair_r2(p);
#pragma unroll
    for (int k = 0; k < 3; ++k) d[k] = pb[k] - pa[k];
    const float dist = dot3(n, d) - r;
    const float off = r + 0.5f * dist;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      cpos[0][k] = pb[k] - n[k] * off;
      cn[0][k] = n[k];
    }
    cdep[0] = -dist;
    npts = 1;
  } else if (kind == kPlaneCapsule) {
    float n[3], axis[3];
    zhat(qa, n);
    zhat(qb, axis);
    const float r = t_pair_r2(p);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float hl = (e == 0) ? t_pair_hl2(p) : -t_pair_hl2(p);
      float pe[3], d[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) pe[k] = pb[k] + axis[k] * hl;
#pragma unroll
      for (int k = 0; k < 3; ++k) d[k] = pe[k] - pa[k];
      const float dist = dot3(n, d) - r;
      const float off = r + 0.5f * dist;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        cpos[e][k] = pe[k] - n[k] * off;
        cn[e][k] = n[k];
      }
      cdep[e] = -dist;
    }
    npts = 2;
  } else if (kind == kCapsuleCapsule) {
    const float r1 = t_pair_r1(p), hl1 = t_pair_hl1(p);
    const float r2 = t_pair_r2(p), hl2 = t_pair_hl2(p);
    float d1[3], d2[3], rv[3];
    zhat(qa, d1);
    zhat(qb, d2);
#pragma unroll
    for (int k = 0; k < 3; ++k) rv[k] = pa[k] - pb[k];
    const float bq = dot3(d1, d2);
    const float c = dot3(d1, rv);
    const float fq = dot3(d2, rv);
    float denom = 1.0f - bq * bq;
    denom = (fabsf(denom) < 1e-9f) ? 1e-9f : denom;
    float sp = tmin(tmax((bq * fq - c) / denom, -hl1), hl1);
    const float t = tmin(tmax(bq * sp + fq, -hl2), hl2);
    sp = tmin(tmax(bq * t - c, -hl1), hl1);
    float c1p[3], c2p[3], delta[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      c1p[k] = pa[k] + d1[k] * sp;
      c2p[k] = pb[k] + d2[k] * t;
      delta[k] = c2p[k] - c1p[k];
    }
    const float dist = sqrtf(dot3(delta, delta));
    const float dn = tmax(dist, 1e-9f);
#pragma unroll
    for (int k = 0; k < 3; ++k) cn[0][k] = delta[k] / dn;
    cdep[0] = t_pair_r12(p) - dist;
#pragma unroll
    for (int k = 0; k < 3; ++k)
      cpos[0][k] = 0.5f * (c1p[k] + cn[0][k] * r1 + c2p[k] - cn[0][k] * r2);
    npts = 1;
  } else if (kind == kSphereBox) {
    // sphere a against box b, in the box's frame (sim/batched.py
    // collide_b): the clamped point outside the box, else the face of
    // least penetration, ties to the lowest axis (torch.argmin). The
    // one-hot sums keep the plain version's form, signs of zero included.
    const float r = t_pair_r1(p);
    float col[3][3], d[3], pl[3], cl[3], delta[3], fd[3], oh[3];
    quat_cols(qb, col);
#pragma unroll
    for (int k = 0; k < 3; ++k) d[k] = pa[k] - pb[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float half = t_pair_box_b(p, k);
      pl[k] = dot3(col[k], d);
      cl[k] = tmin(tmax(pl[k], -half), half);
      delta[k] = pl[k] - cl[k];
      fd[k] = half - fabsf(pl[k]);
    }
    const float dist_out = sqrtf(dot3(delta, delta));
    const bool outside = dist_out > 1e-9f;
    // argmin with NaN first, as torch.argmin
    int kmin = 0;
#pragma unroll
    for (int k = 1; k < 3; ++k) {
      if (fd[kmin] == fd[kmin] && (fd[k] != fd[k] || fd[k] < fd[kmin]))
        kmin = k;
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) oh[k] = (kmin == k) ? 1.0f : 0.0f;
    const float psel = (pl[0] * oh[0] + pl[1] * oh[1]) + pl[2] * oh[2];
    // torch.sign: +0 for ±0 and NaN
    const float sgn = static_cast<float>((psel > 0.0f) - (psel < 0.0f));
    const float fsel = (fd[0] * oh[0] + fd[1] * oh[1]) + fd[2] * oh[2];
    const float dn = tmax(dist_out, 1e-9f);
    float nl[3], surf[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      nl[k] = outside ? -delta[k] / dn : -sgn * oh[k];
      surf[k] = outside ? cl[k] : pl[k];
    }
    cdep[0] = outside ? r - dist_out : r + fsel;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      cpos[0][k] = pb[k] + (col[0][k] * surf[0] + col[1][k] * surf[1] +
                            col[2][k] * surf[2]);
      cn[0][k] = col[0][k] * nl[0] + col[1][k] * nl[1] + col[2][k] * nl[2];
    }
    npts = 1;
  }
  const float mu = t_pair_mu(p);
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    if (e >= npts) break;
    const int ci = t_pair_start(p) + e;
    const float* pos = cpos[e];
    const float* n = cn[e];
    const float dep = cdep[e];
    float va[3], vbp[3], vrel[3], vt[3], tdir[3], d[3], tmp[3];
    cross3(s.vb[ga], pos, tmp);
#pragma unroll
    for (int k = 0; k < 3; ++k) va[k] = s.vb[ga][3 + k] + tmp[k];
    cross3(s.vb[gb], pos, tmp);
#pragma unroll
    for (int k = 0; k < 3; ++k) vbp[k] = s.vb[gb][3 + k] + tmp[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) vrel[k] = vbp[k] - va[k];
    const float vnc = dot3(vrel, n);
    const float aref = tmax(kContactK * dep - kContactB * vnc, 0.0f);
    const float cap = aref * (dep > 0.0f ? 1.0f : 0.0f);
    s.vn[ci] = vnc;
    s.vbias[ci] = tmin(tmax(dep, 0.0f) * kBetaInvH, kVPushMax);
    s.cap[ci] = cap;
    if (cap == 0.0f) continue;  // inactive: its rows are never read
#pragma unroll
    for (int k = 0; k < 3; ++k) vt[k] = vrel[k] - vnc * n[k];
    const float tn = sqrtf(dot3(vt, vt) + kEps2);
#pragma unroll
    for (int k = 0; k < 3; ++k) tdir[k] = vt[k] / tn;
#pragma unroll
    for (int k = 0; k < 3; ++k) d[k] = n[k] - mu * tdir[k];
    float wj[6], wr[6];
    cross3(pos, n, wj);
    cross3(pos, d, wr);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      wj[3 + k] = n[k];
      wr[3 + k] = d[k];
    }
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      float aj = s.S[i][0] * wj[0], ar = s.S[i][0] * wr[0];
#pragma unroll
      for (int k = 1; k < 6; ++k) {
        aj = aj + s.S[i][k] * wj[k];
        ar = ar + s.S[i][k] * wr[k];
      }
      const float sg = t_con_sgn(ci, i);
      s.Jc[ci][i] = sg * aj;
      s.Rc[ci][i] = sg * ar;
    }
  }
}

// row c's Jacobian entry i (a limit row's is ±1 at its dof, else 0; so is
// its force direction, Rc for a contact)
__device__ __forceinline__ float limit_entry(int c, int i) {
  const int lr = c - NCON;
  return (i == t_limj_dadr(lr / 2)) ? ((lr % 2 == 0) ? 1.0f : -1.0f) : 0.0f;
}
__device__ __forceinline__ float jac(const Work& s, int c, int i) {
  return (c < NCON) ? s.Jc[c][i] : limit_entry(c, i);
}
__device__ __forceinline__ float force_dir(const Work& s, int c, int i) {
  return (c < NCON) ? s.Rc[c][i] : limit_entry(c, i);
}

// lanes t = lane, lane + G, … < n
#define LANES(t, n) for (int t = g.lane; t < (n); t += G)

#if NFK > 0
// Forward kinematics by the group where the body tree branches (NFK > 0 in
// model.h): NFK stages, each the bodies of one depth whose joints have one
// list of kinds, in fk's order of depths, a body a lane. A lane reads its
// body's parent pose, which a stage one level up wrote before the barrier
// that closes each level, and its body's tables through the block's shared
// copy (a hinge's by its index among the hinges, a slide's among the
// slides); the stage's kinds, fixed at compile time, keep its lanes on one
// instruction stream. Each pose and motion subspace is fk's, term for term.
// The world's pose is load_state's.
template <int G>
__device__ __forceinline__ void fk_levels(const Group<G>& g, Work& s) {
  static_for<0, NFK>([&](auto St) {
    constexpr int st = IDX(St), b0 = fk_body(st, 0);
    LANES(m, n_fk_body(st)) {
      const int b = t_fk_body(st, m), p = t_body_parent(b);
      float pos[3], quat[4];
      const float bp[3] = {t_body_pos(b, 0), t_body_pos(b, 1),
                           t_body_pos(b, 2)};
      const float bq[4] = {t_body_quat(b, 0), t_body_quat(b, 1),
                           t_body_quat(b, 2), t_body_quat(b, 3)};
      body_frame(s.xpos[p], s.xquat[p], bp, bq, pos, quat);
      static_for<0, n_body_jnt(b0)>([&](auto M) {
        constexpr int kind = jnt_type(body_jnt(fk_body(IDX(St), 0), IDX(M)));
        const int j = t_body_jnt(b, IDX(M)), da = t_jnt_dadr(j);
        if constexpr (kind == kFree) {
          joint_fk<kind, true>(s.q, t_jnt_qadr(j), da, nullptr, nullptr,
                               0.0f, nullptr, pos, quat, s.S);
        } else if constexpr (kind == kHinge) {
          const int h = t_jnt_hinge(j);
          const float ax[3] = {t_hinge_axis(h, 0), t_hinge_axis(h, 1),
                               t_hinge_axis(h, 2)};
          const float jp[3] = {t_hinge_pos(h, 0), t_hinge_pos(h, 1),
                               t_hinge_pos(h, 2)};
          joint_fk<kind, true>(s.q, 0, da, ax, jp, 0.0f, s.hq[h], pos, quat,
                               s.S);
        } else {
          const int l = t_jnt_slide(j);
          const float ax[3] = {t_slide_axis(l, 0), t_slide_axis(l, 1),
                               t_slide_axis(l, 2)};
          joint_fk<kind, true>(s.q, t_jnt_qadr(j), da, ax, nullptr,
                               t_slide_q0(l), nullptr, pos, quat, s.S);
        }
      });
#pragma unroll
      for (int k = 0; k < 3; ++k) s.xpos[b][k] = pos[k];
#pragma unroll
      for (int k = 0; k < 4; ++k) s.xquat[b][k] = quat[k];
    }
    if constexpr (fk_sync(st)) g.sync();
  });
}
#endif

// One physics substep (sim/batched.py::substep_b) of the group's sample,
// in place on s.q, s.qd. Every lane calls it; each phase ends at the
// group's barrier.
template <int G>
__device__ void substep(const Group<G>& g, Slice& s) {
  g.sync();  // lane 0's q, qd and u
  // ---- each hinge's half-angle rotation ----
  LANES(h, kNH) {
    const float ax[3] = {t_hinge_axis(h, 0), t_hinge_axis(h, 1),
                         t_hinge_axis(h, 2)};
    const float theta = s.q[t_hinge_qadr(h)] - t_hinge_q0(h);
    const float sn = sinf(0.5f * theta);
    s.hq[h][0] = cosf(0.5f * theta);
    s.hq[h][1] = ax[0] * sn;
    s.hq[h][2] = ax[1] * sn;
    s.hq[h][3] = ax[2] * sn;
  }
  g.sync();
  // ---- forward kinematics: a tree level a phase across the lanes where
  // the tree branches, body after body on lane 0 along a chain ----
#if NFK > 0
  fk_levels<G>(g, s);
#else
  if (g.lane == 0) fk<true>(s.q, s.xpos, s.xquat, s.S, s.hq);
#endif
  g.sync();
  // Within a phase the kinds of task run one after another, each spread
  // over the lanes: a loop of one kind keeps the lanes on one path.
  // ---- own spatial inertias by body; body velocities by component ----
  LANES(b, NB - 1) own_inertia(s, b + 1);
  LANES(k, 6) velocities(s, k);
  g.sync();
  // ---- composite inertias by component; Ṡ·q̇ by dof ----
  LANES(k, kIn) composite(s, k);
  LANES(i, NV) sdot(s, i);
  g.sync();
  // ---- CRBA's Ic·S by dof; bias accelerations by component ----
  LANES(i, NV) matvec6(s.Ic[t_dof_body(i)], s.S[i], s.Fi[i]);
  LANES(k, 6) accelerations(s, k);
  g.sync();
  // ---- mass-matrix entries; body forces by body ----
  LANES(e, kNMP) mass_entry(s, e);
  LANES(b, NB - 1) body_force(s, b + 1);
  g.sync();
  // ---- subtree forces by component ----
  LANES(k, 6) subtree_force(s, k);
  g.sync();
  // ---- contact pairs; limit rows; generalized forces by dof ----
  LANES(p, NPAIR) contact_pair(s, p);
  LANES(l, 2 * NLIMJ) limit_row(s, l);
  LANES(i, NV) generalized_force(s, i);
  g.sync();

  // ---- the active rows, in row order ----
  int nact = 0;
  for (int base = 0; base < NC; base += G) {
    const int c = base + g.lane;
    const bool on = c < NC && !(s.cap[c] == 0.0f);
    const unsigned m = g.ballot(on);
    if (on) s.act[nact + popc(m & ((1u << g.lane) - 1u))] = c;
    nact += popc(m);
  }

  // ---- LᵀDL factor (leaf-most dofs first; for k's ancestors i, F[i][i]
  // and F[i][j], j over i's ancestors, −= (F[k][i]/F[k][k])·F[k][j], then
  // F[k][i] /= F[k][k]) ----
  if constexpr (kNFac <= kSerialFactor) {
    // a few updates: on lane 0, in the order of the plain engine
    if (g.lane == 0) {
      float* F = s.F;
      static_for<NV - 1, -1, -1>([&](auto K) {
        constexpr int k = IDX(K);
        const float inv_d = 1.0f / F[tri(k, k)];
        static_for<0, n_anc(k)>([&](auto M) {
          constexpr int k = IDX(K), i = anc(k, IDX(M));
          const float a = F[tri(k, i)] * inv_d;
          F[tri(i, i)] = F[tri(i, i)] - a * F[tri(k, i)];
          static_for<0, n_anc(i)>([&](auto MM) {
            constexpr int k = IDX(K), i = anc(k, IDX(M)),
                          j = anc(i, IDX(MM));
            F[tri(i, j)] = F[tri(i, j)] - a * F[tri(k, j)];
          });
          F[tri(k, i)] = a;
        });
      });
    }
    g.sync();
  } else {
    // many: column by column, the updates of column k across lanes with
    // the scaling of row k + 1 beside them, a barrier between columns
#pragma unroll 1
    for (int k = NV - 1; k >= 0; --k) {
      const int kk = k + 1;
      if (kk < NV) {
        const float inv = 1.0f / s.F[tri(kk, kk)];
        LANES(m, t_n_anc(kk)) {
          const int i = t_anc(kk, m);
          s.F[tri(kk, i)] = s.F[tri(kk, i)] * inv;
        }
      }
      const float inv_d = 1.0f / s.F[tri(k, k)];
      for (int t = t_fac_start(k) + g.lane; t < t_fac_start(k + 1);
           t += G) {
        const int i = t_fac_i(t), j = t_fac_j(t);
        const float a = s.F[tri(k, i)] * inv_d;
        s.F[tri(i, j)] = s.F[tri(i, j)] - a * s.F[tri(k, j)];
      }
      g.sync();
    }
  }

  if constexpr (NC > 0) {
    // ---- M⁻¹Jᵀ and effective masses of the active rows, one tree solve
    // per row; row k = r·G + lane sits in the lane's slot r ----
    constexpr int R = (NC + G - 1) / G;
    float x[R][NV], meff[R], fnmax[R], fns[R];
    static_for<0, R>([&](auto Rr) {
      constexpr int r = IDX(Rr);
      const int k = r * G + g.lane;
      if (k < nact) {
        const int c = s.act[k];
#pragma unroll
        for (int i = 0; i < NV; ++i) x[r][i] = jac(s, c, i);
        ldl_solve(s.F, x[r]);
        float jmj = jac(s, c, 0) * x[r][0];
#pragma unroll
        for (int i = 1; i < NV; ++i) jmj = jmj + jac(s, c, i) * x[r][i];
        meff[r] = 1.0f / (jmj + 1e-8f);
        fnmax[r] = meff[r] * s.cap[c];
        fns[r] = 0.0f;
      }
    });

    // ---- projected Gauss–Seidel sweep over the active rows: the row's
    // lane sums M⁻¹Jᵀ·rhs in dof order and broadcasts the force step; the
    // lanes update rhs by dof; as many rows as the warp's busiest group,
    // the others' masked ----
    const int nact_warp = g.warp_max(nact);
#pragma unroll 1
    for (int pass = 0; pass < kGsPasses; ++pass) {
      static_for<0, R>([&](auto Rr) {
        constexpr int r = IDX(Rr);
#pragma unroll 1
        for (int o = 0; o < G && r * G + o < nact_warp; ++o) {
          const bool row = r * G + o < nact;
          const int c = row ? s.act[r * G + o] : 0;
          float dfn = 0.0f;
          if (row && g.lane == o) {
            float jacc = x[r][0] * s.rhs[0];
#pragma unroll
            for (int i = 1; i < NV; ++i) jacc = jacc + x[r][i] * s.rhs[i];
            const float vn_pred = s.vn[c] + kH * jacc;
            const float fn_new = tmin(
                tmax(fns[r] + meff[r] * (s.vbias[c] - vn_pred) * kInvH,
                     0.0f),
                fnmax[r]);
            dfn = fn_new - fns[r];
            fns[r] = fn_new;
          }
          dfn = g.bcast(dfn, o);
          if (row) {
            LANES(i, NV) s.rhs[i] = s.rhs[i] + force_dir(s, c, i) * dfn;
          }
          g.sync();
        }
      });
    }
  }

  // ---- accelerations and the semi-implicit Euler update ----
  if (g.lane == 0) {
    float acc[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) acc[i] = s.rhs[i];
    ldl_solve(s.F, acc);
    float* q = s.q;
    float* qd = s.qd;
#pragma unroll
    for (int i = 0; i < NV; ++i) qd[i] = qd[i] + kH * acc[i];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int qa = jnt_qadr(j), da = jnt_dadr(j);
      if (jnt_type(j) != kFree) {
        q[qa] = q[qa] + kH * qd[da];
        continue;
      }
      // free joint: position by Euler, orientation by the exponential map
      // of the new angular velocity, renormalised (sim/batched.py
      // integrate_pos_b)
#pragma unroll
      for (int k = 0; k < 3; ++k) q[qa + k] = q[qa + k] + kH * qd[da + k];
      const float* w = qd + da + 3;
      const float wn = sqrtf(w[0] * w[0] + w[1] * w[1] + w[2] * w[2]);
      const float half = 0.5f * (wn * kH);
      const float sinc =
          (wn < 1e-12f) ? 0.5f * kH : sinf(half) / tmax(wn, 1e-12f);
      const float dq[4] = {cosf(half), w[0] * sinc, w[1] * sinc,
                           w[2] * sinc};
      float qn[4];
      qmul(q + qa + 3, dq, qn);
      const float nrm = sqrtf(qn[0] * qn[0] + qn[1] * qn[1] +
                              qn[2] * qn[2] + qn[3] * qn[3]);
#pragma unroll
      for (int k = 0; k < 4; ++k) q[qa + 3 + k] = qn[k] / nrm;
    }
  }
}

#if NTRACK > 0
// Demo tracking (rollout_pallas.py:132-141): one positions-only FK pass on
// the post-step q, into the slice's link poses, then per tracked body the
// squared distance to its demo frame xref_t [NTRACK][3], summed left to
// right, and acc += (clip(‖x − xref_t‖, 0, 0.5)/0.5)².
__device__ void track_cost(Work& s, const float* xref_t, float& acc) {
  fk<false>(s.q, s.xpos, s.xquat, nullptr);
#pragma unroll
  for (int i = 0; i < NTRACK; ++i) {
    float d2 = 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float d = s.xpos[track_body(i)][c] - xref_t[3 * i + c];
      d2 = d2 + d * d;
    }
    const float e = tmin(tmax(sqrtf(d2), 0.0f), 0.5f) / 0.5f;
    acc = acc + e * e;
  }
}
#endif

// Sample n's initial state into the slice (lane 0): q0 [NQ] and qd0 [NV]
// shared by every sample, or q0 [NQ, N] and qd0 [NV, N] per sample; its
// count of acting contact-row substeps from 0; and, where the group's
// forward kinematics reads it (fk_levels), the world's identity pose.
__device__ __forceinline__ void load_state(Slice& s,
                                           const float* __restrict__ q0,
                                           const float* __restrict__ qd0,
                                           int per_sample, int n, int N) {
#pragma unroll
  for (int i = 0; i < NQ; ++i) s.q[i] = per_sample ? q0[i * N + n] : q0[i];
#pragma unroll
  for (int i = 0; i < NV; ++i)
    s.qd[i] = per_sample ? qd0[i * N + n] : qd0[i];
  s.rows = 0;
#if NFK > 0
  s.xpos[0][0] = s.xpos[0][1] = s.xpos[0][2] = 0.0f;
  s.xquat[0][0] = 1.0f;
  s.xquat[0][1] = s.xquat[0][2] = s.xquat[0][3] = 0.0f;
#endif
}

// Env step t's controls of sample n into the slice, and what the reward
// reads of the state before the step (lane 0).
__device__ __forceinline__ void begin_step(Work& s,
                                           const float* __restrict__ U,
                                           int t, int n, int N,
                                           float& x_prev, float& r_pre) {
#pragma unroll
  for (int a = 0; a < NU; ++a) s.u[a] = U[(t * NU + a) * N + n];
  x_prev = s.q[0];
  // the track reward reads the pre-step state (free root: torso x
  // velocity qd[0], torso (y, z) = q[1], q[2])
  if (kReward == kRewardTrack) {
    r_pre = 1.0f + (-fabsf(s.qd[0] - kVTarget) - fabsf(s.q[2] - kZTarget) -
                    0.1f * fabsf(s.q[1]));
  }
}

// One env step's NFRAMES substeps by the group, each followed on lane 0 by
// the validity checks, whose flag rises and stays, and the velocity clamp;
// with `count`, first by the count of the substep's acting contact rows
// while the step started unflagged: bad is then 0 or, from a check of this
// step, 1 (a flag of an earlier step is 1 in the retiring form, which ends
// the sample there, and t + 2 ≥ 2 in the whole form).
template <int G>
__device__ __forceinline__ void physics_step(const Group<G>& g, Slice& s,
                                             float& bad, bool count) {
#pragma unroll 1
  for (int f = 0; f < NFRAMES; ++f) {
    substep<G>(g, s);
    if (g.lane == 0) {
      if (count && bad < 2.0f) {
        int acting = s.rows;
#pragma unroll
        for (int c = 0; c < NCON; ++c) acting += !(s.cap[c] == 0.0f);
        s.rows = acting;
      }
      // validity: NaN-propagating max|qd|, then the root-height sensors
      float* qd = s.qd;
      float speed = fabsf(qd[0]);
#pragma unroll
      for (int i = 1; i < NV; ++i) speed = tmax(speed, fabsf(qd[i]));
      bad = tmax(bad, speed > kQdDiverged ? 1.0f : 0.0f);
#pragma unroll
      for (int k = 0; k < NSENSOR; ++k) {
        bad = tmax(bad, s.q[sensor_qadr(k)] + sensor_off(k) < kZmin
                            ? 1.0f : 0.0f);
      }
#pragma unroll
      for (int i = 0; i < NV; ++i)
        qd[i] = tmin(tmax(qd[i], -kQdDiverged), kQdDiverged);
    }
  }
}

// The env step's reward, from the state after it (lane 0).
__device__ __forceinline__ float step_reward(const Work& s, float x_prev,
                                             float r_pre) {
  const float* q = s.q;
  const float* qd = s.qd;
  const float* u = s.u;
  float r;
  if (kReward == kRewardTrack) {
    r = r_pre;
  } else if (kReward == kRewardProgress) {
    r = q[0] - 0.5f * tmin(tmax(fabsf(q[1] - kZTarget), -1.0f), 1.0f);
  } else if (kReward == kRewardVelocity) {
    float cost = u[0] * u[0];
#pragma unroll
    for (int a = 1; a < NU; ++a) cost = cost + u[a] * u[a];
    r = (q[0] - x_prev) * kInvDt - kCtrlCost * cost;
  } else if (kReward == kRewardSwingup) {
    r = cosf(q[1]) - fabsf(qd[0]);
  } else if (kReward == kRewardRun) {  // free root: torso (x, y, z) = q[0:3]
    r = q[0] - tmin(tmax(fabsf(q[2] - kZTarget), -1.0f), 1.0f) -
        0.1f * fabsf(q[1]);
  } else if (kReward == kRewardStandup) {
    r = 1.5f - tmin(tmax(fabsf(q[2] - kZTarget), -2.0f), 1.0f) -
        0.1f * fabsf(q[0]) - 0.1f * fabsf(q[1]);
  } else if (kReward == kRewardPush) {
    // 1 − ((‖goal − slider‖ + |Δθ|/π) + max(‖pusher − slider‖ − 0.2, 0))
    const float gx = q[5] - q[2], gy = q[6] - q[3];
    const float px = q[0] - q[2], py = q[1] - q[3];
    const float d_goal = sqrtf(gx * gx + gy * gy);
    const float d_theta = fabsf(q[7] - q[4]) * kInvPi;
    const float d_ps = tmax(sqrtf(px * px + py * py) - 0.2f, 0.0f);
    r = 1.0f - ((d_goal + d_theta) + d_ps);
  } else {  // healthy velocity: forward speed + healthy − ctrl_cost·Σu²
    float cost = u[0] * u[0];
#pragma unroll
    for (int a = 1; a < NU; ++a) cost = cost + u[a] * u[a];
    const float healthy =
        (q[2] >= kZLow && q[2] <= kZHigh) ? 1.0f : 0.0f;
    r = (q[0] - x_prev) / kDt + healthy - kCtrlCost * cost;
  }
  return r;
}

// Sample n's whole rollout, by the group g in the slice s. qs [H, NQ, N]
// (the post-step position trace), logpd [N] (the demo log-density,
// against xref [H_demo, NTRACK, 3]) and qd_out [NV, N] (the velocities
// after the last step, clamped as every substep clamps them: with qs at
// H = 1, the state-out mode, one env step of RL training) are written
// only when their pointers are not null, and so are first_out [N], the env
// step at whose end the sample's flag first rose (−1: never), and rows_out
// [N], the contact-row substeps that acted in the env steps that started
// with the sample unflagged (physics_step). That step is
// carried in the flag itself so that it holds no register of its own: the
// flag is 0 or 1 (every check gives one of them), and at the end of env
// step t a flag of 1 becomes t + 2, which the checks' max leaves as it is.
template <int G>
__device__ void rollout_sample(const Group<G>& g, Slice& s, int n,
                               bool live,
                               const float* __restrict__ q0,
                               const float* __restrict__ qd0, int per_sample,
                               const float* __restrict__ U,
                               float* __restrict__ rews,
                               float* __restrict__ bad_out,
                               float* __restrict__ qs,
                               const float* __restrict__ xref,
                               float* __restrict__ logpd,
                               float* __restrict__ qd_out,
                               int* __restrict__ first_out,
                               int* __restrict__ rows_out, int N, int H) {
  float bad = 0.0f, acc = 0.0f, x_prev = 0.0f, r_pre = 0.0f;
  if (g.lane == 0) load_state(s, q0, qd0, per_sample, n, N);
#pragma unroll 1
  for (int t = 0; t < H; ++t) {
    if (g.lane == 0) begin_step(s, U, t, n, N, x_prev, r_pre);
    physics_step<G>(g, s, bad, rows_out != nullptr);
    if (g.lane != 0) continue;
    if (bad == 1.0f) bad = static_cast<float>(t + 2);
    const float r = step_reward(s, x_prev, r_pre);
    if (!live) continue;
    rews[t * N + n] = r;
    if (qs != nullptr) {
#pragma unroll
      for (int i = 0; i < NQ; ++i) qs[(t * NQ + i) * N + n] = s.q[i];
    }
#if NTRACK > 0
    if (logpd != nullptr) track_cost(s, xref + t * NTRACK * 3, acc);
#endif
  }
  if (g.lane != 0 || !live) return;
  bad_out[n] = bad != 0.0f ? 1.0f : 0.0f;
  if (first_out != nullptr)
    first_out[n] = bad != 0.0f ? static_cast<int>(bad) - 2 : -1;
  if (rows_out != nullptr) rows_out[n] = s.rows;
  if (qd_out != nullptr) {
#pragma unroll
    for (int i = 0; i < NV; ++i) qd_out[i * N + n] = s.qd[i];
  }
#if NTRACK > 0
  if (logpd != nullptr) logpd[n] = -acc / static_cast<float>(NTRACK * H);
#endif
}

// A retiring group's place, in shared memory beside its slice, where a
// register would cost every lane one (humanoidrun, at its 128-register
// cap, spills 188 / 200 bytes with n and t in registers against 164 /
// 164 with them here): its sample (−1 once the queue is empty) and the
// env step it is at.
struct Book {
  int n, t;
};

// The retiring form: the group starts with sample n and ends each sample
// at the end of its first flagged env step, or of step H − 1. The sample's
// rewards up to that step, its flag, first_out [N] and rows_out [N] (where
// not null) are the whole form's; its rewards after it are a quiet NaN of
// fixed bits, which no planner reads (they read no flagged sample's
// rewards). Lane 0 adds the env steps it ran, t + 1, to queue[1], takes
// the next sample from the launch-wide queue, started + one atomicAdd on
// queue[0], and starts it at t = 0 from its initial state: the slice
// carries only q, qd and u from one substep to the next (and the count,
// rows, and the world's pose), and load_state and begin_step set them all. A group that finds the
// queue empty replays sample N − 1 from its start and writes nothing, so
// that its lanes keep taking the warp's barriers; the warp leaves once
// none of its groups holds a sample.
template <int G>
__device__ void rollout_retiring(const Group<G>& g, Slice& s, Book& b, int n,
                                 const float* __restrict__ q0,
                                 const float* __restrict__ qd0,
                                 int per_sample,
                                 const float* __restrict__ U,
                                 float* __restrict__ rews,
                                 float* __restrict__ bad_out,
                                 int* __restrict__ first_out,
                                 int* __restrict__ rows_out,
                                 int* __restrict__ queue, int started, int N,
                                 int H) {
  float bad = 0.0f, x_prev = 0.0f, r_pre = 0.0f;
  if (g.lane == 0) {
    b.n = n < N ? n : -1;
    b.t = 0;
    load_state(s, q0, qd0, per_sample, n < N ? n : N - 1, N);
  }
#pragma unroll 1
  for (;;) {
    if (g.lane == 0) begin_step(s, U, b.t, b.n < 0 ? N - 1 : b.n, N, x_prev,
                                r_pre);
    physics_step<G>(g, s, bad, rows_out != nullptr);
    int held = 0;
    if (g.lane == 0) {
      const int m = b.n, t = b.t;
      const float r = step_reward(s, x_prev, r_pre);
      if (m >= 0) rews[t * N + m] = r;
      if (bad != 0.0f || t == H - 1) {
        int next = m;
        if (m >= 0) {
          bad_out[m] = bad != 0.0f ? 1.0f : 0.0f;
          if (first_out != nullptr) first_out[m] = bad != 0.0f ? t : -1;
          if (rows_out != nullptr) rows_out[m] = s.rows;
          for (int k = t + 1; k < H; ++k)
            rews[k * N + m] = __int_as_float(0x7fffffff);
          atomicAdd(queue + 1, t + 1);
          next = started + atomicAdd(queue, 1);
          if (next >= N) next = -1;
        }
        b.n = next;
        b.t = 0;
        bad = 0.0f;
        load_state(s, q0, qd0, per_sample, next < 0 ? N - 1 : next, N);
      } else {
        b.t = t + 1;
      }
      held = b.n >= 0;
    }
    if (g.warp_max(held) == 0) return;
  }
}

// --- launch ---
// The blocks that shared memory lets reside on an SM (228 KB; a block
// holds its slices, the model's tables and the 1 KB the system reserves),
// at most 4: the registers a thread may take are 65536 / (128 · this), as
// many as that occupancy leaves, so that fewer spill.
constexpr int kSharedBytes = (kThreads / kG) * sizeof(Slice);
constexpr long kBlockBytes = kSharedBytes + sizeof(Tables) + 1024;
constexpr int kMinBlocks = 233472 / kBlockBytes < 1 ? 1
                           : (233472 / kBlockBytes > 4 ? 4
                                                       : 233472 / kBlockBytes);
// the retiring form's dynamic shared memory: the slices, then the groups'
// Books
constexpr int kRetireBytes = kSharedBytes + (kThreads / kG) * sizeof(Book);

// the model's run-time tables into the block's shared copy
__device__ __forceinline__ void load_tables() {
  for (int i = threadIdx.x; i < static_cast<int>(sizeof(Tables) / 4);
       i += kThreads)
    reinterpret_cast<int*>(&tables)[i] =
        reinterpret_cast<const int*>(&kTablesInit)[i];
  __syncthreads();
}

// The whole form: a group a sample, every sample all H steps.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    rollout_kernel(const float* __restrict__ q0, const float* __restrict__ qd0,
                   int per_sample, const float* __restrict__ U,
                   float* __restrict__ rews, float* __restrict__ bad_out,
                   float* __restrict__ qs, const float* __restrict__ xref,
                   float* __restrict__ logpd, float* __restrict__ qd_out,
                   int* __restrict__ first_out, int* __restrict__ rows_out,
                   int N, int H) {
  extern __shared__ float smem[];
  load_tables();
  const int grp = threadIdx.x / kG, lane = threadIdx.x % kG;
  const int n = blockIdx.x * (kThreads / kG) + grp;
  // the ragged tail: a group past N rolls sample N − 1 out again and
  // writes nothing, so that every lane takes the warp's barriers
  const Group<kG> g{lane, static_cast<int>(threadIdx.x % 32) - lane};
  rollout_sample<kG>(g, reinterpret_cast<Slice*>(smem)[grp],
                     n < N ? n : N - 1, n < N, q0, qd0, per_sample, U, rews,
                     bad_out, qs, xref, logpd, qd_out, first_out, rows_out,
                     N, H);
}

// The retiring form (rollout_retiring): the groups of the grid start with
// samples 0 … gridDim.x · (kThreads / kG) − 1 and take the rest from
// queue[0]; queue[1] sums the env steps run. The launch zeroes both first.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    rollout_kernel_retire(const float* __restrict__ q0,
                          const float* __restrict__ qd0, int per_sample,
                          const float* __restrict__ U,
                          float* __restrict__ rews,
                          float* __restrict__ bad_out,
                          int* __restrict__ first_out,
                          int* __restrict__ rows_out,
                          int* __restrict__ queue, int N, int H) {
  extern __shared__ float smem[];
  load_tables();
  const int grp = threadIdx.x / kG, lane = threadIdx.x % kG;
  Slice* slices = reinterpret_cast<Slice*>(smem);
  Book* books = reinterpret_cast<Book*>(slices + kThreads / kG);
  const Group<kG> g{lane, static_cast<int>(threadIdx.x % 32) - lane};
  rollout_retiring<kG>(g, slices[grp], books[grp],
                       blockIdx.x * (kThreads / kG) + grp, q0, qd0,
                       per_sample, U, rews, bad_out, first_out, rows_out,
                       queue, gridDim.x * (kThreads / kG), N, H);
}

// Once per device, for each form: the opt-in to dynamic shared memory
// above 48 KB, and the split of each SM's 256 KB between shared memory and
// L1: as much shared memory as the blocks that the registers let reside
// can use, and the rest as L1, which caches the tables' and the spills'
// traffic; left to the driver, the split is only its own guess.
constexpr int kMaxDevices = 64;

template <class Kernel>
cudaError_t prepare_form(Kernel kernel, int shared) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes a;
  e = cudaFuncGetAttributes(&a, kernel);
  if (e != cudaSuccess) return e;
  const int regs = (a.numRegs + 7) / 8 * 8;  // allocated in eights
  int blocks = 65536 / (regs * kThreads);
  blocks = blocks < 1 ? 1 : (blocks > 2048 / kThreads ? 2048 / kThreads
                                                       : blocks);
  // each block's dynamic and static shared memory and the 1 KB the system
  // reserves per block, in percent of the 228 KB maximum
  const long need =
      blocks * (shared + static_cast<long>(a.sharedSizeBytes) + 1024L);
  const long pct = (100 * need + 233471) / 233472;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              static_cast<int>(pct < 100 ? pct : 100));
}

// The whole form.
cudaError_t prepare() {
  static std::atomic<bool> ready[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && ready[dev].load()) return cudaSuccess;
  e = prepare_form(rollout_kernel, kSharedBytes);
  if (e == cudaSuccess && dev < kMaxDevices) ready[dev].store(true);
  return e;
}

// The retiring form, on its first launch or layout, and into *resident
// its blocks that reside on the card at once (blocks per SM × SMs), its
// largest grid.
cudaError_t prepare_retire(int* resident) {
  static std::atomic<int> ready[kMaxDevices];  // *resident; 0: not yet
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && (*resident = ready[dev].load()) > 0)
    return cudaSuccess;
  e = prepare_form(rollout_kernel_retire, kRetireBytes);
  if (e != cudaSuccess) return e;
  int blocks = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, rollout_kernel_retire, kThreads, kRetireBytes);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  *resident = blocks * sms > 0 ? blocks * sms : 1;
  if (dev < kMaxDevices) ready[dev].store(*resident);
  return cudaSuccess;
}

// One form's layout at `grid` blocks (mbd_rollout_attrs).
template <class Kernel>
cudaError_t layout(Kernel kernel, int shared, int grid, int* out) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return e;
  int blocks = 0, dev = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                    kThreads, shared);
  if (e != cudaSuccess) return e;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int v[8] = {kG,
                    kThreads,
                    shared,
                    attr.numRegs,
                    static_cast<int>(attr.localSizeBytes),
                    blocks,
                    blocks * kThreads / 32,
                    grid < sms ? grid : sms};
  for (int k = 0; k < 8; ++k) out[k] = v[k];
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 on success). qs, xref,
// logpd, qd_out, first and rows may be null (see rollout_sample). With a
// queue (two ints on the device), the retiring form (rollout_retiring), which
// takes neither qs, xref, logpd nor qd_out, on at most the blocks that
// reside at once: the grid of the whole form where that fits, so that only
// the exit engages, and above it the refill too; queue[1] then holds the
// env steps the launch ran.
int mbd_rollout(const float* q0, const float* qd0, int per_sample,
                const float* U, float* rews, float* bad, float* qs,
                const float* xref, float* logpd, float* qd_out, int* first,
                int* rows, int* queue, int N, int H, void* stream) {
  const int blocks = (N + kThreads / kG - 1) / (kThreads / kG);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (queue == nullptr) {
    cudaError_t e = prepare();
    if (e != cudaSuccess) return static_cast<int>(e);
    rollout_kernel<<<blocks, kThreads, kSharedBytes, st>>>(
        q0, qd0, per_sample, U, rews, bad, qs, xref, logpd, qd_out, first,
        rows, N, H);
    return static_cast<int>(cudaGetLastError());
  }
  int resident = 0;
  cudaError_t e = prepare_retire(&resident);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaMemsetAsync(queue, 0, 2 * sizeof(int), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int grid = blocks < resident ? blocks : resident;
  rollout_kernel_retire<<<grid, kThreads, kRetireBytes, st>>>(
      q0, qd0, per_sample, U, rews, bad, first, rows, queue, N, H);
  return static_cast<int>(cudaGetLastError());
}

// The layout of a launch at N samples of the whole form (retire = 0) or
// the retiring one, into out[8]: G, threads and dynamic shared bytes per
// block, registers and local bytes per thread, resident blocks and warps
// per SM, SMs in use.
int mbd_rollout_attrs(int N, int retire, int* out) {
  const int grid = (N + kThreads / kG - 1) / (kThreads / kG);
  int resident = 0;
  cudaError_t e = retire ? prepare_retire(&resident) : prepare();
  if (e != cudaSuccess) return static_cast<int>(e);
  e = retire ? layout(rollout_kernel_retire, kRetireBytes,
                      grid < resident ? grid : resident, out)
             : layout(rollout_kernel, kSharedBytes, grid, out);
  return static_cast<int>(e);
}

}  // extern "C"
