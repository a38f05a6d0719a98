// Whole-rollout kernel for NVIDIA Hopper (sm_90a): every sample's H env
// steps × NFRAMES physics substeps, with the env reward, in one launch.
//
// Replaces the TPU kernel mbd_tpu/ops/rollout_pallas.py::make_rollout_kernel
// (the body `kernel`, launched by `rollout_fn` through pl.pallas_call):
// per-step rewards rews[H, N] and the validity flag bad[N], from a shared
// (q0[nq]) or per-sample (q0[nq, N]) initial state; with need_qs the
// post-step position trace qs[H, nq, N]; with demo the demo-tracking
// log-density logpd[N] against the env's demo frames xref, read at run
// time so that every clip of a model shares one build.
//
// Design. One thread per sample. A thread keeps its q, qd and every
// per-substep intermediate (link poses, spatial inertias, the tree-sparse
// LᵀDL factor, the constraint rows) in registers and local memory, loops
// over H × NFRAMES, reads U[t, :, n] and writes rews[t, n] coalesced along
// N, and masks the ragged tail. The body below is written once; the model
// arrives as a generated header ("model.h", see ops/rollout_cuda.py) of
// sizes and constexpr accessors, so `#pragma unroll` loops over the
// topology resolve at compile time the way sim/batched.py unrolls in
// Python. The math and its order follow the torch engine
// (mbd_tpu_torch/sim/batched.py) term for term; it is built with
// --fmad=false so every multiply and add rounds as the torch version's
// separate elementwise kernels do.
//
// Joints: free, hinge and slide, in one tree or a forest of roots. Pairs:
// plane–sphere, plane–capsule, capsule–capsule and sphere–box (pushT's
// pusher against the slider's bars). Rewards: one branch per env (kReward,
// model.h). The demo pass reruns the forward kinematics
// without the motion subspaces (fk<false>) once per env step; the trace
// and the score are epilogues of the serial per-thread program, not a
// pass of their own.
//
// What bounds it on this card: latency and registers, not bytes. Per
// substep a sample does a few thousand dependent float ops (tens of
// thousands on the humanoids) over a working set of about 2·NC×NV
// constraint-row entries (17×6 for hopper, 36×23 for humanoidrun), which
// does not fit in 255 registers and lives in local memory; one thread per
// sample at N = 2048 fills 16 blocks of 128 threads, a small fraction of
// the 132 SMs. On large models (kRowUnroll = 1) the per-row solve and the
// Gauss–Seidel rows stay rolled loops: fully unrolled, NC tree solves over
// NV dofs make a program that nvcc takes minutes to build, and the rows
// are in local memory either way. Both are measured (PERF.md) and left
// for later work. The loops over the topology walk per-model lists (a
// dof's ancestor chain, a body's joints, dofs and children; model.h), not
// every index pair with a test: the code nvcc unrolls then grows with the
// tree's edges, where the tests made the factor alone NV³ copies.

#include <cuda_runtime.h>

#include <type_traits>

#include "model.h"

namespace {

constexpr int kThreads = 128;
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

// Solve (LᵀDL) x = x in place along the dof tree (sim/batched.py::ldl_solve
// with structural zeros as 0). anc(i, ·) walks i's dof-tree ancestors from
// the parent up, the order of the torch engine's parent loop.
__device__ __forceinline__ void ldl_solve(const float (&F)[NV][NV],
                                          float* x) {
  static_for<NV - 1, -1, -1>([&](auto I) {
    constexpr int i = IDX(I);
    static_for<0, n_anc(i)>([&](auto M) {
      constexpr int j = anc(IDX(I), IDX(M));
      x[j] = x[j] - F[IDX(I)][j] * x[IDX(I)];
    });
  });
#pragma unroll
  for (int i = 0; i < NV; ++i) x[i] = x[i] / F[i][i];
  static_for<0, NV>([&](auto I) {
    constexpr int i = IDX(I);
    static_for<0, n_anc(i)>([&](auto M) {
      constexpr int j = anc(IDX(I), IDX(M));
      x[IDX(I)] = x[IDX(I)] - F[IDX(I)][j] * x[j];
    });
  });
}

// Forward kinematics (sim/batched.py::fk_b): every body's world position
// and orientation and, with kMotion, every dof's motion subspace S
// ([angular, linear] about the world origin). Bodies whose parent is the
// world start from its identity pose, so a forest needs nothing more.
template <bool kMotion>
__device__ __forceinline__ void fk(const float* q, float (&xpos)[NB][3],
                                   float (&xquat)[NB][4], float (*S)[6]) {
  xpos[0][0] = xpos[0][1] = xpos[0][2] = 0.0f;
  xquat[0][0] = 1.0f;
  xquat[0][1] = xquat[0][2] = xquat[0][3] = 0.0f;
  static_for<1, NB>([&](auto B) {
    constexpr int b = IDX(B), p = body_parent(b);
    float c[3], pos[3], quat[4];
    const float bp[3] = {body_pos(b, 0), body_pos(b, 1), body_pos(b, 2)};
    const float bq[4] = {body_quat(b, 0), body_quat(b, 1), body_quat(b, 2),
                         body_quat(b, 3)};
    qrot(xquat[p], bp, c);
#pragma unroll
    for (int k = 0; k < 3; ++k) pos[k] = xpos[p][k] + c[k];
    qmul(xquat[p], bq, quat);
    static_for<0, n_body_jnt(b)>([&](auto M) {
      constexpr int j = body_jnt(IDX(B), IDX(M));
      constexpr int qa = jnt_qadr(j), da = jnt_dadr(j);
      if constexpr (jnt_type(j) == kFree) {
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
        const float ax[3] = {jnt_axis(j, 0), jnt_axis(j, 1), jnt_axis(j, 2)};
        float axis_w[3];
        qrot(quat, ax, axis_w);
        if constexpr (jnt_type(j) == kHinge) {
          const float jp[3] = {jnt_pos(j, 0), jnt_pos(j, 1), jnt_pos(j, 2)};
          const float theta = q[qa] - init_q(qa);
          float anchor[3], dq[4], nq[4];
          qrot(quat, jp, c);
#pragma unroll
          for (int k = 0; k < 3; ++k) anchor[k] = pos[k] + c[k];
          const float s = sinf(0.5f * theta);
          dq[0] = cosf(0.5f * theta);
          dq[1] = ax[0] * s;
          dq[2] = ax[1] * s;
          dq[3] = ax[2] * s;
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
          const float d = q[qa] - init_q(qa);
#pragma unroll
          for (int k = 0; k < 3; ++k) pos[k] = pos[k] + axis_w[k] * d;
          if constexpr (kMotion) {
            S[da][0] = S[da][1] = S[da][2] = 0.0f;
#pragma unroll
            for (int k = 0; k < 3; ++k) S[da][3 + k] = axis_w[k];
          }
        }
      }
    });
#pragma unroll
    for (int k = 0; k < 3; ++k) xpos[b][k] = pos[k];
#pragma unroll
    for (int k = 0; k < 4; ++k) xquat[b][k] = quat[k];
  });
}

// One physics substep (sim/batched.py::substep_b), in place on q, qd.
__device__ void substep(float* q, float* qd, const float* u) {
  // ---- forward kinematics ----
  float xpos[NB][3], xquat[NB][4], S[NV][6];
  fk<true>(q, xpos, xquat, S);

  // ---- spatial inertias (own and composite) ----
  float Ib[NB][kIn], Ic[NB][kIn];
#pragma unroll
  for (int b = 1; b < NB; ++b) {
    const float ip[3] = {body_ipos(b, 0), body_ipos(b, 1), body_ipos(b, 2)};
    const float iqc[4] = {body_iquat(b, 0), body_iquat(b, 1),
                          body_iquat(b, 2), body_iquat(b, 3)};
    const float m = body_mass(b);
    float c[3], com[3], iq[4];
    qrot(xquat[b], ip, c);
#pragma unroll
    for (int k = 0; k < 3; ++k) com[k] = xpos[b][k] + c[k];
    qmul(xquat[b], iqc, iq);
    const float w = iq[0], x = iq[1], y = iq[2], z = iq[3];
    const float col[3][3] = {
        {1.0f - 2.0f * (y * y + z * z), 2.0f * (x * y + w * z),
         2.0f * (x * z - w * y)},
        {2.0f * (x * y - w * z), 1.0f - 2.0f * (x * x + z * z),
         2.0f * (y * z + w * x)},
        {2.0f * (x * z + w * y), 2.0f * (y * z - w * x),
         1.0f - 2.0f * (x * x + y * y)}};
    const float c2sum = com[0] * com[0] + com[1] * com[1] + com[2] * com[2];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int bb = 0; bb < 3; ++bb) {
        const float irot = body_inertia(b, 0) * col[0][a] * col[0][bb] +
                           body_inertia(b, 1) * col[1][a] * col[1][bb] +
                           body_inertia(b, 2) * col[2][a] * col[2][bb];
        const float extra = (a == bb) ? m * (c2sum - com[a] * com[bb])
                                      : m * (-(com[a] * com[bb]));
        Ib[b][3 * a + bb] = irot + extra;
      }
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) Ib[b][9 + k] = m * com[k];
    Ib[b][12] = m;
  }
  static_for<NB - 1, 0, -1>([&](auto B) {
    constexpr int b = IDX(B);
#pragma unroll
    for (int k = 0; k < kIn; ++k) Ic[b][k] = Ib[b][k];
    static_for<0, n_child(b)>([&](auto M) {
      constexpr int c = child(IDX(B), IDX(M));
#pragma unroll
      for (int k = 0; k < kIn; ++k) Ic[IDX(B)][k] = Ic[IDX(B)][k] + Ic[c][k];
    });
  });

  // ---- mass matrix (CRBA) ----
  float F[NV][NV];  // lower triangle: M, then the LᵀDL factor in place
  static_for<0, NV>([&](auto I) {
    constexpr int i = IDX(I);
    float Fi[6];
    matvec6(Ic[dof_body(i)], S[i], Fi);
    static_for<0, n_mpair(i)>([&](auto M) {
      constexpr int j = mpair(IDX(I), IDX(M));
      float acc = Fi[0] * S[j][0];
#pragma unroll
      for (int k = 1; k < 6; ++k) acc = acc + Fi[k] * S[j][k];
      F[IDX(I)][j] = acc;
    });
    F[i][i] = F[i][i] + armature(i);
  });

  // ---- bias (RNEA) ----
  float W[NV][6], vb[NB][6], ab[NB][6];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
#pragma unroll
    for (int k = 0; k < 6; ++k) W[i][k] = S[i][k] * qd[i];
  }
#pragma unroll
  for (int k = 0; k < 6; ++k) vb[0][k] = 0.0f;
  static_for<1, NB>([&](auto B) {
    constexpr int b = IDX(B);
#pragma unroll
    for (int k = 0; k < 6; ++k) vb[b][k] = vb[body_parent(b)][k];
    static_for<0, n_own(b)>([&](auto M) {
      constexpr int i = own(IDX(B), IDX(M));
#pragma unroll
      for (int k = 0; k < 6; ++k) vb[IDX(B)][k] = vb[IDX(B)][k] + W[i][k];
    });
  });
  ab[0][0] = ab[0][1] = ab[0][2] = 0.0f;
  ab[0][3] = -gravity(0);
  ab[0][4] = -gravity(1);
  ab[0][5] = -gravity(2);
  static_for<1, NB>([&](auto B) {
    constexpr int b = IDX(B), p = body_parent(b);
#pragma unroll
    for (int k = 0; k < 6; ++k) ab[b][k] = ab[p][k];
    static_for<0, n_own(b)>([&](auto M) {
      constexpr int i = own(IDX(B), IDX(M));
      float vp[6], sd[6];
#pragma unroll
      for (int k = 0; k < 6; ++k) vp[k] = vb[body_parent(IDX(B))][k];
      static_for<0, n_prev(i)>([&](auto MM) {
        constexpr int j = prev(own(IDX(B), IDX(M)), IDX(MM));
#pragma unroll
        for (int k = 0; k < 6; ++k) vp[k] = vp[k] + W[j][k];
      });
      crm(vp, W[i], sd);
#pragma unroll
      for (int k = 0; k < 6; ++k) ab[IDX(B)][k] = ab[IDX(B)][k] + sd[k];
    });
  });
  float fsub[NB][6];
  static_for<NB - 1, 0, -1>([&](auto B) {
    constexpr int b = IDX(B);
    float Ia[6], Iv[6], cf[6];
    matvec6(Ib[b], ab[b], Ia);
    matvec6(Ib[b], vb[b], Iv);
    crf(vb[b], Iv, cf);
#pragma unroll
    for (int k = 0; k < 6; ++k) fsub[b][k] = Ia[k] + cf[k];
    static_for<0, n_child(b)>([&](auto M) {
      constexpr int c = child(IDX(B), IDX(M));
#pragma unroll
      for (int k = 0; k < 6; ++k)
        fsub[IDX(B)][k] = fsub[IDX(B)][k] + fsub[c][k];
    });
  });
  float rhs[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const float* f = fsub[dof_body(i)];
    float bias = S[i][0] * f[0];
#pragma unroll
    for (int k = 1; k < 6; ++k) bias = bias + S[i][k] * f[k];
    rhs[i] = bias;  // completed below
  }

  // ---- implicit damping (joint + active-limit) on the diagonal ----
  float extra[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) extra[i] = h_damping(i);
  float lim_vio[2 * NLIMJ + 1];
#pragma unroll
  for (int l = 0; l < NLIMJ; ++l) {
    const int qa = limj_qadr(l), da = limj_dadr(l);
    const float below = tmax(limj_lo(l) - q[qa], 0.0f);
    const float above = tmax(q[qa] - limj_hi(l), 0.0f);
    const float active = (below > 0.0f || above > 0.0f) ? 1.0f : 0.0f;
    extra[da] = extra[da] + limj_dlim(l) * active;
    lim_vio[2 * l] = below;
    lim_vio[2 * l + 1] = above;
  }
#pragma unroll
  for (int i = 0; i < NV; ++i) F[i][i] = F[i][i] + extra[i];

  // ---- LᵀDL factor (leaf-most dofs first; i over k's ancestors, then
  // j = i and i's ancestors, each from the highest index down) ----
  static_for<NV - 1, -1, -1>([&](auto K) {
    constexpr int k = IDX(K);
    const float inv_d = 1.0f / F[k][k];
    static_for<0, n_anc(k)>([&](auto M) {
      constexpr int k = IDX(K), i = anc(k, IDX(M));
      const float a = F[k][i] * inv_d;
      F[i][i] = F[i][i] - a * F[k][i];
      static_for<0, n_anc(i)>([&](auto MM) {
        constexpr int k = IDX(K), i = anc(k, IDX(M)), j = anc(i, IDX(MM));
        F[i][j] = F[i][j] - a * F[k][j];
      });
      F[k][i] = a;
    });
  });

  // ---- generalized forces: actuators, springs, bias, damping ----
  float qfrc[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) qfrc[i] = 0.0f;
#pragma unroll
  for (int a = 0; a < NU; ++a) {
    const float uc = tmin(tmax(u[a], act_lo(a)), act_hi(a));
    qfrc[act_dadr(a)] = qfrc[act_dadr(a)] + act_gear(a) * uc;
  }
#pragma unroll
  for (int s = 0; s < NSPRING; ++s) {
    qfrc[spring_dadr(s)] = qfrc[spring_dadr(s)] -
                           spring_k(s) * (q[spring_qadr(s)] - spring_q0(s));
  }
#pragma unroll
  for (int i = 0; i < NV; ++i)
    rhs[i] = qfrc[i] - rhs[i] - damping(i) * qd[i];

#if NC > 0
  // ---- constraint rows: contacts (pair order), then limits ----
  // J is built in MinvJ and solved in place. Above kRowUnroll = 1 the
  // per-row loops stay rolled (large models), which keeps the build short
  // and changes no operation's order.
  float MinvJ[NC][NV], Row[NC][NV];
  float vn[NC], vbias[NC], cap[NC], meff[NC], fnmax[NC];
#pragma unroll
  for (int p = 0; p < NPAIR; ++p) {
    const int ga = pair_body_a(p), gb = pair_body_b(p);
    float pa[3], qa[4], pb[3], qb[4];
    {
      const float gp[3] = {pair_pos_a(p, 0), pair_pos_a(p, 1),
                           pair_pos_a(p, 2)};
      const float gq[4] = {pair_quat_a(p, 0), pair_quat_a(p, 1),
                           pair_quat_a(p, 2), pair_quat_a(p, 3)};
      if (ga == 0) {
#pragma unroll
        for (int k = 0; k < 3; ++k) pa[k] = gp[k];
#pragma unroll
        for (int k = 0; k < 4; ++k) qa[k] = gq[k];
      } else {
        float c[3];
        qrot(xquat[ga], gp, c);
#pragma unroll
        for (int k = 0; k < 3; ++k) pa[k] = xpos[ga][k] + c[k];
        qmul(xquat[ga], gq, qa);
      }
    }
    {
      const float gp[3] = {pair_pos_b(p, 0), pair_pos_b(p, 1),
                           pair_pos_b(p, 2)};
      const float gq[4] = {pair_quat_b(p, 0), pair_quat_b(p, 1),
                           pair_quat_b(p, 2), pair_quat_b(p, 3)};
      if (gb == 0) {
#pragma unroll
        for (int k = 0; k < 3; ++k) pb[k] = gp[k];
#pragma unroll
        for (int k = 0; k < 4; ++k) qb[k] = gq[k];
      } else {
        float c[3];
        qrot(xquat[gb], gp, c);
#pragma unroll
        for (int k = 0; k < 3; ++k) pb[k] = xpos[gb][k] + c[k];
        qmul(xquat[gb], gq, qb);
      }
    }
    // contact points of this pair: position, normal, depth
    float cpos[2][3], cn[2][3], cdep[2];
    int npts = 0;
    if (pair_kind(p) == kPlaneSphere) {
      float n[3], d[3];
      zhat(qa, n);
      const float r = pair_r2(p);
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
    } else if (pair_kind(p) == kPlaneCapsule) {
      float n[3], axis[3];
      zhat(qa, n);
      zhat(qb, axis);
      const float r = pair_r2(p);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float hl = (e == 0) ? pair_hl2(p) : -pair_hl2(p);
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
    } else if (pair_kind(p) == kCapsuleCapsule) {
      const float r1 = pair_r1(p), hl1 = pair_hl1(p);
      const float r2 = pair_r2(p), hl2 = pair_hl2(p);
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
      float s = tmin(tmax((bq * fq - c) / denom, -hl1), hl1);
      const float t = tmin(tmax(bq * s + fq, -hl2), hl2);
      s = tmin(tmax(bq * t - c, -hl1), hl1);
      float c1p[3], c2p[3], delta[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        c1p[k] = pa[k] + d1[k] * s;
        c2p[k] = pb[k] + d2[k] * t;
        delta[k] = c2p[k] - c1p[k];
      }
      const float dist = sqrtf(dot3(delta, delta));
      const float dn = tmax(dist, 1e-9f);
#pragma unroll
      for (int k = 0; k < 3; ++k) cn[0][k] = delta[k] / dn;
      cdep[0] = pair_r12(p) - dist;
#pragma unroll
      for (int k = 0; k < 3; ++k)
        cpos[0][k] =
            0.5f * (c1p[k] + cn[0][k] * r1 + c2p[k] - cn[0][k] * r2);
      npts = 1;
    } else if (pair_kind(p) == kSphereBox) {
      // sphere a against box b, in the box's frame (sim/batched.py
      // collide_b): the clamped point outside the box, else the face of
      // least penetration, ties to the lowest axis (torch.argmin). The
      // one-hot sums keep the plain version's form, signs of zero
      // included.
      const float r = pair_r1(p);
      float col[3][3], d[3], pl[3], cl[3], delta[3], fd[3], oh[3];
      quat_cols(qb, col);
#pragma unroll
      for (int k = 0; k < 3; ++k) d[k] = pa[k] - pb[k];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float half = pair_box_b(p, k);
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
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (e >= npts) continue;
      const int ci = pair_start(p) + e;
      const float* pos = cpos[e];
      const float* n = cn[e];
      const float dep = cdep[e];
      float va[3], vbp[3], vrel[3], vt[3], tdir[3], d[3], tmp[3];
      cross3(vb[ga], pos, tmp);
#pragma unroll
      for (int k = 0; k < 3; ++k) va[k] = vb[ga][3 + k] + tmp[k];
      cross3(vb[gb], pos, tmp);
#pragma unroll
      for (int k = 0; k < 3; ++k) vbp[k] = vb[gb][3 + k] + tmp[k];
#pragma unroll
      for (int k = 0; k < 3; ++k) vrel[k] = vbp[k] - va[k];
      const float vnc = dot3(vrel, n);
#pragma unroll
      for (int k = 0; k < 3; ++k) vt[k] = vrel[k] - vnc * n[k];
      const float tn = sqrtf(dot3(vt, vt) + kEps2);
#pragma unroll
      for (int k = 0; k < 3; ++k) tdir[k] = vt[k] / tn;
#pragma unroll
      for (int k = 0; k < 3; ++k) d[k] = n[k] - pair_mu(p) * tdir[k];
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
        float aj = S[i][0] * wj[0], ar = S[i][0] * wr[0];
#pragma unroll
        for (int k = 1; k < 6; ++k) {
          aj = aj + S[i][k] * wj[k];
          ar = ar + S[i][k] * wr[k];
        }
        MinvJ[ci][i] = con_sgn(ci, i) * aj;  // J, solved in place below
        Row[ci][i] = con_sgn(ci, i) * ar;
      }
      const float aref = tmax(kContactK * dep - kContactB * vnc, 0.0f);
      vn[ci] = vnc;
      vbias[ci] = tmin(tmax(dep, 0.0f) * kBetaInvH, kVPushMax);
      cap[ci] = aref * (dep > 0.0f ? 1.0f : 0.0f);
    }
  }
#pragma unroll
  for (int l = 0; l < NLIMJ; ++l) {
    const int da = limj_dadr(l);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int ci = NCON + 2 * l + e;
      const float s = (e == 0) ? 1.0f : -1.0f;
      const float vio = lim_vio[2 * l + e];
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        MinvJ[ci][i] = (i == da) ? s : 0.0f;
        Row[ci][i] = MinvJ[ci][i];
      }
      vn[ci] = s * qd[da];
      vbias[ci] = tmin(vio * kBetaInvH, kVPushMax);
      cap[ci] = kLimitK * vio * (vio > 0.0f ? 1.0f : 0.0f);
    }
  }

  // ---- M⁻¹Jᵀ and effective masses, one tree solve per row ----
#pragma unroll (kRowUnroll)
  for (int c = 0; c < NC; ++c) {
    float J[NV], x[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      J[i] = MinvJ[c][i];
      x[i] = J[i];
    }
    ldl_solve(F, x);
    float jmj = J[0] * x[0];
#pragma unroll
    for (int i = 1; i < NV; ++i) jmj = jmj + J[i] * x[i];
#pragma unroll
    for (int i = 0; i < NV; ++i) MinvJ[c][i] = x[i];
    meff[c] = 1.0f / (jmj + 1e-8f);
    fnmax[c] = meff[c] * cap[c];
  }

  // ---- projected Gauss–Seidel sweep ----
  float fns[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) fns[c] = 0.0f;
#pragma unroll 1
  for (int pass = 0; pass < kGsPasses; ++pass) {
#pragma unroll (kRowUnroll)
    for (int c = 0; c < NC; ++c) {
      float jacc = MinvJ[c][0] * rhs[0];
#pragma unroll
      for (int i = 1; i < NV; ++i) jacc = jacc + MinvJ[c][i] * rhs[i];
      const float vn_pred = vn[c] + kH * jacc;
      const float fn_new = tmin(
          tmax(fns[c] + meff[c] * (vbias[c] - vn_pred) * kInvH, 0.0f),
          fnmax[c]);
      const float dfn = fn_new - fns[c];
#pragma unroll
      for (int i = 0; i < NV; ++i) rhs[i] = rhs[i] + Row[c][i] * dfn;
      fns[c] = fn_new;
    }
  }
#endif

  // ---- accelerations and the semi-implicit Euler update ----
  ldl_solve(F, rhs);
#pragma unroll
  for (int i = 0; i < NV; ++i) qd[i] = qd[i] + kH * rhs[i];
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
    const float dq[4] = {cosf(half), w[0] * sinc, w[1] * sinc, w[2] * sinc};
    float qn[4];
    qmul(q + qa + 3, dq, qn);
    const float nrm = sqrtf(qn[0] * qn[0] + qn[1] * qn[1] + qn[2] * qn[2] +
                            qn[3] * qn[3]);
#pragma unroll
    for (int k = 0; k < 4; ++k) q[qa + 3 + k] = qn[k] / nrm;
  }
}

#if NTRACK > 0
// Demo tracking (rollout_pallas.py:132-141): one positions-only FK pass on
// the post-step q, then per tracked body the squared distance to its demo
// frame xref_t [NTRACK][3], summed left to right, and
// acc += (clip(‖x − xref_t‖, 0, 0.5)/0.5)².
__device__ void track_cost(const float* q, const float* xref_t, float& acc) {
  float xpos[NB][3], xquat[NB][4];
  fk<false>(q, xpos, xquat, nullptr);
#pragma unroll
  for (int i = 0; i < NTRACK; ++i) {
    float d2 = 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float d = xpos[track_body(i)][c] - xref_t[3 * i + c];
      d2 = d2 + d * d;
    }
    const float e = tmin(tmax(sqrtf(d2), 0.0f), 0.5f) / 0.5f;
    acc = acc + e * e;
  }
}
#endif

// qs [H, NQ, N] (the post-step position trace) and logpd [N] (the demo
// log-density, against xref [H_demo, NTRACK, 3]) are written only when
// their pointers are not null.
__global__ void __launch_bounds__(kThreads)
    rollout_kernel(const float* __restrict__ q0, const float* __restrict__ qd0,
                   int per_sample, const float* __restrict__ U,
                   float* __restrict__ rews, float* __restrict__ bad_out,
                   float* __restrict__ qs, const float* __restrict__ xref,
                   float* __restrict__ logpd, int N, int H) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float q[NQ], qd[NV], u[NU];
#pragma unroll
  for (int i = 0; i < NQ; ++i) q[i] = per_sample ? q0[i * N + n] : q0[i];
#pragma unroll
  for (int i = 0; i < NV; ++i) qd[i] = per_sample ? qd0[i * N + n] : qd0[i];
  float bad = 0.0f, acc = 0.0f;
#pragma unroll 1
  for (int t = 0; t < H; ++t) {
#pragma unroll
    for (int a = 0; a < NU; ++a) u[a] = U[(t * NU + a) * N + n];
    const float x_prev = q[0];
    // the track reward reads the pre-step state (free root: torso x
    // velocity qd[0], torso (y, z) = q[1], q[2])
    float r_pre = 0.0f;
    if (kReward == kRewardTrack) {
      r_pre = 1.0f + (-fabsf(qd[0] - kVTarget) - fabsf(q[2] - kZTarget) -
                      0.1f * fabsf(q[1]));
    }
#pragma unroll 1
    for (int f = 0; f < NFRAMES; ++f) {
      substep(q, qd, u);
      // validity: NaN-propagating max|qd|, then the root-height sensors
      float speed = fabsf(qd[0]);
#pragma unroll
      for (int i = 1; i < NV; ++i) speed = tmax(speed, fabsf(qd[i]));
      bad = tmax(bad, speed > kQdDiverged ? 1.0f : 0.0f);
#pragma unroll
      for (int s = 0; s < NSENSOR; ++s) {
        bad = tmax(bad,
                   q[sensor_qadr(s)] + sensor_off(s) < kZmin ? 1.0f : 0.0f);
      }
#pragma unroll
      for (int i = 0; i < NV; ++i)
        qd[i] = tmin(tmax(qd[i], -kQdDiverged), kQdDiverged);
    }
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
    rews[t * N + n] = r;
    if (qs != nullptr) {
#pragma unroll
      for (int i = 0; i < NQ; ++i) qs[(t * NQ + i) * N + n] = q[i];
    }
#if NTRACK > 0
    if (logpd != nullptr) track_cost(q, xref + t * NTRACK * 3, acc);
#endif
  }
  bad_out[n] = bad;
#if NTRACK > 0
  if (logpd != nullptr) logpd[n] = -acc / static_cast<float>(NTRACK * H);
#endif
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 on success). qs,
// xref and logpd may be null (see rollout_kernel).
int mbd_rollout(const float* q0, const float* qd0, int per_sample,
                const float* U, float* rews, float* bad, float* qs,
                const float* xref, float* logpd, int N, int H,
                void* stream) {
  const dim3 grid((N + kThreads - 1) / kThreads), block(kThreads);
  rollout_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      q0, qd0, per_sample, U, rews, bad, qs, xref, logpd, N, H);
  return static_cast<int>(cudaGetLastError());
}

// Registers, local (spill + array) bytes per thread, and resident blocks
// per SM, as the runtime reports them for this build.
int mbd_rollout_attrs(int* regs, int* local_bytes, int* blocks_per_sm,
                      int* threads_per_block) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, rollout_kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *threads_per_block = kThreads;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm,
                                                    rollout_kernel, kThreads,
                                                    0);
  return static_cast<int>(e);
}

}  // extern "C"
