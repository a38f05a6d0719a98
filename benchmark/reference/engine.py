"""The plain reference's physics: a frozen copy of the port's batch-last
engine (``mbd_tpu_torch/sim/batched.py`` at commit f68a38a, with
``sim/contact.py``'s three constants), the same substep on flat ``[k, N]``
tensors: forward kinematics, CRBA/RNEA, the tree-sparse LᵀDL factor,
collision, the projected Gauss–Seidel contact and joint-limit sweep, the
integrator and the validity flags.

It imports nothing of the port. Three changes from the original, none of
which changes a value:

* every constant tensor the substep makes from host numbers (``constv``,
  the inertia tables, the rows' signs, two scalars) is made once per
  device and dtype and then reused (``_const``), so that a substep on
  the card does not wait on a host-to-device copy;
* ``RECORD`` replaces ``ROW_LOG``: when set, each substep adds, per
  sample, the contact and limit rows that acted (force cap not 0) while
  the sample was still live (not yet flagged at the start of its env
  step), for the work count (``benchmark/work/count.py``);
* imports are local.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .system import (FREE, HINGE, PAIR_CAPSULE_CAPSULE, PAIR_PLANE_CAPSULE,
                     PAIR_PLANE_SPHERE, PAIR_SPHERE_BOX, PLANE, SLIDE, System)

Arr = torch.Tensor   # [N] or [k, N]

# the contact solver's constants (mbd_tpu_torch/sim/contact.py)
BAUMGARTE_BETA = 0.2
V_PUSH_MAX = 0.2     # m/s — max depenetration velocity a contact may add
N_GS_PASSES = 4

# Validity envelope (mbd_tpu/sim/batched.py:1254-1260): joint speeds beyond
# QD_DIVERGED, or a root body sunk more than ROOT_SINK_TOL below the floor,
# flag the sample; qd is clamped so float32 never overflows.
QD_DIVERGED = 100.0
ROOT_SINK_TOL = 0.2


def f32(x: float) -> float:
    """Round a Python float to the nearest float32 value."""
    return float(np.float32(x))


def recip32(x: float) -> float:
    """float32 reciprocal of a float32 constant."""
    return float(np.float32(1.0) / np.float32(x))


def fold(t: Arr) -> Arr:
    """Sum over dim 0, left to right."""
    acc = t[0]
    for k in range(1, t.shape[0]):
        acc = acc + t[k]
    return acc


def fold1(t: Arr) -> Arr:
    """Sum over dim 1, left to right."""
    acc = t[:, 0]
    for k in range(1, t.shape[1]):
        acc = acc + t[:, k]
    return acc


_CONSTS: Dict[tuple, Arr] = {}


def _const(key, make, ref: Arr) -> Arr:
    """``make()`` as a tensor of ref's dtype on ref's device, made once per
    (key, dtype, device)."""
    full = (key, ref.dtype, str(ref.device))
    if full not in _CONSTS:
        _CONSTS[full] = torch.tensor(make(), dtype=ref.dtype,
                                     device=ref.device)
    return _CONSTS[full]


def _array(arr: np.ndarray, ref: Arr) -> Arr:
    """``torch.tensor(arr)`` in ref's dtype on ref's device (``_const``)."""
    arr = np.ascontiguousarray(arr)
    return _const(("a", arr.dtype.str, arr.shape, arr.tobytes()),
                  lambda: arr, ref)


def _scalar(x: float, ref: Arr) -> Arr:
    """``ref.new_tensor(x)`` (``_const``)."""
    return _const(("s", x), lambda: x, ref)


def constv(vals, ref: Arr) -> Arr:
    """[k, 1] float32 constant on ref's device (broadcasts against [k, N])."""
    col = tuple(float(v) for v in vals)
    return _const(("v", col), lambda: [[v] for v in col], ref)


# ---------------------------------------------------------------------------
# component-first quaternion / vector helpers: [3, N] / [4, N]
# ---------------------------------------------------------------------------

def qmul(a: Arr, b: Arr) -> Arr:
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ])


def cross(a: Arr, b: Arr) -> Arr:
    return torch.stack([
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    ])


def qrot(q: Arr, v: Arr) -> Arr:
    """Rotate [3, N] vector by [4, N] quaternion."""
    w = q[0]
    qv = q[1:]
    t = 2.0 * cross(qv, v)
    return v + w * t + cross(qv, t)


def dot3(a: Arr, b: Arr) -> Arr:
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def quat_to_cols(q: Arr) -> Tuple[Arr, Arr, Arr]:
    """Columns of R(q) as three [3, N] vectors."""
    w, x, y, z = q
    c0 = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y + w * z),
                      2 * (x * z - w * y)])
    c1 = torch.stack([2 * (x * y - w * z), 1 - 2 * (x * x + z * z),
                      2 * (y * z + w * x)])
    c2 = torch.stack([2 * (x * z + w * y), 2 * (y * z - w * x),
                      1 - 2 * (x * x + y * y)])
    return c0, c1, c2


# Axis-1 variants: operands carry a leading stacking axis ([C, 3, N]).
# Formulas and accumulation order match the [k, N] helpers exactly.

def cross_c(a: Arr, b: Arr) -> Arr:
    return torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                        a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                        a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], dim=1)


def dot3_c(a: Arr, b: Arr) -> Arr:
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


def qmul_c(a: Arr, b: Arr) -> Arr:
    aw, ax, ay, az = a[:, 0], a[:, 1], a[:, 2], a[:, 3]
    bw, bx, by, bz = b[:, 0], b[:, 1], b[:, 2], b[:, 3]
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=1)


def qrot_c(q: Arr, v: Arr) -> Arr:
    w = q[:, 0]
    qv = q[:, 1:]
    t = 2.0 * cross_c(qv, v)
    return v + w[:, None] * t + cross_c(qv, t)


def quat_to_cols_c(q: Arr) -> Tuple[Arr, Arr, Arr]:
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    c0 = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y + w * z),
                      2 * (x * z - w * y)], dim=1)
    c1 = torch.stack([2 * (x * y - w * z), 1 - 2 * (x * x + z * z),
                      2 * (y * z + w * x)], dim=1)
    c2 = torch.stack([2 * (x * z + w * y), 2 * (y * z - w * x),
                      1 - 2 * (x * x + y * y)], dim=1)
    return c0, c1, c2


def axis_angle_quat(axis, theta: Arr) -> Arr:
    """Quaternion [4, N] for rotation of theta [N] about a constant axis."""
    s = torch.sin(0.5 * theta)
    return torch.stack([torch.cos(0.5 * theta), float(axis[0]) * s,
                        float(axis[1]) * s, float(axis[2]) * s])


# ---------------------------------------------------------------------------
# static topology
# ---------------------------------------------------------------------------

class Topo(NamedTuple):
    ancdof_body: List[List[int]]     # dofs on ancestor-or-self bodies of b
    dof_pairs: List[Tuple[int, int]]  # lower-triangular M sparsity
    prevdof: List[List[int]]
    own_dofs: List[List[int]]
    children: List[List[int]]
    body_joints: List[List[int]]
    dof_parent: Tuple[int, ...]


def _dof_parents(sys: System) -> Tuple[int, ...]:
    """dof-tree parent: largest j < i with body(j) ancestor-or-self of
    body(i); −1 at roots. M's sparsity is exactly this tree's paths."""
    D = sys.host("mask_dof_dof")
    out = []
    for i in range(sys.nv):
        anc = [j for j in range(i) if D[i, j] > 0]
        out.append(anc[-1] if anc else -1)
    return tuple(out)


def topo(sys: System) -> Topo:
    def build():
        A = sys.host("mask_ancdof_body")
        D = sys.host("mask_dof_dof")
        P = sys.host("mask_dof_prevdof")
        nv, nb = sys.nv, sys.nbody
        return Topo(
            ancdof_body=[[i for i in range(nv) if A[b, i] > 0]
                         for b in range(nb)],
            dof_pairs=[(i, j) for i in range(nv) for j in range(nv)
                       if j <= i and (D[i, j] > 0 or D[j, i] > 0)],
            prevdof=[[j for j in range(nv) if P[i, j] > 0]
                     for i in range(nv)],
            own_dofs=[[i for i in range(nv) if sys.dof_bodyid[i] == b]
                      for b in range(nb)],
            children=[[c for c in range(1, nb) if sys.body_parentid[c] == b]
                      for b in range(nb)],
            body_joints=[[j for j in range(sys.njnt)
                          if sys.jnt_bodyid[j] == b] for b in range(nb)],
            dof_parent=_dof_parents(sys))
    return sys.cached("topo", build)


# ---------------------------------------------------------------------------
# forward kinematics
# ---------------------------------------------------------------------------

class KinB(NamedTuple):
    xpos: List[Arr]     # nbody × [3, N]
    xquat: List[Arr]    # nbody × [4, N]
    S: List[Arr]        # nv × [6, N]  ([ang, lin] about the world origin)


def fk_b(sys: System, q: Arr) -> KinB:
    tc = topo(sys)
    N = q.shape[1]
    zero3 = q.new_zeros((3, N))
    init_q = sys.host("init_q")
    body_pos, body_quat = sys.host("body_pos"), sys.host("body_quat")
    jnt_axis, jnt_pos = sys.host("jnt_axis"), sys.host("jnt_pos")

    xpos: List[Arr] = [zero3]
    xquat: List[Arr] = [torch.cat([q.new_ones((1, N)), q.new_zeros((3, N))])]
    S: List[Optional[Arr]] = [None] * sys.nv

    for b in range(1, sys.nbody):
        p = sys.body_parentid[b]
        pos = xpos[p] + qrot(xquat[p], constv(body_pos[b], q))
        quat = qmul(xquat[p], constv(body_quat[b], q))
        for j in tc.body_joints[b]:
            jt = sys.jnt_type[j]
            qadr, dadr = sys.jnt_qposadr[j], sys.jnt_dofadr[j]
            if jt == FREE:
                pos = q[qadr:qadr + 3]
                quat = q[qadr + 3:qadr + 7]
                quat = quat / torch.sqrt(fold(quat * quat))
                c0, c1, c2 = quat_to_cols(quat)
                for k in range(3):
                    e = constv([1.0 if i == k else 0.0 for i in range(3)], q)
                    S[dadr + k] = torch.cat([zero3, e.expand(3, N)])
                for k, w in enumerate((c0, c1, c2)):
                    S[dadr + 3 + k] = torch.cat([w, cross(pos, w)])
            elif jt == HINGE:
                theta = q[qadr] - float(init_q[qadr])
                axis_w = qrot(quat, constv(jnt_axis[j], q))
                anchor_w = pos + qrot(quat, constv(jnt_pos[j], q))
                quat = qmul(quat, axis_angle_quat(jnt_axis[j], theta))
                pos = anchor_w - qrot(quat, constv(jnt_pos[j], q))
                S[dadr] = torch.cat([axis_w, cross(anchor_w, axis_w)])
            elif jt == SLIDE:
                axis_w = qrot(quat, constv(jnt_axis[j], q))
                pos = pos + axis_w * (q[qadr] - float(init_q[qadr]))
                S[dadr] = torch.cat([zero3, axis_w])
            else:
                raise NotImplementedError(f"joint type {jt}")
        xpos.append(pos)
        xquat.append(quat)
    return KinB(xpos, xquat, S)


# ---------------------------------------------------------------------------
# smooth dynamics: CRBA mass matrix + RNEA bias
# ---------------------------------------------------------------------------

def spatial_inertia_all(sys: System, kin: KinB) -> List:
    """6×6 world spatial inertias of all bodies as nested lists of [N] rows,
    built body-stacked; I_all[0] = None (world body).

    I = [[I_rot + m(c·c δ − c cᵀ), m c×], [m c×ᵀ, m·1]] about the origin.
    """
    ref = kin.xpos[1]
    nb1 = sys.nbody - 1
    m_np = sys.host("body_mass")[1:]
    m = _array(m_np, ref)[:, None]
    ipos = _array(sys.host("body_ipos")[1:], ref)[:, :, None]
    iquat = _array(sys.host("body_iquat")[1:], ref)[:, :, None]
    diag = _array(sys.host("body_inertia")[1:], ref)
    dcol = [diag[:, k:k + 1] for k in range(3)]

    xpos = torch.stack(kin.xpos[1:])        # [nb1, 3, N]
    xquat = torch.stack(kin.xquat[1:])      # [nb1, 4, N]
    com = xpos + qrot_c(xquat, ipos.expand(-1, -1, xpos.shape[2]))
    iq = qmul_c(xquat, iquat)
    cols = quat_to_cols_c(iq)
    Irot = [[dcol[0] * cols[0][:, a] * cols[0][:, bb]
             + dcol[1] * cols[1][:, a] * cols[1][:, bb]
             + dcol[2] * cols[2][:, a] * cols[2][:, bb]
             for bb in range(3)] for a in range(3)]
    cx, cy, cz = com[:, 0], com[:, 1], com[:, 2]
    c2sum = cx * cx + cy * cy + cz * cz
    comv = (cx, cy, cz)
    I = [[None] * 6 for _ in range(6)]
    for a in range(3):
        for bb in range(3):
            if a == bb:
                extra = m * (c2sum - comv[a] * comv[bb])
            else:
                extra = m * (-(comv[a] * comv[bb]))
            I[a][bb] = Irot[a][bb] + extra
    zero = torch.zeros_like(cx)
    cxm = [[zero, -m * cz, m * cy],
           [m * cz, zero, -m * cx],
           [-m * cy, m * cx, zero]]
    mfull = m + zero
    for a in range(3):
        for bb in range(3):
            I[a][3 + bb] = cxm[a][bb]
            I[3 + a][bb] = cxm[bb][a]
            I[3 + a][3 + bb] = mfull if a == bb else zero
    out: List = [None]
    for bi in range(nb1):
        out.append([[I[a][cc][bi] for cc in range(6)] for a in range(6)])
    return out


def _matvec6(Imat, v: Arr) -> Arr:
    return torch.stack([
        Imat[a][0] * v[0] + Imat[a][1] * v[1] + Imat[a][2] * v[2]
        + Imat[a][3] * v[3] + Imat[a][4] * v[4] + Imat[a][5] * v[5]
        for a in range(6)])


def _crm(v: Arr, m: Arr) -> Arr:
    return torch.cat([cross(v[:3], m[:3]),
                      cross(v[:3], m[3:]) + cross(v[3:], m[:3])])


def _crf(v: Arr, f: Arr) -> Arr:
    return torch.cat([cross(v[:3], f[:3]) + cross(v[3:], f[3:]),
                      cross(v[:3], f[3:])])


def smooth_b(sys: System, kin: KinB, qd: Arr):
    """Returns (M_low dict[(i,j)→[N]], bias [nv×[N]], v_b list)."""
    tc = topo(sys)
    N = qd.shape[1]
    I_b = spatial_inertia_all(sys, kin)

    # composite (subtree) inertias by reverse tree accumulation
    Ic = [None] * sys.nbody
    for b in range(sys.nbody - 1, 0, -1):
        out = [row[:] for row in I_b[b]]
        for c in tc.children[b]:
            for a in range(6):
                for cc in range(6):
                    out[a][cc] = out[a][cc] + Ic[c][a][cc]
        Ic[b] = out

    W = [kin.S[i] * qd[i] for i in range(sys.nv)]
    v_b = [qd.new_zeros((6, N))]
    for b in range(1, sys.nbody):
        v = v_b[sys.body_parentid[b]]
        for i in tc.own_dofs[b]:
            v = v + W[i]
        v_b.append(v)

    F = [_matvec6(Ic[sys.dof_bodyid[i]], kin.S[i]) for i in range(sys.nv)]
    arm = sys.host("dof_armature")
    M_low: Dict[Tuple[int, int], Arr] = {}
    for (i, j) in tc.dof_pairs:
        M_low[(i, j)] = fold(F[i] * kin.S[j])
    for i in range(sys.nv):
        M_low[(i, i)] = M_low[(i, i)] + float(arm[i])

    # bias: a_b = −g + Σ Ṡ_i q̇_i with Ṡ_i = v_partial_i ×m S_i
    Sdot_qd = []
    for i in range(sys.nv):
        b = sys.dof_bodyid[i]
        vp = v_b[sys.body_parentid[b]]
        for j in tc.prevdof[i]:
            if sys.dof_bodyid[j] == b:
                vp = vp + W[j]
        Sdot_qd.append(_crm(vp, W[i]))

    g = sys.host("gravity")
    a_b = [constv([0.0, 0.0, 0.0, -g[0], -g[1], -g[2]], qd).expand(6, N)]
    for b in range(1, sys.nbody):
        a = a_b[sys.body_parentid[b]]
        for i in tc.own_dofs[b]:
            a = a + Sdot_qd[i]
        a_b.append(a)

    f_b = [None] * sys.nbody
    for b in range(1, sys.nbody):
        f_b[b] = _matvec6(I_b[b], a_b[b]) + _crf(v_b[b],
                                                 _matvec6(I_b[b], v_b[b]))
    f_sub = [None] * sys.nbody
    for b in range(sys.nbody - 1, 0, -1):
        fs = f_b[b]
        for c in tc.children[b]:
            fs = fs + f_sub[c]
        f_sub[b] = fs

    bias = [fold(kin.S[i] * f_sub[sys.dof_bodyid[i]]) for i in range(sys.nv)]
    return M_low, bias, v_b


# ---------------------------------------------------------------------------
# tree-sparse LᵀDL factor and solve
# ---------------------------------------------------------------------------

class LDL(NamedTuple):
    L: Dict[Tuple[int, int], Arr]   # strictly-lower entries (i, j<i)
    Dg: List[Arr]
    dof_parent: Tuple[int, ...]
    nv: int


def ldl_factor(M_low: Dict[Tuple[int, int], Arr], sys: System,
               extra_diag: Optional[List] = None) -> LDL:
    """Featherstone tree-sparse LᵀDL factorization (RBDA §6.5): leaf-most
    dofs first, zero fill."""
    nv = sys.nv
    parent = topo(sys).dof_parent
    H: Dict[Tuple[int, int], Arr] = dict(M_low)
    if extra_diag is not None:
        for i in range(nv):
            if extra_diag[i] is not None:
                H[(i, i)] = H[(i, i)] + extra_diag[i]
    for k in range(nv - 1, -1, -1):
        i = parent[k]
        inv_d = 1.0 / H[(k, k)]
        while i >= 0:
            a = H[(k, i)] * inv_d
            j = i
            while j >= 0:
                H[(i, j)] = H[(i, j)] - a * H[(k, j)]
                j = parent[j]
            H[(k, i)] = a
            i = parent[i]
    L = {key: v for key, v in H.items() if key[0] != key[1]}
    return LDL(L, [H[(i, i)] for i in range(nv)], parent, nv)


def ldl_solve(f: LDL, rhs: List[Optional[Arr]]) -> List[Optional[Arr]]:
    """Solve (LᵀDL) x = rhs along the dof tree; None entries are
    structural zeros."""
    x: List[Optional[Arr]] = list(rhs)
    for i in range(f.nv - 1, -1, -1):        # Lᵀ y = rhs (leaf → root)
        if x[i] is None:
            continue
        j = f.dof_parent[i]
        while j >= 0:
            t = f.L[(i, j)] * x[i]
            x[j] = -t if x[j] is None else x[j] - t
            j = f.dof_parent[j]
    for i in range(f.nv):
        if x[i] is not None:
            x[i] = x[i] / f.Dg[i]
    for i in range(f.nv):                    # L x = y (root → leaf)
        j = f.dof_parent[i]
        while j >= 0:
            if x[j] is not None:
                t = f.L[(i, j)] * x[j]
                x[i] = -t if x[i] is None else x[i] - t
            j = f.dof_parent[j]
    return x


# ---------------------------------------------------------------------------
# collision
# ---------------------------------------------------------------------------

class ContactB(NamedTuple):
    pos: Arr      # [3, N]
    normal: Arr   # [3, N]
    depth: Arr    # [N]
    mu: float
    body_a: int
    body_b: int


def _geom_world(sys: System, kin: KinB, g: int):
    ref = kin.xpos[1]
    N = ref.shape[1]
    b = sys.geom_bodyid[g]
    gp = constv(sys.host("geom_pos")[g], ref)
    gq = constv(sys.host("geom_quat")[g], ref)
    if b == 0:
        return gp.expand(3, N), gq.expand(4, N)
    return kin.xpos[b] + qrot(kin.xquat[b], gp), qmul(kin.xquat[b], gq)


def collide_b(sys: System, kin: KinB) -> List[ContactB]:
    out: List[ContactB] = []
    size = sys.host("geom_size")
    fric = sys.host("geom_friction")

    for kind, ga, gb in sys.contact_pairs:
        mu = float(max(fric[ga, 0], fric[gb, 0]))
        ba, bb = sys.geom_bodyid[ga], sys.geom_bodyid[gb]
        pa, qa = _geom_world(sys, kin, ga)
        pb, qb = _geom_world(sys, kin, gb)
        if kind == PAIR_PLANE_SPHERE:
            n = quat_to_cols(qa)[2]
            r = float(size[gb, 0])
            dist = dot3(n, pb - pa) - r
            pos = pb - n * (r + 0.5 * dist)
            out.append(ContactB(pos, n, -dist, mu, ba, bb))
        elif kind == PAIR_PLANE_CAPSULE:
            n = quat_to_cols(qa)[2]
            axis = quat_to_cols(qb)[2]
            r, hl = float(size[gb, 0]), float(size[gb, 1])
            for sgn in (1.0, -1.0):
                e = pb + axis * (hl * sgn)
                dist = dot3(n, e - pa) - r
                pos = e - n * (r + 0.5 * dist)
                out.append(ContactB(pos, n, -dist, mu, ba, bb))
        elif kind == PAIR_CAPSULE_CAPSULE:
            r1, hl1 = float(size[ga, 0]), float(size[ga, 1])
            r2, hl2 = float(size[gb, 0]), float(size[gb, 1])
            d1, d2 = quat_to_cols(qa)[2], quat_to_cols(qb)[2]
            rvec = pa - pb
            bq = dot3(d1, d2)
            c = dot3(d1, rvec)
            fq = dot3(d2, rvec)
            denom = 1.0 - bq * bq
            denom = torch.where(denom.abs() < f32(1e-9),
                                _scalar(f32(1e-9), denom), denom)
            s = torch.clamp((bq * fq - c) / denom, -hl1, hl1)
            t = torch.clamp(bq * s + fq, -hl2, hl2)
            s = torch.clamp(bq * t - c, -hl1, hl1)
            c1p = pa + d1 * s
            c2p = pb + d2 * t
            delta = c2p - c1p
            dist = torch.sqrt(dot3(delta, delta))
            n = delta / torch.clamp_min(dist, f32(1e-9))
            depth = f32(r1 + r2) - dist
            pos = 0.5 * (c1p + n * r1 + c2p - n * r2)
            out.append(ContactB(pos, n, depth, mu, ba, bb))
        elif kind == PAIR_SPHERE_BOX:
            r = float(size[ga, 0])
            c0, c1, c2 = quat_to_cols(qb)
            d = pa - pb
            pl = torch.stack([dot3(c0, d), dot3(c1, d), dot3(c2, d)])
            bs_c = constv(size[gb], pl)
            clamped = torch.minimum(torch.maximum(pl, -bs_c), bs_c)
            delta = pl - clamped
            dist_out = torch.sqrt(dot3(delta, delta))
            outside = dist_out > f32(1e-9)
            n_out = -delta / torch.clamp_min(dist_out, f32(1e-9))
            depth_out = r - dist_out
            face_dist = bs_c - pl.abs()
            kmin = torch.argmin(face_dist, dim=0)
            onehot = torch.stack([(kmin == a).to(pl.dtype) for a in range(3)])
            sign = torch.sign(fold(pl * onehot))
            n_in = -sign * onehot
            depth_in = r + fold(face_dist * onehot)
            n_local = torch.where(outside, n_out, n_in)
            depth = torch.where(outside, depth_out, depth_in)
            surf = torch.where(outside, clamped, pl)

            def rot(v):
                return c0 * v[0] + c1 * v[1] + c2 * v[2]
            out.append(ContactB(pb + rot(surf), rot(n_local), depth, mu,
                                ba, bb))
        else:
            raise NotImplementedError(f"contact pair kind {kind}")
    return out


# ---------------------------------------------------------------------------
# constraint rows + projected Gauss–Seidel sweep
# ---------------------------------------------------------------------------

class Recorder:
    """Per sample, the row-substeps that acted while the sample was live:
    ``contacts`` and ``limits`` [N] (float, exact below 2²⁴), with the
    rows a substep has (``n_contacts``, ``n_limits``). ``live`` [N] (1.0
    or 0.0) is written in place by the rollout before each env step."""

    def __init__(self, live: Arr):
        self.live = live
        self.contacts = torch.zeros_like(live)
        self.limits = torch.zeros_like(live)
        self.n_contacts = self.n_limits = 0

    def add(self, acting: Arr, Cc: int) -> None:
        acting = acting.to(self.live.dtype)
        self.n_contacts, self.n_limits = Cc, acting.shape[0] - Cc
        if Cc:
            self.contacts += fold(acting[:Cc]) * self.live
        if acting.shape[0] > Cc:
            self.limits += fold(acting[Cc:]) * self.live


# Set by the reference rollout while it records (``Recorder``).
RECORD: Optional[Recorder] = None


def _jrows(S_st: Arr, w_st: Arr, sgn_b: Arr) -> Arr:
    """Signed Jacobian rows sgn[c,i]·Σ_k S[i,k]·w[c,k] → [C', nv, N]."""
    acc = None
    for kk in range(6):
        term = S_st[None, :, kk] * w_st[:, kk][:, None]
        acc = term if acc is None else acc + term
    return sgn_b[:, :, None] * acc


def _contact_dirs(S_st: Arr, pos_st: Arr, nrm_st: Arr, v_rel: Arr,
                  vn_c: Arr, mu_st: Arr, sgn_c: Arr, eps: float):
    """The contact points' Jacobian rows and force-direction rows (normal
    less μ times the unit slip): work that a row whose cap is 0 does not
    need (the kernel skips it, ``utils/work.py::ROW_WORK`` counts it)."""
    vt = v_rel - vn_c[:, None] * nrm_st
    t_dir = vt / torch.sqrt(dot3_c(vt, vt) + eps * eps)[:, None]
    d = nrm_st - mu_st[:, :, None] * t_dir
    return (_jrows(S_st, torch.cat([cross_c(pos_st, nrm_st), nrm_st], dim=1),
                   sgn_c),
            _jrows(S_st, torch.cat([cross_c(pos_st, d), d], dim=1), sgn_c))


def _row_solve(fac: LDL, J_all: Arr, cap_st: Arr, touched):
    """Every row's M⁻¹Jᵀ (one tree solve over the [C, N] stack), effective
    mass and force bound: work that a row whose cap is 0 does not need."""
    x = ldl_solve(fac, [J_all[:, i] if touched[i] else None
                        for i in range(fac.nv)])
    zc = torch.zeros_like(cap_st)
    MinvJ_st = torch.stack([zc if xi is None else xi for xi in x], dim=1)
    m_eff_st = 1.0 / (fold1(J_all * MinvJ_st) + f32(1e-8))
    return MinvJ_st, m_eff_st, m_eff_st * cap_st


def _precompute_rows_stacked(sys: System, kin: KinB, v_b: List[Arr],
                             cons: List[ContactB], fac: LDL, h: float,
                             qd: Arr, limits: List[Tuple[int, float, Arr]]):
    """Constraint-stacked rows: Jacobians, M⁻¹Jᵀ (one tree solve over the
    [C, N] stack), effective masses, velocity targets and force caps.
    Contacts first in ``sys.contact_pairs`` order, then the limit rows."""
    tc = topo(sys)
    k = float(sys.host("contact_stiffness"))
    bdamp = float(sys.host("contact_damping"))
    eps = float(sys.host("friction_vel_tol"))
    k_lim = float(sys.host("limit_stiffness"))
    # XLA folds β/h into one float32 constant (β · (1/h))
    beta_inv_h = f32(f32(BAUMGARTE_BETA) * recip32(h))
    Cc, Cl = len(cons), len(limits)
    C = Cc + Cl
    nv = sys.nv
    ref = qd

    sgn_np = np.zeros((C, nv))
    for ci, con in enumerate(cons):
        for i in tc.ancdof_body[con.body_b]:
            sgn_np[ci, i] += 1.0
        for i in tc.ancdof_body[con.body_a]:
            sgn_np[ci, i] -= 1.0
    for li, (dadr, s, _) in enumerate(limits):
        sgn_np[Cc + li, dadr] = s
    sgn_t = _array(sgn_np, ref)

    S_st = torch.stack(kin.S)                       # [nv, 6, N]

    J_parts, row_parts = [], []
    vn_parts, vbias_parts, cap_parts = [], [], []
    if Cc:
        pos_st = torch.stack([c.pos for c in cons])     # [Cc, 3, N]
        nrm_st = torch.stack([c.normal for c in cons])
        dep_st = torch.stack([c.depth for c in cons])   # [Cc, N]
        mu_st = constv([c.mu for c in cons], ref)       # [Cc, 1]
        vb_b = torch.stack([v_b[c.body_b] for c in cons])
        vb_a = torch.stack([v_b[c.body_a] for c in cons])

        def pvel(vb):
            return vb[:, 3:] + cross_c(vb[:, :3], pos_st)

        v_rel = pvel(vb_b) - pvel(vb_a)
        vn_c = dot3_c(v_rel, nrm_st)
        J_c, rows_c = _contact_dirs(S_st, pos_st, nrm_st, v_rel, vn_c, mu_st,
                                    sgn_t[:Cc], eps)
        J_parts.append(J_c)
        row_parts.append(rows_c)
        a_ref = torch.clamp_min(k * dep_st - bdamp * vn_c, 0.0)
        vn_parts.append(vn_c)
        vbias_parts.append(torch.clamp_max(
            torch.clamp_min(dep_st, 0.0) * beta_inv_h, V_PUSH_MAX))
        cap_parts.append(a_ref * (dep_st > 0.0).to(ref.dtype))
    if Cl:
        vio_st = torch.stack([vio for (_, _, vio) in limits])   # [Cl, N]
        sgn_l = sgn_t[Cc:, :, None].expand(Cl, nv, ref.shape[1])
        J_parts.append(sgn_l)
        row_parts.append(sgn_l)
        vn_parts.append(torch.stack([s * qd[dadr]
                                     for (dadr, s, _) in limits]))
        vbias_parts.append(torch.clamp_max(vio_st * beta_inv_h, V_PUSH_MAX))
        cap_parts.append(k_lim * vio_st * (vio_st > 0.0).to(ref.dtype))

    J_all = torch.cat(J_parts)                      # [C, nv, N]
    rows_st = torch.cat(row_parts)
    vn_st = torch.cat(vn_parts)                     # [C, N]
    vbias_st = torch.cat(vbias_parts)
    cap_st = torch.cat(cap_parts)
    if RECORD is not None:
        RECORD.add(cap_st != 0.0, Cc)

    MinvJ_st, m_eff_st, fnmax_st = _row_solve(fac, J_all, cap_st,
                                              sgn_np.any(axis=0))
    return MinvJ_st, rows_st, m_eff_st, vn_st, vbias_st, fnmax_st


def _gs_sweep(MinvJ_st: Arr, rows_st: Arr, m_eff_st: Arr, vn_st: Arr,
              vbias_st: Arr, fnmax_st: Arr, rhs_a: Arr, h: float) -> Arr:
    """``N_GS_PASSES`` projected Gauss–Seidel passes over every row: work
    that a row whose cap is 0 does not need (its force stays 0)."""
    inv_h = recip32(h)
    fns = [torch.zeros_like(rhs_a[0]) for _ in range(len(vn_st))]
    for _ in range(N_GS_PASSES):
        for c in range(len(vn_st)):
            jacc = fold(MinvJ_st[c] * rhs_a)
            vn_pred = vn_st[c] + h * jacc
            fn_new = torch.minimum(torch.clamp_min(
                fns[c] + m_eff_st[c] * (vbias_st[c] - vn_pred) * inv_h, 0.0),
                fnmax_st[c])
            rhs_a = rhs_a + rows_st[c] * (fn_new - fns[c])
            fns[c] = fn_new
    return rhs_a


def contact_qfrc_b(sys: System, kin: KinB, v_b: List[Arr],
                   cons: List[ContactB], fac: LDL, rhs: List[Arr], h: float,
                   qd: Arr, limits: List[Tuple[int, float, Arr]] = ()
                   ) -> List[Arr]:
    """Accumulate contact and joint-limit forces into ``rhs`` (= qfrc −
    bias − damping·qd) by projected Gauss–Seidel: each row's accumulated
    normal force moves toward the value that leaves its predicted normal
    velocity, under all forces in the running rhs, at the bounded Baumgarte
    pushout, projected to [0, m_eff·a_ref]."""
    if not cons and not limits:
        return list(rhs)
    rows = _precompute_rows_stacked(sys, kin, v_b, cons, fac, h, qd, limits)
    rhs_a = _gs_sweep(*rows, torch.stack(rhs), h)
    return [rhs_a[i] for i in range(sys.nv)]


# ---------------------------------------------------------------------------
# substep, integrator, validity checks
# ---------------------------------------------------------------------------

def substep_b(sys: System, q: Arr, qd: Arr, ctrl: Arr):
    """One physics substep. q [nq, N], qd [nv, N], ctrl [nu, N]."""
    N = q.shape[1]
    h = float(sys.host("dt"))
    damping = sys.host("dof_damping")

    kin = fk_b(sys, q)
    M_low, bias, v_b = smooth_b(sys, kin, qd)

    # joint-limit damping enters implicitly, through the factored matrix
    stiff = sys.host("jnt_stiffness")
    jrange = sys.host("jnt_range")
    meff_rest = sys.host("dof_limit_meff")
    b_lim = float(sys.host("limit_damping"))
    lim_below: Dict[int, Arr] = {}
    lim_above: Dict[int, Arr] = {}
    extra_diag: List = [None] * sys.nv
    for i in range(sys.nv):
        if damping[i] != 0.0:
            extra_diag[i] = q.new_full((N,), h * float(damping[i]))
    for j in range(sys.njnt):
        if sys.jnt_type[j] not in (SLIDE, HINGE) or not sys.jnt_limited[j]:
            continue
        qadr, dadr = sys.jnt_qposadr[j], sys.jnt_dofadr[j]
        lo, hi = float(jrange[j, 0]), float(jrange[j, 1])
        below = torch.clamp_min(lo - q[qadr], 0.0)
        above = torch.clamp_min(q[qadr] - hi, 0.0)
        lim_below[dadr], lim_above[dadr] = below, above
        active = ((below > 0) | (above > 0)).to(q.dtype)
        d_lim = (h * b_lim * float(meff_rest[dadr])) * active
        extra_diag[dadr] = d_lim if extra_diag[dadr] is None \
            else extra_diag[dadr] + d_lim

    fac = ldl_factor(M_low, sys, extra_diag=extra_diag)

    qfrc: List[Arr] = [q.new_zeros((N,)) for _ in range(sys.nv)]
    gear = sys.host("actuator_gear")
    crange = sys.host("actuator_ctrlrange")
    for a in range(sys.nu):
        dadr = sys.jnt_dofadr[sys.actuator_jntid[a]]
        u = torch.clamp(ctrl[a], float(crange[a, 0]), float(crange[a, 1]))
        qfrc[dadr] = qfrc[dadr] + float(gear[a]) * u

    qspring = sys.host("qpos_spring")
    limits = []
    for j in range(sys.njnt):
        if sys.jnt_type[j] not in (SLIDE, HINGE):
            continue
        qadr, dadr = sys.jnt_qposadr[j], sys.jnt_dofadr[j]
        if stiff[j] != 0.0:
            qfrc[dadr] = qfrc[dadr] - float(stiff[j]) * (
                q[qadr] - float(qspring[qadr]))
        if sys.jnt_limited[j]:
            limits.append((dadr, 1.0, lim_below[dadr]))
            limits.append((dadr, -1.0, lim_above[dadr]))

    rhs = [qfrc[i] - bias[i] - float(damping[i]) * qd[i]
           for i in range(sys.nv)]
    cons = collide_b(sys, kin) if sys.contact_pairs else []
    if cons or limits:
        rhs = contact_qfrc_b(sys, kin, v_b, cons, fac, rhs, h, qd, limits)
    qacc = ldl_solve(fac, rhs)

    qd_new = torch.stack([qd[i] + h * qacc[i] for i in range(sys.nv)])
    return integrate_pos_b(sys, q, qd_new, h), qd_new


def integrate_pos_b(sys: System, q: Arr, qd: Arr, h: float) -> Arr:
    rows: List[Optional[Arr]] = [None] * sys.nq
    for j in range(sys.njnt):
        qadr, dadr = sys.jnt_qposadr[j], sys.jnt_dofadr[j]
        if sys.jnt_type[j] == FREE:
            for k in range(3):
                rows[qadr + k] = q[qadr + k] + h * qd[dadr + k]
            quat = q[qadr + 3:qadr + 7]
            w = qd[dadr + 3:dadr + 6]
            wn = torch.sqrt(dot3(w, w))
            half = 0.5 * (wn * h)
            sinc = torch.where(wn < f32(1e-12), _scalar(f32(0.5 * h), q),
                               torch.sin(half) / torch.clamp_min(
                                   wn, f32(1e-12)))
            dq = torch.cat([torch.cos(half)[None], w * sinc])
            qn = qmul(quat, dq)
            qn = qn / torch.sqrt(fold(qn * qn))
            for k in range(4):
                rows[qadr + 3 + k] = qn[k]
        else:
            rows[qadr] = q[qadr] + h * qd[dadr]
    return torch.stack(rows)


def height_sensors(sys: System):
    """Static (qadr, offset) pairs such that ``q[qadr] + offset`` is the
    world z of a root body origin, plus the floor height — or None when the
    model has no floor plane or no such coordinate (see
    ``mbd_tpu/sim/batched.py::_height_sensors``)."""
    geom_types = list(sys.geom_type)
    if PLANE not in geom_types:
        return None
    gpos = sys.host("geom_pos")
    floor_z = max(float(gpos[g, 2]) for g in range(sys.ngeom)
                  if geom_types[g] == PLANE and sys.geom_bodyid[g] == 0)
    body_pos, body_quat = sys.host("body_pos"), sys.host("body_quat")
    jnt_axis, init_q = sys.host("jnt_axis"), sys.host("init_q")

    def chain(b):
        out = []
        while b != 0:
            out.append(b)
            b = sys.body_parentid[b]
        return out

    sensors = []
    for j in range(sys.njnt):
        qadr = sys.jnt_qposadr[j]
        if sys.jnt_type[j] == FREE:
            sensors.append((qadr + 2, 0.0))
            continue
        if sys.jnt_type[j] != SLIDE:
            continue
        if abs(jnt_axis[j, 0]) > 1e-9 or abs(jnt_axis[j, 1]) > 1e-9 \
                or jnt_axis[j, 2] <= 0.0:
            continue
        bodies = chain(sys.jnt_bodyid[j])
        if any(abs(body_quat[b, 0] - 1.0) > 1e-9
               or np.abs(body_quat[b, 1:]).max() > 1e-9 for b in bodies):
            continue
        earlier = [jj for jj in range(sys.njnt) if jj != j and (
            (sys.jnt_bodyid[jj] in bodies[1:]) or
            (sys.jnt_bodyid[jj] == bodies[0] and jj < j))]
        if any(sys.jnt_type[jj] != SLIDE for jj in earlier):
            continue
        off = float(sum(body_pos[b, 2] for b in bodies)) \
            - float(init_q[qadr])
        if any(abs(jnt_axis[jj, 2]) > 1e-9 for jj in earlier):
            continue
        sensors.append((qadr, off))
    if not sensors:
        return None
    return sensors, floor_z


def env_step_b(sys: System, q: Arr, qd: Arr, ctrl: Arr, n_frames: int):
    """n_frames substeps, no validity checks (the env ``step`` path)."""
    for _ in range(n_frames):
        q, qd = substep_b(sys, q, qd, ctrl)
    return q, qd


def env_step_checked_b(sys: System, q: Arr, qd: Arr, ctrl: Arr,
                       n_frames: int, bad: Arr):
    """n_frames substeps with divergence tracking: returns (q, qd, bad')
    where bad' accumulates [N] flags for samples whose joint speeds passed
    QD_DIVERGED or whose root sank more than ROOT_SINK_TOL below the floor.
    Flagged samples are clamped per substep, not NaN'd."""
    hs = sys.cached("height_sensors", lambda: height_sensors(sys))
    for _ in range(n_frames):
        q, qd = substep_b(sys, q, qd, ctrl)
        speed = torch.amax(qd.abs(), dim=0)
        bad = torch.maximum(bad, (speed > QD_DIVERGED).to(q.dtype))
        if hs is not None:
            sensors, floor_z = hs
            zmin = f32(floor_z - ROOT_SINK_TOL)
            for qadr, off in sensors:
                bad = torch.maximum(
                    bad, (q[qadr] + f32(off) < zmin).to(q.dtype))
        qd = torch.clamp(qd, -QD_DIVERGED, QD_DIVERGED)
    return q, qd, bad


class LinkOutB(NamedTuple):
    """Batch-last link quantities consumed by env reward functions."""
    xpos: List[Arr]    # nbody × [3, N] (world body-frame origins, incl world)
    xquat: List[Arr]
    vel: List[Arr]     # nbody × [3, N] velocity of body origin
    ang: List[Arr]


def link_out_b(sys: System, q: Arr, qd: Arr) -> LinkOutB:
    tc = topo(sys)
    kin = fk_b(sys, q)
    W = [kin.S[i] * qd[i] for i in range(sys.nv)]
    vel, ang = [kin.xpos[0] * 0.0], [kin.xpos[0] * 0.0]
    for b in range(1, sys.nbody):
        v = None
        for i in tc.ancdof_body[b]:
            v = W[i] if v is None else v + W[i]
        if v is None:
            v = q.new_zeros((6, q.shape[1]))
        a = v[:3]
        vel.append(v[3:] + cross(a, kin.xpos[b]))
        ang.append(a)
    return LinkOutB(kin.xpos, kin.xquat, vel, ang)
