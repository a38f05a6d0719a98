"""System: the model description the torch engine and the CUDA kernel read.

Port of ``mbd_tpu/sim/system.py``. MuJoCo's C library compiles the MJCF at
load time only; at run time the model is this dataclass. Static topology
(tree, joint kinds, addresses, contact pairs) is held as tuples, every
numeric parameter as a float32 tensor on ``device``.

The engine bakes numeric constants into its arithmetic as Python floats
(``System.host``), read from the float32 values — never from MuJoCo's
float64 ones — so the torch engine rounds exactly where the JAX engine does.

``save_npz`` / ``load_npz`` carry a compiled model to a machine without
MuJoCo: the envs load the snapshots under ``mbd_tpu_torch/assets/``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..device import DEFAULT, resolve

# Joint types (MuJoCo mjtJoint values)
FREE, BALL, SLIDE, HINGE = 0, 1, 2, 3
# Geom types (MuJoCo mjtGeom values)
PLANE, SPHERE, CAPSULE, ELLIPSOID, CYLINDER, BOX = 0, 2, 3, 4, 5, 6

# Contact pair kinds handled by the engine
PAIR_PLANE_SPHERE = 0
PAIR_PLANE_CAPSULE = 1
PAIR_CAPSULE_CAPSULE = 2
PAIR_SPHERE_BOX = 3

STATIC_FIELDS = (
    "nq", "nv", "nu", "nbody", "njnt", "ngeom", "body_parentid", "jnt_type",
    "jnt_bodyid", "jnt_qposadr", "jnt_dofadr", "jnt_limited", "dof_bodyid",
    "geom_type", "geom_bodyid", "actuator_jntid", "link_names",
    "contact_pairs")

NUMERIC_FIELDS = (
    "dt", "gravity", "body_pos", "body_quat", "body_ipos", "body_iquat",
    "body_mass", "body_inertia", "jnt_axis", "jnt_pos", "jnt_range",
    "jnt_stiffness", "qpos_spring", "dof_armature", "dof_damping",
    "dof_limit_meff", "geom_pos", "geom_quat", "geom_size", "geom_friction",
    "geom_rgba", "actuator_gear", "actuator_ctrlrange", "init_q",
    "contact_stiffness", "contact_damping", "friction_vel_tol",
    "limit_stiffness", "limit_damping", "mask_ancdof_body", "mask_dof_dof",
    "mask_dof_prevdof", "mask_subtree")


@dataclass(frozen=True, eq=False)
class System:
    # --- static structure ---
    nq: int
    nv: int
    nu: int
    nbody: int                      # includes world (id 0)
    njnt: int
    ngeom: int
    body_parentid: Tuple[int, ...]
    jnt_type: Tuple[int, ...]
    jnt_bodyid: Tuple[int, ...]
    jnt_qposadr: Tuple[int, ...]
    jnt_dofadr: Tuple[int, ...]
    jnt_limited: Tuple[bool, ...]
    dof_bodyid: Tuple[int, ...]
    geom_type: Tuple[int, ...]
    geom_bodyid: Tuple[int, ...]
    actuator_jntid: Tuple[int, ...]
    link_names: Tuple[str, ...]
    contact_pairs: Tuple[Tuple[int, int, int], ...]

    # --- numeric model parameters (float32 tensors on `device`) ---
    dt: torch.Tensor
    gravity: torch.Tensor
    body_pos: torch.Tensor
    body_quat: torch.Tensor
    body_ipos: torch.Tensor
    body_iquat: torch.Tensor
    body_mass: torch.Tensor
    body_inertia: torch.Tensor
    jnt_axis: torch.Tensor
    jnt_pos: torch.Tensor
    jnt_range: torch.Tensor
    jnt_stiffness: torch.Tensor
    qpos_spring: torch.Tensor
    dof_armature: torch.Tensor
    dof_damping: torch.Tensor
    dof_limit_meff: torch.Tensor
    geom_pos: torch.Tensor
    geom_quat: torch.Tensor
    geom_size: torch.Tensor
    geom_friction: torch.Tensor
    geom_rgba: torch.Tensor
    actuator_gear: torch.Tensor
    actuator_ctrlrange: torch.Tensor
    init_q: torch.Tensor
    contact_stiffness: torch.Tensor
    contact_damping: torch.Tensor
    friction_vel_tol: torch.Tensor
    limit_stiffness: torch.Tensor
    limit_damping: torch.Tensor
    mask_ancdof_body: torch.Tensor
    mask_dof_dof: torch.Tensor
    mask_dof_prevdof: torch.Tensor
    mask_subtree: torch.Tensor

    # derived host-side data (numpy copies, topology unrolls), per instance
    _cache: Dict[str, Any] = field(default_factory=dict, repr=False)

    @property
    def device(self) -> torch.device:
        return self.dt.device

    def host(self, name: str) -> np.ndarray:
        """Host float32 copy of a numeric field (cached: the engine reads
        its constants from here without a device round trip)."""
        key = "np:" + name
        if key not in self._cache:
            self._cache[key] = getattr(self, name).detach().cpu().numpy()
        return self._cache[key]

    def cached(self, key: str, build):
        """Per-System memo for derived static data."""
        if key not in self._cache:
            self._cache[key] = build()
        return self._cache[key]

    def replace(self, **changes) -> "System":
        return dataclasses.replace(self, _cache={}, **changes)


def _ancestors(parentid, b):
    # MuJoCo's world body (id 0) lists itself as its own parent
    out = []
    while True:
        out.append(b)
        if b == 0:
            return out
        b = parentid[b]


# Solver gains in acceleration units (see mbd_tpu/sim/system.py)
_DEFAULT_GAINS = dict(contact_stiffness=2500.0, contact_damping=100.0,
                      friction_vel_tol=0.05, limit_stiffness=2500.0,
                      limit_damping=100.0)


def load_mjcf(path: str, device=DEFAULT) -> System:
    """Compile an MJCF file with MuJoCo and freeze it into a System."""
    import mujoco

    return from_mjmodel(mujoco.MjModel.from_xml_path(path), device=device)


def from_mjmodel(m: Any, device=DEFAULT) -> System:
    import mujoco

    device = resolve(device)         # fail before the tables are built

    if np.any(m.jnt_type == mujoco.mjtJoint.mjJNT_BALL):
        raise NotImplementedError("ball joints not supported")

    parentid = tuple(int(p) for p in m.body_parentid)
    nbody, nv = m.nbody, m.nv

    anc_sets = [set(_ancestors(parentid, b)) for b in range(nbody)]
    mask_subtree = np.zeros((nbody, nbody), np.float32)
    for d in range(nbody):
        for b in anc_sets[d]:
            mask_subtree[b, d] = 1.0
    dof_bodyid = tuple(int(b) for b in m.dof_bodyid)
    mask_ancdof_body = np.zeros((nbody, nv), np.float32)
    for b in range(nbody):
        for i in range(nv):
            if dof_bodyid[i] in anc_sets[b]:
                mask_ancdof_body[b, i] = 1.0
    dof_jntid = [0] * nv
    for j in range(m.njnt):
        dadr = int(m.jnt_dofadr[j])
        ndof = {0: 6, 1: 3, 2: 1, 3: 1}[int(m.jnt_type[j])]
        for k in range(ndof):
            dof_jntid[dadr + k] = j

    mask_dof_dof = np.zeros((nv, nv), np.float32)
    mask_dof_prevdof = np.zeros((nv, nv), np.float32)
    for i in range(nv):
        bi = dof_bodyid[i]
        ji = dof_jntid[i]
        free_rot = (int(m.jnt_type[ji]) == 0 and
                    i >= int(m.jnt_dofadr[ji]) + 3)
        for j in range(nv):
            bj = dof_bodyid[j]
            if bj in anc_sets[bi]:
                mask_dof_dof[i, j] = 1.0
                if bj != bi:
                    mask_dof_prevdof[i, j] = 1.0
                elif free_rot:
                    # free-joint rotations see the joint's translations only
                    # (MuJoCo mj_comVel convention)
                    if j < int(m.jnt_dofadr[ji]) + 3:
                        mask_dof_prevdof[i, j] = 1.0
                elif j < i:
                    mask_dof_prevdof[i, j] = 1.0

    # contact pairs under contype/conaffinity, excluding same-body and
    # parent-child pairs (MuJoCo's default exclusions; not for the world)
    pairs = []
    gt = m.geom_type
    kinds = {
        (PLANE, SPHERE): (PAIR_PLANE_SPHERE, False),
        (SPHERE, PLANE): (PAIR_PLANE_SPHERE, True),
        (PLANE, CAPSULE): (PAIR_PLANE_CAPSULE, False),
        (CAPSULE, PLANE): (PAIR_PLANE_CAPSULE, True),
        (CAPSULE, CAPSULE): (PAIR_CAPSULE_CAPSULE, False),
        (SPHERE, BOX): (PAIR_SPHERE_BOX, False),
        (BOX, SPHERE): (PAIR_SPHERE_BOX, True),
    }
    for a in range(m.ngeom):
        for b in range(a + 1, m.ngeom):
            ba, bb = int(m.geom_bodyid[a]), int(m.geom_bodyid[b])
            if ba == bb:
                continue
            if (parentid[bb] == ba and ba != 0) or \
               (parentid[ba] == bb and bb != 0):
                continue
            ok = (m.geom_contype[a] & m.geom_conaffinity[b]) or \
                 (m.geom_contype[b] & m.geom_conaffinity[a])
            if not ok:
                continue
            ta, tb = int(gt[a]), int(gt[b])
            if (ta, tb) not in kinds:
                raise NotImplementedError(
                    f"unsupported contact pair geom types ({ta},{tb})")
            kind, swap = kinds[(ta, tb)]
            pairs.append((kind, b, a) if swap else (kind, a, b))

    act_jntid = []
    for u in range(m.nu):
        if m.actuator_trntype[u] != mujoco.mjtTrn.mjTRN_JOINT:
            raise NotImplementedError("only joint-transmission actuators")
        act_jntid.append(int(m.actuator_trnid[u, 0]))
    ctrlrange = np.array(m.actuator_ctrlrange, np.float64).copy()
    unlimited = ~m.actuator_ctrllimited.astype(bool)
    ctrlrange[unlimited] = [-1e9, 1e9]

    link_names = tuple(
        mujoco.mj_id2name(m, mujoco.mjtObj.mjOBJ_BODY, b) or f"body{b}"
        for b in range(1, nbody))

    # rest-pose effective inertia per dof (joint-limit damping)
    d0 = mujoco.MjData(m)
    d0.qpos[:] = m.qpos0
    mujoco.mj_forward(m, d0)
    M0 = np.zeros((nv, nv))
    mujoco.mj_fullM(m, d0, M0)
    Minv0_diag = np.diag(np.linalg.inv(M0))
    dof_limit_meff = 1.0 / np.maximum(Minv0_diag, 1e-12)

    gains = dict(_DEFAULT_GAINS)
    fields = dict(
        nq=int(m.nq), nv=int(nv), nu=int(m.nu), nbody=int(nbody),
        njnt=int(m.njnt), ngeom=int(m.ngeom),
        body_parentid=parentid,
        jnt_type=tuple(int(t) for t in m.jnt_type),
        jnt_bodyid=tuple(int(b) for b in m.jnt_bodyid),
        jnt_qposadr=tuple(int(x) for x in m.jnt_qposadr),
        jnt_dofadr=tuple(int(x) for x in m.jnt_dofadr),
        jnt_limited=tuple(bool(x) for x in m.jnt_limited),
        dof_bodyid=dof_bodyid,
        geom_type=tuple(int(t) for t in m.geom_type),
        geom_bodyid=tuple(int(b) for b in m.geom_bodyid),
        actuator_jntid=tuple(act_jntid),
        link_names=link_names,
        contact_pairs=tuple(pairs),
        dt=m.opt.timestep, gravity=m.opt.gravity,
        body_pos=m.body_pos, body_quat=m.body_quat,
        body_ipos=m.body_ipos, body_iquat=m.body_iquat,
        body_mass=m.body_mass, body_inertia=m.body_inertia,
        jnt_axis=m.jnt_axis, jnt_pos=m.jnt_pos, jnt_range=m.jnt_range,
        jnt_stiffness=m.jnt_stiffness, qpos_spring=m.qpos_spring,
        dof_armature=m.dof_armature, dof_damping=m.dof_damping,
        dof_limit_meff=dof_limit_meff,
        geom_pos=m.geom_pos, geom_quat=m.geom_quat, geom_size=m.geom_size,
        geom_friction=m.geom_friction, geom_rgba=m.geom_rgba,
        actuator_gear=m.actuator_gear[:, 0], actuator_ctrlrange=ctrlrange,
        init_q=m.qpos0,
        mask_ancdof_body=mask_ancdof_body, mask_dof_dof=mask_dof_dof,
        mask_dof_prevdof=mask_dof_prevdof, mask_subtree=mask_subtree,
        **gains)
    return system_from_numpy(fields, device=device)


def system_from_numpy(fields: Dict[str, Any], device=DEFAULT) -> System:
    """Build a System from field values given as numpy arrays, tuples or
    scalars (e.g. the JAX ``System``'s fields, or a saved snapshot):
    numeric fields are rounded to float32 once, here, exactly as the JAX
    loader does."""
    device = resolve(device)
    kw: Dict[str, Any] = {}
    for k in STATIC_FIELDS:
        v = fields[k]
        if k == "link_names":
            kw[k] = tuple(str(x) for x in v)
        elif k == "contact_pairs":
            kw[k] = tuple(tuple(int(x) for x in p) for p in v)
        elif k == "jnt_limited":
            kw[k] = tuple(bool(x) for x in v)
        elif np.ndim(v) == 0 and not isinstance(v, (tuple, list)):
            kw[k] = int(v)
        else:
            kw[k] = tuple(int(x) for x in v)
    for k in NUMERIC_FIELDS:
        arr = np.array(np.asarray(fields[k]), dtype=np.float32)
        kw[k] = torch.from_numpy(arr).to(device)
    return System(**kw)


def save_npz(sys: System, path: str) -> None:
    """Write a System's fields to ``path`` (read back by ``load_npz``
    without MuJoCo)."""
    out = {k: sys.host(k) for k in NUMERIC_FIELDS}
    for k in STATIC_FIELDS:
        v = getattr(sys, k)
        if k == "contact_pairs":
            v = np.asarray(v, np.int64).reshape(-1, 3)
        elif k == "link_names":
            v = np.asarray(v, dtype=str)
        out[k] = np.asarray(v)
    np.savez(path, **out)


def load_npz(path: str, device=DEFAULT) -> System:
    """A System from a snapshot written by ``save_npz``."""
    with np.load(path, allow_pickle=False) as z:
        fields = {k: z[k] for k in z.files}
    return system_from_numpy(fields, device=device)
