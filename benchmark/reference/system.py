"""The model description the reference's engine reads: a frozen copy of
the port's ``System`` (``mbd_tpu_torch/sim/system.py`` at commit f68a38a)
with its snapshot loader, without the MuJoCo compiler. The snapshots,
``mbd_tpu_torch/assets/<model>.npz``, are raw inputs that the program
and the reference both read.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Tuple

import numpy as np
import torch


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


def system_from_numpy(fields: Dict[str, Any], device) -> System:
    """Build a System from field values given as numpy arrays, tuples or
    scalars (e.g. the JAX ``System``'s fields, or a saved snapshot):
    numeric fields are rounded to float32 once, here, exactly as the JAX
    loader does."""
    device = torch.device(device)
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


def load_npz(path: str, device) -> System:
    """A System from a snapshot written by ``save_npz``."""
    with np.load(path, allow_pickle=False) as z:
        fields = {k: z[k] for k in z.files}
    return system_from_numpy(fields, device=device)
