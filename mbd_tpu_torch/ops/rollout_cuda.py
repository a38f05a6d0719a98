"""Whole-rollout CUDA kernel for Hopper: wrapper, model header, build.

Replaces the TPU kernel ``mbd_tpu/ops/rollout_pallas.py::make_rollout_kernel``
(reached through ``rollout_rewards_pallas``): per-step rewards and the
validity flag, from a shared or per-sample initial state, and on request
the position trace (``need_qs``) and the demo log-density (``demo``).
The kernel body is written once by hand (``csrc/rollout.cu``); each model
arrives as a small generated header (``model_header``) of sizes and
tables, so the kernel's loops over the topology unroll at compile time.
A group of G lanes serves one sample, G fixed per env in the header
(``env.kernel_group``). The library is built with ``nvcc`` at first use,
into ``build/rollout/<hash>/`` beside the package, cached by a hash of
the sources and the header, and bound with ``ctypes``.

``rollout_rewards_cuda`` keeps the signature and layout of
``rollout_rewards_pallas``: ``Y0s [N, H, nu]`` in, ``(rews [N, H],
bad [N][, qs [H, nq, N]][, logpd [N]])`` out; with ``retire`` the
kernel's retiring form, which ends each sample at its first flag and
refills its lanes from a launch-wide queue (the planner's reverse step).
``env_step_cuda`` is the port's fifth mode, state out, with no Pallas
counterpart: one env step from a per-sample (q, qd), (q', qd', reward,
bad), for RL training (``rl/batched_env.py``). A CPU tensor takes the
plain version (``rollout/fused.py::rollout_outputs`` and
``env_step_outputs``, the torch engine); a CUDA tensor launches the
kernel or raises.

Coverage: free, slide and hinge joints; plane–sphere, plane–capsule,
capsule–capsule and sphere–box pairs: every model the port serves
(hopper, walker2d, halfcheetah, cartpole, ant, humanoidrun,
humanoidstandup, humanoidtrack, pushT). A model with a ball joint is
refused with ``NotImplementedError``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from types import SimpleNamespace
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from ..rollout.fused import env_step_outputs, rollout_outputs
from ..sim import batched as BT
from ..sim.contact import BAUMGARTE_BETA, N_GS_PASSES, V_PUSH_MAX
from ..sim.system import (FREE, HINGE, PAIR_CAPSULE_CAPSULE,
                          PAIR_PLANE_CAPSULE, PAIR_PLANE_SPHERE,
                          PAIR_SPHERE_BOX, SLIDE, System)
from ..utils import profiling

CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "build", "rollout")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "--fmad=false",
              "-Xptxas", "-v")

# Launches of the CUDA kernel, counted where the kernel is launched; of
# those, the launches with demo=True, those with need_qs=True and those of
# the state-out mode (env_step_cuda).
LAUNCHES = 0
DEMO_LAUNCHES = 0
QS_LAUNCHES = 0
STATE_LAUNCHES = 0
# The sample-steps (N·H per call) rolled out, by the kernel or, on a CPU
# tensor, by its plain version; of those, the ones with demo=True. A
# plan's work is Σ utils/work.py's WORK · sample-steps.
SAMPLE_STEPS = 0
DEMO_SAMPLE_STEPS = 0
# The kernel indexes its arrays with 32-bit ints: the largest, qs's
# (t·nq + i)·N + n, must stay below 2³¹.
MAX_INDEX = 2 ** 31 - 1

REWARD_IDS = {"progress": 0, "velocity": 1, "swingup": 2, "run": 3,
              "standup": 4, "healthy": 5, "track": 6, "push": 7}
# contact points per pair kind, in sim/batched.py::collide_b's order
PAIR_ROWS = {PAIR_PLANE_SPHERE: 1, PAIR_PLANE_CAPSULE: 2,
             PAIR_CAPSULE_CAPSULE: 1, PAIR_SPHERE_BOX: 1}
# The tables the kernel reads at a run-time index (``t_<name>`` in
# csrc/rollout.cu), copied into shared memory per block.
RUNTIME_TABLES = frozenset((
    "body_parent", "body_ipos", "body_iquat", "body_mass", "body_inertia",
    "gravity", "dof_body", "armature", "damping", "h_damping", "dof_limj",
    "n_prev", "prev", "n_anc", "anc", "n_dact", "dact", "n_dspring",
    "dspring", "act_lo", "act_hi", "act_gear", "spring_qadr", "spring_k",
    "spring_q0", "limj_qadr", "limj_dadr", "limj_lo", "limj_hi",
    "limj_dlim", "mp_i", "mp_j", "fac_start", "fac_i", "fac_j",
    "pair_kind", "pair_start", "pair_body_a", "pair_body_b", "pair_pos_a",
    "pair_quat_a", "pair_pos_b", "pair_quat_b", "pair_r1", "pair_hl1",
    "pair_r2", "pair_hl2", "pair_r12", "pair_box_b", "pair_mu", "con_sgn",
    "hinge_qadr", "hinge_q0", "hinge_axis"))
# And, where forward kinematics runs a tree level across the lanes
# (``fk_stages``), the tables of a lane's body and its joints: a hinge's
# by its index among the hinges, a slide's among the slides.
FK_TABLES = frozenset((
    "fk_body", "body_pos", "body_quat", "body_jnt", "jnt_qadr", "jnt_dadr",
    "jnt_hinge", "hinge_pos", "jnt_slide", "slide_axis", "slide_q0"))
# The least bodies that the split must take off lane 0's chain: walker2d
# and halfcheetah (3, a pair of legs on each of three levels) ran no faster
# split, pushT (1) slower (PERF.md §6).
FK_MIN_SAVED = 4


def check_supported(sys: System) -> None:
    """Raise NotImplementedError for what the kernel does not cover."""
    kinds = set(sys.jnt_type)
    if not kinds <= {FREE, SLIDE, HINGE}:
        raise NotImplementedError(
            "the CUDA rollout kernel covers free, slide and hinge joints "
            f"only (joint types {sorted(kinds)}); ball joints are not on "
            "ROADMAP.md's Queue 2")


# ---------------------------------------------------------------------------
# generated model header
# ---------------------------------------------------------------------------

def _lit(v, kind: str) -> str:
    if kind == "int":
        return str(int(v))
    return "%.9ef" % float(np.float32(v))


def _table(name: str, kind: str, values, stride: int = 0) -> str:
    """A constexpr accessor over a flat table, ``name(i)`` or, with a
    stride, ``name(i, k)``; the index folds once the caller's loop is
    unrolled."""
    vals = list(values) or [0]            # no zero-length arrays
    body = ", ".join(_lit(v, kind) for v in vals)
    if stride:
        args, idx = "int i, int k", f"{stride} * i + k"
    else:
        args, idx = "int i", "i"
    return (f"__host__ __device__ constexpr {kind} {name}({args}) {{\n"
            f"  constexpr {kind} v[] = {{{body}}};\n"
            f"  return v[{idx}];\n}}\n")


def _int_type(values) -> str:
    """The narrowest signed type that holds every value."""
    lo, hi = min(values, default=0), max(values, default=0)
    if -128 <= lo and hi <= 127:
        return "signed char"
    if -32768 <= lo and hi <= 32767:
        return "short"
    return "int"


def _runtime_tables(specs, runtime) -> list:
    """The tables named in ``runtime``, which a lane reads at a run-time
    index (a body, dof, row or task of its own), as one struct ``Tables``:
    its initial value ``kTablesInit`` in device memory, which each block
    copies into its shared ``tables`` at launch, and an accessor
    ``t_<name>`` over the copy."""
    fields, inits, accessors = [], [], []
    for spec in specs:
        name, kind, values = spec[:3]
        if name not in runtime:
            continue
        stride = spec[3] if len(spec) > 3 else 0
        vals = list(values) or [0]
        ctype = _int_type(vals) if kind == "int" else "float"
        fields.append(f"  {ctype} {name}[{len(vals)}];")
        inits.append("{" + ", ".join(_lit(v, kind) for v in vals) + "}")
        if stride:
            args, idx = "int i, int k", f"{stride} * i + k"
        else:
            args, idx = "int i", "i"
        accessors.append(f"__device__ __forceinline__ {kind} t_{name}("
                         f"{args}) {{ return tables.{name}[{idx}]; }}")
    return (["struct alignas(16) Tables {"] + fields + ["};",
            "__device__ const Tables kTablesInit = {" + ", ".join(inits)
            + "};", "__shared__ Tables tables;"] + accessors)


def check_demo(env, H: int) -> None:
    """Raise ValueError unless ``env`` has a demo of at least H frames (the
    one check of the wrapper and the planner)."""
    xref = getattr(env, "xref", None)
    if xref is None:
        raise ValueError(f"the demo needs an env with a demo (xref); "
                         f"{type(env).__name__} has none")
    if H > xref.shape[1]:
        raise ValueError(f"the horizon H = {H} is longer than the demo's "
                         f"{xref.shape[1]} frames")


def _lists(name: str, lists) -> list:
    """Ragged index lists as a count table ``n_<name>(i)`` and a table
    ``<name>(i, m)`` padded to the longest list: the kernel's topology loops
    (``static_for`` in csrc/rollout.cu) visit these entries only, so the
    code nvcc compiles grows with the tree's edges, not with its size
    squared."""
    width = max([len(lst) for lst in lists] + [1])
    flat = [x for lst in lists for x in list(lst) + [0] * (width - len(lst))]
    return [(f"n_{name}", "int", [len(lst) for lst in lists]),
            (name, "int", flat, width)]


def fk_stages(sys: System) -> list:
    """Forward kinematics' stages where the body tree branches: per depth
    below the world, shallower first, its bodies split by the list of their
    joints' kinds, each stage ``(depth, bodies)`` with its bodies in body
    order. The kernel runs a stage a lane a body, with a barrier after the
    last stage of a depth (``fk_levels`` in csrc/rollout.cu). Empty where
    the stages take fewer than ``FK_MIN_SAVED`` bodies off the chain of
    bodies that lane 0 would run (hopper and cartpole, chains, none;
    walker2d and halfcheetah 3; pushT 1), whose forward kinematics stays on
    lane 0. The rule reads the tree's shape only."""
    def build():
        body_joints = BT.topo(sys).body_joints
        depth = [0] * sys.nbody
        levels: Dict[int, Dict[tuple, list]] = {}
        for b in range(1, sys.nbody):
            depth[b] = depth[sys.body_parentid[b]] + 1
            kinds = tuple(sys.jnt_type[j] for j in body_joints[b])
            levels.setdefault(depth[b], {}).setdefault(kinds, []).append(b)
        stages = [(d, bodies) for d in sorted(levels)
                  for bodies in levels[d].values()]
        return stages if sys.nbody - 1 - len(stages) >= FK_MIN_SAVED else []
    return sys.cached("fk_stages", build)


def fk_serial_stages(sys: System) -> int:
    """The serial steps of a substep's forward kinematics in the kernel:
    its stages where the split engages (none wider than a group: 5 bodies
    at most, G 8 at least), else every body, one after another on lane
    0."""
    return len(fk_stages(sys)) or sys.nbody - 1


def model_tables(sys: System, n_frames: int, reward,
                 track: Sequence[int] = ()) -> Dict:
    """Sizes, scalar constants and tables of the generated header, each
    rounded where the torch engine rounds it (sim/batched.py). ``track``
    lists the demo's tracked body ids (none for a model without one)."""
    check_supported(sys)
    tc = BT.topo(sys)
    nv, nj = sys.nv, sys.njnt
    f32, recip32 = BT.f32, BT.recip32
    h = float(sys.host("dt"))
    damping = sys.host("dof_damping")
    jrange = sys.host("jnt_range")
    stiff = sys.host("jnt_stiffness")
    qspring = sys.host("qpos_spring")
    meff_rest = sys.host("dof_limit_meff")
    b_lim = float(sys.host("limit_damping"))
    gpos, gquat = sys.host("geom_pos"), sys.host("geom_quat")
    size, fric = sys.host("geom_size"), sys.host("geom_friction")
    crange, gear = sys.host("actuator_ctrlrange"), sys.host("actuator_gear")
    P = sys.host("mask_dof_prevdof")

    # strict dof-tree ancestors, from the parent up (descending index)
    anc = [[] for _ in range(nv)]
    for i in range(nv):
        j = tc.dof_parent[i]
        while j >= 0:
            anc[i].append(j)
            j = tc.dof_parent[j]
    pairs = set(tc.dof_pairs)
    # each list in the order the torch engine visits it (ascending index
    # unless said otherwise)
    lists = dict(
        anc=anc,
        mpair=[[j for j in range(i + 1) if (i, j) in pairs]
               for i in range(nv)],
        body_jnt=tc.body_joints,
        own=tc.own_dofs,
        prev=[[j for j in range(nv) if P[i, j] > 0 and
               sys.dof_bodyid[i] == sys.dof_bodyid[j]] for i in range(nv)],
        child=[[c for c in tc.children[b] if c > b]
               for b in range(sys.nbody)])
    # limits and springs act on slide and hinge joints only (substep_b)
    scalar = [j for j in range(nj) if sys.jnt_type[j] in (SLIDE, HINGE)]
    limj = [j for j in scalar if sys.jnt_limited[j]]
    springs = [j for j in scalar if stiff[j] != 0.0]
    act_dadr = [sys.jnt_dofadr[j] for j in sys.actuator_jntid]
    # per dof, its actuators and springs in the order substep_b adds them
    lists.update(
        dact=[[a for a, d in enumerate(act_dadr) if d == i]
              for i in range(nv)],
        dspring=[[s for s, j in enumerate(springs)
                  if sys.jnt_dofadr[j] == i] for i in range(nv)])
    # the bodies of each stage of forward kinematics (none along a chain)
    stages = fk_stages(sys)
    lists.update(fk_body=[bodies for _, bodies in stages])
    depths = [d for d, _ in stages]
    list_tables = [spec for key, lst in lists.items()
                   for spec in _lists(key, lst)]
    hinges = [j for j in range(nj) if sys.jnt_type[j] == HINGE]
    slides = [j for j in range(nj) if sys.jnt_type[j] == SLIDE]
    init_q, jaxis = sys.host("init_q"), sys.host("jnt_axis")
    jpos = sys.host("jnt_pos")
    dof_limj = [-1] * nv
    for l, j in enumerate(limj):
        dof_limj[sys.jnt_dofadr[j]] = l
    # the mass-matrix entries, one lane each: (i, j) for j in mpair(i)
    mp = [(i, j) for i in range(nv) for j in lists["mpair"][i]]
    # the LᵀDL factor's updates of column k (descending k, a barrier
    # between columns): for i in anc(k), F[i][i] and F[i][j], j in anc(i)
    fac, fac_start = [], []
    for k in range(nv):
        fac_start.append(len(fac))
        for i in anc[k]:
            fac += [(i, i)] + [(i, j) for j in anc[i]]
    fac_start.append(len(fac))

    pair_rows, con_sgn = [], []
    for kind, ga, gb in sys.contact_pairs:
        pair_rows.append(len(con_sgn))
        sgn = np.zeros(nv)
        for i in tc.ancdof_body[sys.geom_bodyid[gb]]:
            sgn[i] += 1.0
        for i in tc.ancdof_body[sys.geom_bodyid[ga]]:
            sgn[i] -= 1.0
        con_sgn += [sgn] * PAIR_ROWS[kind]
    ncon = len(con_sgn)
    nc = ncon + 2 * len(limj)

    hs = sys.cached("height_sensors", lambda: BT.height_sensors(sys))
    sensors, floor_z = hs if hs is not None else ([], 0.0)

    name, params = reward
    eps = float(sys.host("friction_vel_tol"))
    sizes = dict(NQ=sys.nq, NV=nv, NU=sys.nu, NB=sys.nbody, NJ=nj,
                 NFRAMES=n_frames, NPAIR=len(sys.contact_pairs), NCON=ncon,
                 NLIMJ=len(limj), NC=nc,
                 NSPRING=len(springs), NSENSOR=len(sensors),
                 NTRACK=len(track), NFK=len(stages))
    scalars = dict(
        kH=h, kInvH=recip32(h),
        kBetaInvH=f32(f32(BAUMGARTE_BETA) * recip32(h)),
        kVPushMax=V_PUSH_MAX, kEps2=eps * eps,
        kContactK=float(sys.host("contact_stiffness")),
        kContactB=float(sys.host("contact_damping")),
        kLimitK=float(sys.host("limit_stiffness")),
        kQdDiverged=BT.QD_DIVERGED, kZmin=floor_z - BT.ROOT_SINK_TOL,
        kZTarget=params.get("z_target", 0.0),
        kVTarget=params.get("v_target", 0.0),
        kInvDt=params.get("inv_dt", 0.0),
        kDt=params.get("dt", 1.0),
        kZLow=params.get("z_low", 0.0), kZHigh=params.get("z_high", 0.0),
        kCtrlCost=params.get("ctrl_cost", 0.0))
    ints = dict(kGsPasses=N_GS_PASSES, kFree=FREE, kHinge=HINGE,
                kPlaneSphere=PAIR_PLANE_SPHERE,
                kPlaneCapsule=PAIR_PLANE_CAPSULE,
                kCapsuleCapsule=PAIR_CAPSULE_CAPSULE,
                kSphereBox=PAIR_SPHERE_BOX,
                kNMP=len(mp), kNFac=len(fac),
                kNH=len(hinges),
                kReward=REWARD_IDS[name],
                **{f"kReward{k.capitalize()}": v
                   for k, v in REWARD_IDS.items()})
    cp = sys.contact_pairs
    tables = [
        ("body_parent", "int", sys.body_parentid),
        ("body_pos", "float", sys.host("body_pos").ravel(), 3),
        ("body_quat", "float", sys.host("body_quat").ravel(), 4),
        ("body_ipos", "float", sys.host("body_ipos").ravel(), 3),
        ("body_iquat", "float", sys.host("body_iquat").ravel(), 4),
        ("body_mass", "float", sys.host("body_mass")),
        ("body_inertia", "float", sys.host("body_inertia").ravel(), 3),
        ("gravity", "float", sys.host("gravity")),
        ("jnt_type", "int", sys.jnt_type),
        ("jnt_qadr", "int", sys.jnt_qposadr),
        ("jnt_dadr", "int", sys.jnt_dofadr),
        ("jnt_axis", "float", sys.host("jnt_axis").ravel(), 3),
        ("jnt_pos", "float", sys.host("jnt_pos").ravel(), 3),
        ("init_q", "float", sys.host("init_q")),
        ("dof_body", "int", sys.dof_bodyid),
        ("armature", "float", sys.host("dof_armature")),
        ("damping", "float", damping),
        ("h_damping", "float", [h * float(d) for d in damping]),
        ("act_dadr", "int", act_dadr),
        ("act_lo", "float", crange[:, 0]),
        ("act_hi", "float", crange[:, 1]),
        ("act_gear", "float", gear),
        ("spring_dadr", "int", [sys.jnt_dofadr[j] for j in springs]),
        ("spring_qadr", "int", [sys.jnt_qposadr[j] for j in springs]),
        ("spring_k", "float", [stiff[j] for j in springs]),
        ("spring_q0", "float", [qspring[sys.jnt_qposadr[j]]
                                for j in springs]),
        ("limj_dadr", "int", [sys.jnt_dofadr[j] for j in limj]),
        ("limj_qadr", "int", [sys.jnt_qposadr[j] for j in limj]),
        ("limj_lo", "float", [jrange[j, 0] for j in limj]),
        ("limj_hi", "float", [jrange[j, 1] for j in limj]),
        ("limj_dlim", "float", [h * b_lim * float(meff_rest[
            sys.jnt_dofadr[j]]) for j in limj]),
        ("pair_kind", "int", [k for k, _, _ in cp]),
        ("pair_start", "int", pair_rows),
        ("pair_body_a", "int", [sys.geom_bodyid[a] for _, a, _ in cp]),
        ("pair_body_b", "int", [sys.geom_bodyid[b] for _, _, b in cp]),
        ("pair_pos_a", "float", [x for _, a, _ in cp for x in gpos[a]], 3),
        ("pair_quat_a", "float", [x for _, a, _ in cp for x in gquat[a]],
         4),
        ("pair_pos_b", "float", [x for _, _, b in cp for x in gpos[b]], 3),
        ("pair_quat_b", "float", [x for _, _, b in cp for x in gquat[b]],
         4),
        ("pair_r1", "float", [size[a, 0] for _, a, _ in cp]),
        ("pair_hl1", "float", [size[a, 1] for _, a, _ in cp]),
        ("pair_r2", "float", [size[b, 0] for _, _, b in cp]),
        ("pair_hl2", "float", [size[b, 1] for _, _, b in cp]),
        ("pair_r12", "float", [float(size[a, 0]) + float(size[b, 0])
                               for _, a, b in cp]),
        # geom b's box half-sizes (read by sphere–box pairs only)
        ("pair_box_b", "float", [x for _, _, b in cp for x in size[b]], 3),
        ("pair_mu", "float", [max(fric[a, 0], fric[b, 0])
                              for _, a, b in cp]),
        ("con_sgn", "float", [x for s in con_sgn for x in s], nv),
        ("sensor_qadr", "int", [qa for qa, _ in sensors]),
        ("sensor_off", "float", [off for _, off in sensors]),
        ("track_body", "int", track),
        ("dof_limj", "int", dof_limj),
        # the hinges, whose half-angle rotations a lane each precomputes
        ("hinge_qadr", "int", [sys.jnt_qposadr[j] for j in hinges]),
        ("hinge_q0", "float", [init_q[sys.jnt_qposadr[j]] for j in hinges]),
        ("hinge_axis", "float", [x for j in hinges for x in jaxis[j]], 3),
        ("jnt_hinge", "int", [hinges.index(j) if j in hinges else -1
                              for j in range(nj)]),
        ("hinge_pos", "float", [x for j in hinges for x in jpos[j]], 3),
        ("jnt_slide", "int", [slides.index(j) if j in slides else -1
                              for j in range(nj)]),
        ("slide_axis", "float", [x for j in slides for x in jaxis[j]], 3),
        ("slide_q0", "float", [init_q[sys.jnt_qposadr[j]] for j in slides]),
        ("mp_i", "int", [i for i, _ in mp]),
        ("mp_j", "int", [j for _, j in mp]),
        ("fac_start", "int", fac_start),
        ("fac_i", "int", [i for i, _ in fac]),
        ("fac_j", "int", [j for _, j in fac]),
        # 1 after the last stage of forward kinematics at a depth, whose
        # barrier the next depth's stages wait at (the last stage's is the
        # substep's own)
        ("fk_sync", "int", [int(d < e) for d, e in
                            zip(depths, depths[1:] + depths[-1:])]),
    ] + list_tables
    runtime = RUNTIME_TABLES | (FK_TABLES if stages else frozenset())
    return dict(sizes=sizes, scalars=scalars, ints=ints, tables=tables,
                runtime=runtime)


def model_header(env, G: int = 0) -> str:
    """The generated ``model.h`` for ``env``'s model, substeps, reward and
    tracked bodies, with G lanes per sample (default ``env.kernel_group``;
    the CPU test and ``compare_rollout.py`` build others); the demo's
    frames are not in it."""
    t = model_tables(env.sys, env.n_frames, env.kernel_reward,
                     getattr(env, "track_body_ids", ()))
    out = ["// Generated by mbd_tpu_torch/ops/rollout_cuda.py::model_header.",
           "#pragma once", ""]
    out += [f"#define {k} {v}" for k, v in t["sizes"].items()]
    out += ["", f"constexpr int kG = {G or env.kernel_group};"]
    out += [f"constexpr int {k} = {v};" for k, v in t["ints"].items()]
    out += [f"constexpr float {k} = {_lit(v, 'float')};"
            for k, v in t["scalars"].items()]
    out += [""]
    out += [_table(*spec) for spec in t["tables"]]
    out += _runtime_tables(t["tables"], t["runtime"])
    return "\n".join(out)


# ---------------------------------------------------------------------------
# build and bind
# ---------------------------------------------------------------------------

LAYOUT = ("G", "threads_per_block", "shared_bytes", "regs", "local_bytes",
          "blocks_per_sm", "warps_per_sm", "sms_used")


class Built:
    """A loaded kernel library and what the build reported."""

    def __init__(self, lib: ctypes.CDLL, path: str, ptxas: str,
                 seconds: float):
        self.lib = lib
        self.path = path
        self.ptxas = ptxas          # nvcc -Xptxas -v report
        self.seconds = seconds      # 0.0 when loaded from the cache
        lib.mbd_rollout.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
        lib.mbd_rollout.restype = ctypes.c_int
        lib.mbd_rollout_attrs.argtypes = [ctypes.c_int, ctypes.c_int,
                                          ctypes.POINTER(ctypes.c_int)]
        lib.mbd_rollout_attrs.restype = ctypes.c_int

    def attrs(self, N: int = 2048, retire: bool = False) -> Dict[str, int]:
        """The layout of a launch at N samples, of the whole form or with
        ``retire`` the retiring one: G, threads and dynamic shared bytes
        per block, registers and local bytes per thread, resident blocks
        and warps per SM, and the SMs the grid occupies."""
        out = (ctypes.c_int * len(LAYOUT))()
        err = self.lib.mbd_rollout_attrs(N, int(retire), out)
        if err != 0:
            raise RuntimeError(f"mbd_rollout_attrs failed: error {err}")
        return dict(zip(LAYOUT, out))

    def run(self, env, state0, Y0s: torch.Tensor, need_qs: bool = False,
            demo: bool = False, state_out: bool = False,
            first: bool = False, retire: bool = False, rows: bool = False
            ) -> Tuple[torch.Tensor, ...]:
        """One launch on CUDA tensors whose shapes ``rollout_rewards_cuda``
        has checked; its outputs in that function's layout, with
        ``state_out`` the velocities after the last step [nv, N], with
        ``first`` each sample's first flagged env step [N] (int32, −1 where
        none), with ``rows`` each sample's contact-row substeps that acted
        in the env steps that started with it unflagged [N] (int32) and,
        of the retiring form (``retire``), its queue [2] last (int32: the
        samples ended, N once the launch is done, and the env steps it
        ran)."""
        check_retire(retire, need_qs, demo, state_out)
        N, H, _ = Y0s.shape
        q0 = state0.pipeline_state.q.contiguous()
        qd0 = state0.pipeline_state.qd.contiguous()
        U = Y0s.permute(1, 2, 0).contiguous()                 # [H, nu, N]
        f32 = dict(dtype=torch.float32, device=Y0s.device)
        rews = torch.empty((H, N), **f32)
        bad = torch.empty((N,), **f32)
        qs = torch.empty((H, env.sys.nq, N), **f32) if need_qs else None
        logpd = torch.empty((N,), **f32) if demo else None
        qd_out = torch.empty((env.sys.nv, N), **f32) if state_out else None
        i32 = dict(dtype=torch.int32, device=Y0s.device)
        first_out = torch.empty((N,), **i32) if first else None
        rows_out = torch.empty((N,), **i32) if rows else None
        queue = torch.empty((2,), **i32) if retire else None
        xref = env.xref_frames if demo else None       # [H_demo, 5, 3]

        def ptr(t):
            return None if t is None else t.data_ptr()

        with torch.cuda.device(Y0s.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = self.lib.mbd_rollout(
                q0.data_ptr(), qd0.data_ptr(), int(q0.dim() == 2),
                U.data_ptr(), rews.data_ptr(), bad.data_ptr(), ptr(qs),
                ptr(xref), ptr(logpd), ptr(qd_out), ptr(first_out),
                ptr(rows_out), ptr(queue), N, H, stream)
        if err != 0:
            raise RuntimeError(
                f"CUDA rollout kernel launch failed: error {err}")
        out = (rews.t(), bad)
        if need_qs:
            out += (qs,)
        if demo:
            out += (logpd,)
        if state_out:
            out += (qd_out,)
        if first:
            out += (first_out,)
        if rows:
            out += (rows_out,)
        if retire:
            out += (queue,)
        return out


_LIBS: Dict[str, Built] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA rollout kernel is "
                           "built from source at first use")
    return path


def compile_library(source: str, header: str) -> Built:
    """Build (or load from the cache) the library of a kernel source text
    and its ``model.h``."""
    digest = hashlib.sha256(
        (source + header + " ".join(NVCC_FLAGS)).encode()).hexdigest()[:16]
    if digest in _LIBS:
        return _LIBS[digest]
    out_dir = os.path.join(BUILD_DIR, digest)
    so_path = os.path.join(out_dir, "librollout.so")
    log_path = os.path.join(out_dir, "ptxas.txt")
    seconds = 0.0
    if not os.path.exists(so_path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = tempfile.mkdtemp(dir=BUILD_DIR)
        try:
            with open(os.path.join(tmp, "model.h"), "w") as f:
                f.write(header)
            with open(os.path.join(tmp, "rollout.cu"), "w") as f:
                f.write(source)
            t0 = time.perf_counter()
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-I", tmp, "-o",
                 os.path.join(tmp, "librollout.so"),
                 os.path.join(tmp, "rollout.cu")],
                capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
            with open(os.path.join(tmp, "ptxas.txt"), "w") as f:
                f.write(proc.stderr)
            try:
                os.replace(tmp, out_dir)
            except OSError:        # another process built it first
                pass
        finally:
            if os.path.isdir(tmp):
                shutil.rmtree(tmp)
    with open(log_path) as f:
        ptxas = f.read()
    built = Built(ctypes.CDLL(so_path), so_path, ptxas, seconds)
    _LIBS[digest] = built
    return built


def build(env) -> Built:
    """Build (or load from the cache) the kernel library for ``env``."""
    with open(os.path.join(CSRC, "rollout.cu")) as f:
        return compile_library(f.read(), model_header(env))


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------

def rollout_rewards_cuda(env, state0, Y0s: torch.Tensor,
                         need_qs: bool = False, demo: bool = False,
                         retire: bool = False) -> Tuple[torch.Tensor, ...]:
    """Y0s [N, H, nu] → (rews [N, H], bad [N][, qs [H, nq, N]][,
    logpd [N]]), rolled out from ``state0.pipeline_state`` (q [nq] shared
    or [nq, N] per sample); qs with ``need_qs``, the demo log-density
    with ``demo``.

    ``retire`` launches the retiring form: each sample ends at the end of
    its first flagged env step and its group takes the next sample from a
    launch-wide queue. The flags and every reward up to and including
    each sample's first flagged step are the whole form's bit for bit;
    the rewards after it are a quiet NaN (bits 0x7fffffff, the card's own),
    which no planner reads. The trace, the demo and the state-out mode
    read past the flag and refuse it. The plain version rolls out whole
    and writes the same NaN.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise. While the recorder counts (``utils/profiling.py``: under a
    ``torch.profiler``, or ``recording(counters=True)``), the rollout
    counts its N·H sample-steps (``rollout.sample_steps``) and, from each
    sample's first flagged env step (the kernel's ``first`` buffer, or the
    plain version's), the env steps after it: Σ over the flagged samples
    of H − 1 − that step (``rollout.tail_sample_steps``), work no planner
    reads; the substeps of the env steps before it and of that step, those
    that start with the sample unflagged: Σ (that step + 1, or H) ×
    n_frames (``rollout.live_substeps``); and the contact rows that acted
    (force cap not 0) in those substeps, summed over the rows
    (``rollout.contact_row_substeps``: the kernel's ``rows`` buffer, or
    the plain engine's count), so that their ratio is the mean number of
    contact rows a live substep solves; and the live substeps times the
    serial steps of forward kinematics in the model's build
    (``rollout.fk_stage_substeps``, ``fk_serial_stages``: the tree's
    levels where it branches, its bodies along a chain), with no buffer of
    its own. A retiring rollout counts the sample-steps it did not run
    (``rollout.retired_sample_steps``): on the card N·H less the env steps
    the kernel counts as it runs them, in the plain version that tail
    again. Either form gives every count but the last the same value, and
    the launch is the same kernel whether counted or not."""
    global LAUNCHES, DEMO_LAUNCHES, QS_LAUNCHES, SAMPLE_STEPS, \
        DEMO_SAMPLE_STEPS
    sys = env.sys
    check_supported(sys)
    check_retire(retire, need_qs, demo)
    N, H, nu = Y0s.shape
    if demo:
        check_demo(env, H)
    first = profiling.counting()
    if not Y0s.is_cuda:
        SAMPLE_STEPS += N * H
        DEMO_SAMPLE_STEPS += N * H * int(demo)
        out = rollout_outputs(env, state0, Y0s, need_qs, demo, first, retire,
                              rows=first)
        if first and retire:
            profiling.count("rollout.retired_sample_steps", _tail(out[-2], H))
        return _counted(out, N, H, env) if first else out
    if nu != sys.nu:
        raise ValueError(f"Y0s has {nu} controls, the model {sys.nu}")
    if Y0s.dtype != torch.float32:
        raise TypeError(f"Y0s must be float32, not {Y0s.dtype}")
    if H * max(sys.nq, sys.nv, sys.nu) * N > MAX_INDEX:
        raise ValueError(f"N·H = {N}·{H} is too large for the kernel's "
                         "32-bit indices")
    q0, qd0 = state0.pipeline_state.q, state0.pipeline_state.qd
    per_sample = q0.dim() == 2
    if per_sample and (q0.shape != (sys.nq, N) or qd0.shape != (sys.nv, N)):
        raise ValueError(f"per-sample q0/qd0 must be [{sys.nq}, {N}] / "
                         f"[{sys.nv}, {N}]")
    if not per_sample and (q0.shape != (sys.nq,) or qd0.shape != (sys.nv,)):
        raise ValueError(f"q0/qd0 must be [{sys.nq}] / [{sys.nv}]")
    for t in (q0, qd0):
        if t.device != Y0s.device or t.dtype != torch.float32:
            raise ValueError("q0/qd0 must be float32 on the device of Y0s")
    if demo and env.xref_frames.device != Y0s.device:
        raise ValueError("the env's demo frames must be on the device of Y0s")
    out = library(env).run(env, state0, Y0s, need_qs, demo, first=first,
                           retire=retire, rows=first)
    LAUNCHES += 1
    DEMO_LAUNCHES += int(demo)
    QS_LAUNCHES += int(need_qs)
    SAMPLE_STEPS += N * H
    DEMO_SAMPLE_STEPS += N * H * int(demo)
    if retire:
        queue, out = out[-1], out[:-1]
        if first:
            profiling.count("rollout.retired_sample_steps", N * H - queue[1])
    return _counted(out, N, H, env) if first else out


def check_retire(retire: bool, need_qs: bool, demo: bool,
                 state_out: bool = False) -> None:
    """Raise ValueError where the retiring form is asked for with an output
    that is read past a sample's first flag."""
    if retire and (need_qs or demo or state_out):
        raise ValueError("the retiring form ends each sample at its first "
                         "flag: the trace (need_qs), the demo and the "
                         "state-out mode read past it")


def _tail(first: torch.Tensor, H: int) -> torch.Tensor:
    """Σ over the flagged samples of H − 1 − their first flagged env step
    (``first``, −1 where none), on the device."""
    return torch.where(first >= 0, (H - 1) - first, 0).sum()


def _counted(out: Tuple[torch.Tensor, ...], N: int, H: int, env
             ) -> Tuple[torch.Tensor, ...]:
    """Counts with the recorder, on the device, a rollout's sample-steps,
    its samples' env steps after their first flag and their live substeps
    (from the first flags, the second last of ``out``), those times the
    serial steps of ``env``'s forward kinematics, and the contact-row
    substeps that acted in those (the last); the outputs without those
    two."""
    first, rows = out[-2:]
    live = torch.where(first >= 0, first + 1, H).sum() * env.n_frames
    profiling.count("rollout.sample_steps", N * H)
    profiling.count("rollout.tail_sample_steps", _tail(first, H))
    profiling.count("rollout.live_substeps", live)
    profiling.count("rollout.fk_stage_substeps",
                    live * fk_serial_stages(env.sys))
    profiling.count("rollout.contact_row_substeps", rows.sum())
    return out[:-2]


def library(env) -> Built:
    """``env``'s library, its header generated and its source hashed once
    per model, not per launch."""
    return env.sys.cached(f"rollout/{env.n_frames}/{env.kernel_reward!r}/"
                          f"{env.kernel_group}", lambda: build(env))


def env_step_cuda(env, q: torch.Tensor, qd: torch.Tensor, u: torch.Tensor
                  ) -> Tuple[torch.Tensor, ...]:
    """One env step (n_frames checked substeps) of B samples, each from
    its own state: q [nq, B], qd [nv, B], u [nu, B] → (q' [nq, B],
    qd' [nv, B], reward [B], bad [B]), as ``env_step_checked_b`` and the
    env's ``reward_qs_b`` give them. The kernel's state-out mode: one
    launch at H = 1 with the trace, whose one step is q', and the
    velocities after it.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    global LAUNCHES, STATE_LAUNCHES
    sys = env.sys
    check_supported(sys)
    if not u.is_cuda:
        return env_step_outputs(env, q, qd, u)
    B = u.shape[1]
    if q.shape != (sys.nq, B) or qd.shape != (sys.nv, B) or \
            u.shape != (sys.nu, B):
        raise ValueError(f"q, qd, u must be [{sys.nq}, B], [{sys.nv}, B], "
                         f"[{sys.nu}, B]; got {tuple(q.shape)}, "
                         f"{tuple(qd.shape)}, {tuple(u.shape)}")
    for t in (q, qd, u):
        if t.device != u.device or t.dtype != torch.float32:
            raise ValueError("q, qd and u must be float32 on one device")
    state0 = SimpleNamespace(pipeline_state=SimpleNamespace(
        q=q.contiguous(), qd=qd.contiguous()))
    rews, bad, qs, qd1 = library(env).run(env, state0, u.t()[:, None, :],
                                         need_qs=True, state_out=True)
    LAUNCHES += 1
    STATE_LAUNCHES += 1
    return qs[0], qd1, rews[:, 0], bad
