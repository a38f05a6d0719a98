#!/usr/bin/env python3
"""Where one sample's substep spends its cycles in the rollout kernel, by
phase, on one CUDA card.

    python3 profile_kernel.py [--env humanoidrun] [--group G]

Builds a copy of ``mbd_tpu_torch/csrc/rollout.cu`` in which lane 0 of
sample 0 reads ``clock64()`` at every barrier of the substep and adds the
cycles since the last reading to that barrier's count, runs one rollout
at the env's planning shape (humanoidrun 8192 × 50, humanoidtrack 2048 ×
50 with the demo, hopper 2048 × 50, pushT 2048 × 40; other envs 2048 ×
50) from its reset (seed 0) with uniform random controls (seed 1), and
prints, per phase (named by the comment that opens it), the cycles per
substep and the share. The first barrier of a substep waits for lane 0's
final solve, integrator, checks and, at the end of an env step, reward.
The samples run side by side, so the counts are one sample's latency
under the load of the others, not device time; the copy is never
launched by the planner (``compare_rollout.py`` times the kernel).
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
SHAPES = {"humanoidrun": (8192, 50, False), "humanoidtrack": (2048, 50, True),
          "hopper": (2048, 50, False), "pushT": (2048, 40, False)}
TICKS = """
__device__ unsigned long long mbd_ticks[8192];
__device__ long long mbd_last;
#define MBD_TICK()                                                    \\
  do {                                                                \\
    if (blockIdx.x == 0 && threadIdx.x == 0) {                        \\
      const long long now = clock64();                                \\
      if (mbd_last) mbd_ticks[__LINE__] += now - mbd_last;            \\
      mbd_last = now;                                                 \\
    }                                                                 \\
  } while (0)
"""
READ = """
extern "C" int mbd_ticks_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, mbd_ticks, sizeof(mbd_ticks));
}
"""


def instrument(src: str) -> str:
    """The kernel source with a tick after every barrier of substep()."""
    src = src.replace("namespace {\n", "namespace {\n" + TICKS, 1)
    a = src.index("__device__ void substep(")
    b = src.index("#if NTRACK > 0", a)
    body = src[a:b].replace("g.sync();", "g.sync(); MBD_TICK();")
    # the ends of the two phases that close without a barrier
    for phase in ("  // ---- LᵀDL factor", "    // ---- projected Gauss"):
        if phase not in body:
            raise ValueError(f"no phase {phase.strip()!r} in substep()")
        body = body.replace(phase, "MBD_TICK();\n" + phase, 1)
    return src[:a] + body + src[b:] + READ


def phase_names(src: str):
    """Per line, the phase comment ("// ---- … ----") last opened above
    it."""
    names, cur = {}, ""
    for n, line in enumerate(src.splitlines(), 1):
        m = re.match(r"\s*// ---- (.*?)(----)?$", line)
        if m:
            cur = m.group(1).strip()
        if "__device__ void substep(" in line:
            cur = ("lane 0's final solve, integrator and checks, and at an "
                   "env step's end its reward")
        names[n] = cur
    return names


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--env", default="humanoidrun")
    ap.add_argument("--group", type=int, default=0,
                    help="G to build for (default the env's)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_kernel: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from mbd_tpu_torch import envs
    from mbd_tpu_torch.ops import rollout_cuda as rc

    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    env = envs.get_env(args.env, device="cuda")
    N, H, demo = SHAPES.get(args.env, (2048, 50, False))
    G = args.group or env.kernel_group
    with open(os.path.join(rc.CSRC, "rollout.cu")) as f:
        src = instrument(f.read())
    built = rc.compile_library(src, rc.model_header(env, G))
    built.lib.mbd_ticks_read.argtypes = [ctypes.c_void_p]

    state0 = env.reset(torch.Generator("cuda").manual_seed(0))
    Y0s = 2 * torch.rand((N, H, env.action_size), device="cuda",
                         generator=torch.Generator("cuda").manual_seed(1)) - 1
    built.run(env, state0, Y0s, demo=demo)
    torch.cuda.synchronize()
    ticks = (ctypes.c_ulonglong * 8192)()
    built.lib.mbd_ticks_read(ticks)
    names = phase_names(src)
    phases = {}
    for line in range(8192):
        if ticks[line]:
            name = names[line]
            phases[name] = phases.get(name, 0) + ticks[line]
    total = sum(phases.values())
    steps = H * env.n_frames
    print(f"{args.env} N={N} H={H} G={G} demo={demo} on {gpu}: sample 0 "
          f"took {total / steps:.0f} cycles per substep")
    for name, c in sorted(phases.items(), key=lambda kv: -kv[1]):
        print(f"  {100 * c / total:5.1f}%  {c / steps:9.0f} cycles  {name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
