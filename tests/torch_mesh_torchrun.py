"""A case of ``mbd_tpu_torch.parallel.multichip`` (by default
``humanoidrun``: the flagship plan, 8192 / 50 / 300, temp 0.1) started by
torchrun, in the form the mesh's docstring shows
(``mbd_tpu_torch/parallel/mesh.py``), one rank a card:

    torchrun --nproc_per_node=4 tests/torch_mesh_torchrun.py [--case NAME]

Each rank joins the NCCL group from torchrun's environment
(``init_process_group("nccl")``), takes its card from ``sample_mesh()``
and runs the case on its shard; a model's kernel is built through
``mesh.first``, by one nvcc on rank 0 while the others wait. Then the
ranks' results are held against each other (one all_reduce MAX and one
MIN of their bits), and rank 0 runs the case again alone on its card
without a mesh, which the sharded result must equal bit for bit (PPO:
within ``multichip.PPO_MESH_TOL``). Rank 0 prints one JSON line: per rank
its card, wall, launches and their samples, the cards they ran on and
its nvcc seconds (0 when it loaded rank 0's build). Every rank exits 1 on
any difference. Needs one card a rank; not collected by pytest.
"""

import argparse
import json
import os
import sys
import time

import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from mbd_tpu_torch import envs  # noqa: E402
from mbd_tpu_torch.ops import rollout_cuda as rc  # noqa: E402
from mbd_tpu_torch.parallel import multichip, sample_mesh  # noqa: E402


def flatten(result: dict, prefix: str = "") -> dict:
    """A result's tensors by dotted name (PPO's parameters are a dict in
    it)."""
    out = {}
    for k, v in result.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = torch.as_tensor(v)
    return out


def bits(result: dict) -> torch.Tensor:
    """Every tensor of a result, flattened into one int32 tensor of its
    bits (booleans as 0 and 1)."""
    flat = []
    for _, v in sorted(flatten(result).items()):
        v = v.contiguous()
        flat.append(v.view(torch.int32).reshape(-1) if v.element_size() == 4
                    and v.dtype.is_floating_point
                    else v.to(torch.int32).reshape(-1))
    return torch.cat(flat)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--case", default="humanoidrun", choices=multichip.CASES)
    name = ap.parse_args().case
    case = multichip.cases()[name]

    dist.init_process_group("nccl")
    mesh = sample_mesh()
    env = envs.get_env(case.model)        # this rank's card
    with multichip.launch_log() as log:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = case.run(env, mesh)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        samples = [n for _, n in log]
        launch_cards = sorted({c for c, _ in log})
    nvcc_s = rc.library(env).seconds

    b = bits(result).to(mesh.device)
    hi, lo = b.clone(), b.clone()
    dist.all_reduce(hi, op=dist.ReduceOp.MAX)
    dist.all_reduce(lo, op=dist.ReduceOp.MIN)
    ranks_equal = torch.equal(hi, lo)
    against_one = None
    if mesh.rank == 0:
        single = case.run(env, None)
        if case.kind == "ppo":
            against_one = all(torch.allclose(
                result["params"][k], v, rtol=multichip.PPO_MESH_TOL,
                atol=multichip.PPO_MESH_TOL)
                for k, v in single["params"].items())
        else:
            against_one = multichip.same_bits(result, single)
    ok = ranks_equal and launch_cards == [mesh.device.index] \
        and against_one is not False
    row = torch.tensor([[mesh.device.index, wall, len(samples),
                         min(samples), max(samples), nvcc_s,
                         float(ok)]], dtype=torch.float64,
                       device=mesh.device)
    table = mesh.gather(row, mesh.size, mesh.rank).cpu().tolist()
    ok_all = all(r[6] == 1.0 for r in table)
    if mesh.rank == 0:
        print(json.dumps(dict(
            case=name, ranks=mesh.size, ok=ok_all,
            ranks_equal=ranks_equal, bit_for_bit_with_one_card=against_one,
            per_rank=[dict(card=int(r[0]), wall_s=r[1], launches=int(r[2]),
                           samples=[int(r[3]), int(r[4])], nvcc_s=r[5],
                           ok=r[6] == 1.0) for r in table],
            final_reward=result.get("final_reward", torch.zeros(0)).tolist(),
            device=torch.cuda.get_device_name(mesh.device))), flush=True)
    dist.destroy_process_group()
    return 0 if ok_all else 1


if __name__ == "__main__":
    sys.exit(main())
