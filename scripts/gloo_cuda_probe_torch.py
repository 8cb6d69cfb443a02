"""Which collectives a gloo world of two ranks on one card carries on CUDA
tensors.

    python scripts/gloo_cuda_probe_torch.py

NCCL refuses two ranks on one device, so the only world of several ranks
one card can hold is gloo's.  The port's sharded step moves its
parameters through ``DTensor.redistribute``, which calls the functional
collectives (``torch.distributed._functional_collectives``); this script
asks, each case in a fresh two-rank world (a case may kill its ranks),
whether gloo carries on that card:

- ``c10d_default``, ``c10d_subgroup``: ``dist.all_gather_into_tensor`` of
  a CUDA tensor over the world and over a ``DeviceMesh``'s ``model``
  group;
- ``funcol_default_cpu``: the functional ``all_gather_tensor`` of a CPU
  tensor (the path of the CPU tests' gloo worlds);
- ``funcol_default_cuda``, ``funcol_subgroup_cuda``: the same of a CUDA
  tensor, over the world and the ``model`` group;
- ``dtensor_redistribute_cuda``: a CUDA DTensor placed ``Shard(1)`` over
  ``model`` redistributed to ``Replicate`` (what ``parallel.to_compute``
  does to every split parameter).

Each case prints its ranks' exit codes and their last error line; the
last line is a JSON object {case: "ok" or the failure}.  Exit 1 without
a CUDA device.
"""
import faulthandler
import json
import socket
import subprocess
import sys

import torch
import torch.distributed as dist

CASES = ("c10d_default", "c10d_subgroup", "funcol_default_cpu",
         "funcol_default_cuda", "funcol_subgroup_cuda",
         "dtensor_redistribute_cuda")
TIMEOUT_S = 120


def rank_main(case: str, rank: int, port: str) -> None:
    faulthandler.enable()
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2)
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    dm = DeviceMesh("cuda", torch.arange(2).reshape(1, 2),
                    mesh_dim_names=("data", "model"))
    sub = dm.get_group("model")
    dev = "cpu" if case.endswith("_cpu") else "cuda"
    x = torch.full((4, 8), float(rank + 1), device=dev)
    if case.startswith("c10d"):
        out = torch.empty(8, 8, device=dev)
        dist.all_gather_into_tensor(
            out, x, group=sub if case == "c10d_subgroup" else None)
    elif case.startswith("funcol"):
        out = funcol.all_gather_tensor(
            x, 0, group=sub if "subgroup" in case else dist.group.WORLD)
    else:
        w = distribute_tensor(torch.ones(8, 8, device=dev), dm,
                              [Replicate(), Shard(1)], src_data_rank=None)
        out = w.redistribute(dm, [Replicate(), Replicate()]).to_local()
    print(f"{case} rank {rank}: ok, sum {out.sum().item()}", flush=True)
    dist.destroy_process_group()


def run_case(case: str) -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, __file__, case, str(r),
                               str(port)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0])
        except subprocess.TimeoutExpired:
            p.kill()
            outs.append(p.communicate()[0] + "\n(timed out)")
    rcs = [p.returncode for p in procs]
    errors = [next((line for line in reversed(o.splitlines())
                    if "rror" in line or "timed out" in line), "")
              for o in outs]
    print(f"{case}: exit codes {rcs}; {errors}", flush=True)
    if rcs == [0, 0]:
        return "ok"
    where = next((line.strip() for o in outs for line in o.splitlines()
                  if "_functional_collectives.py" in line), "")
    return f"exit codes {rcs}: {errors[0] or errors[1]} {where}".strip()


def main() -> int:
    if len(sys.argv) > 1:
        rank_main(sys.argv[1], int(sys.argv[2]), sys.argv[3])
        return 0
    if not torch.cuda.is_available():
        print("gloo_cuda_probe_torch: no CUDA device", file=sys.stderr)
        return 1
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    print(json.dumps({case: run_case(case) for case in CASES}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
