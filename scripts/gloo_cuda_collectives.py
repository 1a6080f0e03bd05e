"""Which collectives gloo carries over CUDA tensors: two ranks on one card.

    python3 scripts/gloo_cuda_collectives.py

Run on a machine with one CUDA card (two ranks sharing it must use gloo:
NCCL refuses them).  Each collective runs in a fresh two-rank world, so a
collective that kills its rank (SIGSEGV) is reported and the rest still
run: the c10d collectives, the functional ones that DTensor calls
(``torch.distributed._functional_collectives``) and DTensor
redistributions on a (1, 2) ``data x model`` mesh.  Writes
``chiprun_out/gloo_cuda_collectives.json`` and prints it: per collective
"ok", the exception it raised, or the ranks' exit codes.  The port reads
no result of this script; it records why ``distributed/ctx.py`` carries
the functional all-gather by the c10d one on gloo.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys


def _probes():
    import torch
    import torch.distributed as dist
    import torch.distributed._functional_collectives as fc
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import (
        DTensor, Partial, Replicate, Shard, distribute_tensor)

    dev = torch.device("cuda")
    rank = dist.get_rank()
    x = torch.arange(8, dtype=torch.float32, device=dev) + rank
    mesh = DeviceMesh("cuda", torch.tensor([[0, 1]]),
                      mesh_dim_names=("data", "model"))
    group = mesh.get_group(1)
    full = torch.arange(16, dtype=torch.float32, device=dev).reshape(4, 4)

    def held(t):
        assert torch.equal(t, full), t

    return {
        "c10d all_reduce": lambda: dist.all_reduce(x.clone()),
        "c10d broadcast": lambda: dist.broadcast(x.clone(), 0),
        "c10d all_gather": lambda: dist.all_gather(
            [torch.empty_like(x) for _ in range(2)], x),
        "c10d all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty(16, device=dev), x, group=group),
        "c10d reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            torch.empty(4, device=dev), x.clone(), group=group),
        "c10d all_to_all": lambda: dist.all_to_all(
            [torch.empty(4, device=dev) for _ in range(2)],
            [x[:4].clone(), x[4:].clone()]),
        "c10d all_to_all_single": lambda: dist.all_to_all_single(
            torch.empty(8, device=dev), x.clone()),
        "functional all_reduce": lambda: fc.wait_tensor(
            fc.all_reduce(x.clone(), "sum", (mesh, 1))),
        "functional all_gather_tensor": lambda: fc.wait_tensor(
            fc.all_gather_tensor(x.clone(), 0, (mesh, 1))),
        "functional reduce_scatter_tensor": lambda: fc.wait_tensor(
            fc.reduce_scatter_tensor(x.clone(), "sum", 0, (mesh, 1))),
        "functional all_to_all_single": lambda: fc.wait_tensor(
            fc.all_to_all_single(x.clone(), None, None, (mesh, 1))),
        "DTensor Partial -> Replicate": lambda: held(DTensor.from_local(
            full / 2, mesh, [Replicate(), Partial()], run_check=False
        ).redistribute(mesh, [Replicate(), Replicate()]).to_local()),
        "DTensor Partial -> Shard": lambda: held(DTensor.from_local(
            full / 2, mesh, [Replicate(), Partial()], run_check=False
        ).redistribute(mesh, [Replicate(), Shard(0)]).full_tensor()),
        "DTensor Shard -> Replicate": lambda: held(distribute_tensor(
            full, mesh, [Replicate(), Shard(0)], src_data_rank=None
        ).full_tensor()),
        "DTensor Shard(0) -> Shard(1)": lambda: held(distribute_tensor(
            full, mesh, [Replicate(), Shard(0)], src_data_rank=None
        ).redistribute(mesh, [Replicate(), Shard(1)]).full_tensor()),
    }


def _rank(rank: int, port: int, name: str, out: str) -> None:
    import datetime

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    try:
        _probes()[name]()
        torch.cuda.synchronize()
        result = "ok"
    except Exception as e:  # the result of this probe, reported
        result = f"{type(e).__name__}: {str(e)[:160]}"
    dist.barrier()
    if rank == 0:
        with open(out, "w") as f:
            f.write(result)
    sys.stdout.flush()
    os._exit(0)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("gloo_cuda_collectives: no CUDA card", file=sys.stderr)
        return 1
    if len(sys.argv) == 5:
        _rank(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
    names = ["c10d all_reduce", "c10d broadcast", "c10d all_gather",
             "c10d all_gather_into_tensor", "c10d reduce_scatter_tensor",
             "c10d all_to_all", "c10d all_to_all_single",
             "functional all_reduce", "functional all_gather_tensor",
             "functional reduce_scatter_tensor",
             "functional all_to_all_single", "DTensor Partial -> Replicate",
             "DTensor Partial -> Shard", "DTensor Shard -> Replicate",
             "DTensor Shard(0) -> Shard(1)"]
    os.makedirs("chiprun_out", exist_ok=True)
    out = os.path.join("chiprun_out", "gloo_cuda_collectives.result")
    results = {"torch": torch.__version__, "card": torch.cuda.get_device_name(0)}
    for name in names:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        if os.path.exists(out):
            os.remove(out)
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                   str(r), str(port), name, out])
                 for r in range(2)]
        try:
            codes = [p.wait(timeout=120) for p in procs]
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            codes = [p.wait() for p in procs]
        if any(codes) or not os.path.exists(out):
            results[name] = f"rank exit codes {codes}"
        else:
            with open(out) as f:
                results[name] = f.read()
    with open(os.path.join("chiprun_out", "gloo_cuda_collectives.json"),
              "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
