"""Multi-host cluster launch: one binary everywhere, env-selected roles
(PyTorch port of the JAX package's ``launch/multihost.py``).

Every process runs the *same* command line and learns its role purely from
environment variables: ``REPRO_COORDINATOR`` / ``REPRO_NUM_PROCESSES`` /
``REPRO_PROCESS_ID`` (see ``distributed.ctx``).  This module supplies both
halves of that idiom on one machine:

``worker_env`` / ``launch_cluster``
    Spawn ``num_processes`` copies of an argv with the env trio set and
    supervise them.  The supervisor is the failure detector: the moment any
    worker exits nonzero it kills the rest (their collectives are hung on
    the dead peer, the real-cluster symptom) and raises ``ClusterFailure``.

``python -m repro_torch.launch.multihost``
    A process-spanning mining job with elastic recovery.  The parent
    invocation (env trio unset) supervises; each child (trio set) joins the
    ``torch.distributed`` group, builds the data mesh over every rank, and
    mines with ``ShardedRunner`` and per-level checkpoints into a shared
    directory (rank 0 writes, everyone restores).  ``--kill-k`` arms a
    ``faults.process_exit`` plan so a chosen worker dies
    (``os._exit(137)``) at the level-k dispatch; the supervisor then
    relaunches a cluster one process smaller *without* the fault, which
    resumes from the latest checkpoint: completed levels are never
    re-counted, and the result equals an unfailed run's.

``--device`` (``cuda`` or ``cpu``) and ``--backend`` (``nccl`` or ``gloo``;
default NCCL on CUDA, gloo on the CPU) pick where the workers count and how
they talk.  Two workers on one card need ``--backend gloo``: NCCL refuses
two ranks on one GPU.  Each worker is one rank on one device (rank %
device count), so the reference's ``--local-devices`` (forced host devices
per process) has no counterpart and is dropped.

    python -m repro_torch.launch.multihost --processes 2 --device cpu \\
        --backend gloo --kill-k 3 --min-support 0.015 --scale 0.002
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import List, Optional, Sequence, Tuple


class ClusterFailure(RuntimeError):
    """A worker died; carries who and how (137 == SIGKILL/os._exit(137))."""

    def __init__(self, process_id: int, returncode: int) -> None:
        super().__init__(
            f"worker process {process_id} exited with code {returncode}")
        self.process_id = process_id
        self.returncode = returncode


def find_free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def worker_env(coordinator: str, num_processes: int, process_id: int,
               base=None) -> dict:
    """The env one worker launches with: the multihost trio, unbuffered."""
    env = dict(os.environ if base is None else base)
    env["REPRO_COORDINATOR"] = coordinator
    env["REPRO_NUM_PROCESSES"] = str(num_processes)
    env["REPRO_PROCESS_ID"] = str(process_id)
    env["PYTHONUNBUFFERED"] = "1"
    return env


def launch_cluster(argv: Sequence[str], num_processes: int,
                   coordinator: Optional[str] = None, base_env=None,
                   popen=None, poll_interval: float = 0.05,
                   timeout: Optional[float] = None) -> str:
    """Spawn ``num_processes`` copies of ``argv`` (same command, different
    env: the SPMD launch) and supervise until all exit cleanly.

    Workers are fresh processes (never forks of this one), so a worker that
    touches CUDA starts clean.  The first worker to exit nonzero fails the
    cluster: the survivors are killed (they are blocked in collectives on
    the dead peer) and ``ClusterFailure`` is raised.  ``popen`` is
    injectable for tests.  Returns the coordinator address on success.
    """
    popen = popen or subprocess.Popen
    coordinator = coordinator or f"127.0.0.1:{find_free_port()}"
    procs = [
        popen(list(argv), env=worker_env(coordinator, num_processes, pid,
                                         base_env))
        for pid in range(num_processes)
    ]
    t0 = time.monotonic()
    try:
        while True:
            codes = [p.poll() for p in procs]
            dead = [(pid, rc) for pid, rc in enumerate(codes)
                    if rc is not None and rc != 0]
            if dead:
                raise ClusterFailure(*dead[0])
            if all(rc == 0 for rc in codes):
                return coordinator
            if timeout is not None and time.monotonic() - t0 > timeout:
                raise TimeoutError(
                    f"cluster did not finish within {timeout}s")
            time.sleep(poll_interval)
    finally:
        # On success every poll() is 0 and this is a no-op; on failure it is
        # the supervisor's kill of the hung survivors.
        for p in procs:
            if p.poll() is None:
                try:
                    p.kill()
                except OSError:
                    pass
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass


# -- the mining job (worker role) --------------------------------------------

def _worker_main(args) -> int:
    from repro_torch.distributed import ctx

    # Before anything touches a CUDA device: selects this rank's card.
    ctx.initialize_multihost(device=args.device, backend=args.backend)

    from repro_torch.core.miner import FrequentItemsetMiner
    from repro_torch.core.runtime import ShardedRunner
    from repro_torch.core.runtime import faults as F
    from repro_torch.core.runtime.faults import FaultPlan
    from repro_torch.data import get_dataset
    from repro_torch.distributed import checkpoint as ckpt
    from repro_torch.launch.mesh import make_data_mesh

    db = get_dataset(args.dataset, scale=args.scale, seed=args.seed)
    restored = None
    if args.checkpoint_dir and os.path.isdir(args.checkpoint_dir):
        restored = ckpt.latest_step(args.checkpoint_dir)
    plan = None
    if args.kill_k is not None:
        plan = FaultPlan(F.process_exit(k=args.kill_k,
                                        process=args.kill_process))
    runner = ShardedRunner(store=args.store,
                           mesh=make_data_mesh(device=args.device),
                           fault_plan=plan)
    miner = FrequentItemsetMiner(min_support=args.min_support,
                                 max_k=args.max_k, runner=runner,
                                 checkpoint_dir=args.checkpoint_dir)
    res = miner.mine(db)
    if ctx.process_index() == 0 and args.out:
        payload = {
            "itemsets": sorted([list(s), int(c)]
                               for s, c in res.itemsets.items()),
            "n_transactions": res.n_transactions,
            "min_count": res.min_count,
            "processes": ctx.process_count(),
            # One rank drives one device.
            "devices": ctx.process_count(),
            # The step this (final, successful) cluster resumed from: None
            # on a clean first run, >= 2 after a mid-wave relaunch.
            "restored_step": restored,
            # Level-counting profile rows (k >= 2), restored ones included:
            # on a resumed run this still equals the clean run's ledger.
            "counting_jobs": sum(1 for p in res.levels if p.k >= 2),
        }
        tmp = args.out + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, args.out)
    return 0


def exit_rank(code: int = 0) -> None:
    """End a rank's process: wait for every rank of the world at a barrier,
    then leave without the interpreter's teardown.  Process groups that
    objects (meshes, engines) still reference are otherwise torn down at
    interpreter exit, and a rank can then abort ("terminate called without
    an active exception", SIGABRT), which ``launch_cluster`` reports as a
    failed worker."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.barrier()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


# -- the supervisor (parent role) --------------------------------------------

def _build_argv(args, include_kill: bool) -> List[str]:
    argv = [sys.executable, "-m", "repro_torch.launch.multihost",
            "--dataset", args.dataset, "--scale", str(args.scale),
            "--seed", str(args.seed),
            "--min-support", str(args.min_support),
            "--store", args.store, "--max-k", str(args.max_k),
            "--processes", str(args.processes),
            "--device", args.device,
            "--checkpoint-dir", args.checkpoint_dir,
            "--out", args.out]
    if args.backend is not None:
        argv += ["--backend", args.backend]
    if include_kill and args.kill_k is not None:
        # Faults are one-shot, like the real failure: relaunches run clean.
        argv += ["--kill-k", str(args.kill_k),
                 "--kill-process", str(args.kill_process)]
    return argv


def supervise(args) -> dict:
    """Launch the cluster; on a worker death, relaunch one process smaller
    from the shared checkpoint dir (up to ``--elastic`` times)."""
    if not args.checkpoint_dir:
        args.checkpoint_dir = tempfile.mkdtemp(prefix="repro_torch_multihost_")
    if not args.out:
        args.out = os.path.join(args.checkpoint_dir, "result.json")
    n = args.processes
    relaunches = 0
    failures: List[Tuple[int, int]] = []
    while True:
        try:
            launch_cluster(_build_argv(args, include_kill=relaunches == 0),
                           n, timeout=args.timeout)
            break
        except ClusterFailure as f:
            failures.append((f.process_id, f.returncode))
            relaunches += 1
            if relaunches > args.elastic:
                raise
            n = max(1, n - 1)
            print(f"[multihost] worker {f.process_id} died "
                  f"(rc={f.returncode}); relaunching {n} process(es) from "
                  f"{args.checkpoint_dir}", flush=True)
    with open(args.out) as f:
        result = json.load(f)
    return {"result": result, "relaunches": relaunches,
            "failures": failures, "final_processes": n}


def _parse(argv=None):
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.multihost",
        description="process-spanning mining job with elastic recovery "
                    "(parent supervises; REPRO_* env makes it a worker)")
    ap.add_argument("--processes", type=int, default=2)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where every worker counts (one rank per device)")
    ap.add_argument("--backend", choices=["nccl", "gloo"], default=None,
                    help="process-group backend (default: nccl on cuda, "
                    "gloo on cpu; gloo shares one card between workers)")
    ap.add_argument("--dataset", default="T10I4D100K")
    ap.add_argument("--scale", type=float, default=0.002)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--min-support", type=float, default=0.05)
    ap.add_argument("--store", default="perfect_hash")
    ap.add_argument("--max-k", type=int, default=6)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--out", default=None,
                    help="result JSON (written by worker process 0)")
    ap.add_argument("--kill-k", type=int, default=None,
                    help="kill a worker at level-k dispatch (fault demo)")
    ap.add_argument("--kill-process", type=int, default=1)
    ap.add_argument("--elastic", type=int, default=1,
                    help="max cluster relaunches after a worker death")
    ap.add_argument("--timeout", type=float, default=600.0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = _parse(argv)
    from repro_torch.distributed.ctx import multihost_env

    if multihost_env() is not None:
        exit_rank(_worker_main(args))
    summary = supervise(args)
    print("MULTIHOST_OK " + json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
