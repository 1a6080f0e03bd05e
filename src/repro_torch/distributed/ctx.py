"""Multi-host initialization for the PyTorch port (``torch.distributed``).

The launch idiom of the JAX package's ``distributed/ctx.py``: the same
binary runs on every host and learns its role from three environment
variables.  A launcher exports ``REPRO_COORDINATOR`` (``host:port`` of rank
0's rendezvous), ``REPRO_NUM_PROCESSES`` and ``REPRO_PROCESS_ID``, and every
process calls :func:`initialize_multihost` before it touches a CUDA device.
With the trio unset that is a no-op, so a single-process run is unchanged.

One process drives one device.  The default process group is NCCL for CUDA
tensors and gloo for CPU tensors; gloo over CUDA tensors is taken only when
the caller names ``backend="gloo"`` (two ranks sharing one card, which NCCL
refuses).  There is no fallback: a failed NCCL init raises.  Before any CUDA
work each rank selects ``cuda:(rank % device_count())``.

After initialization the mesh constructors of ``launch/mesh.py`` span every
process, and the counting engine's ``all_reduce`` over ``data`` is a real
cross-process collective.  :func:`fetch_global` is the matching
device-to-host fetch: every engine output is whole on every rank once its
collectives ran, so it is a plain copy.

The activation-sharding half of the reference module (``use_sharding``,
``constrain``) belongs to the LM scaffolding and is not ported.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Mapping, Optional

import numpy as np

ENV_COORDINATOR = "REPRO_COORDINATOR"      # host:port of process 0
ENV_NUM_PROCESSES = "REPRO_NUM_PROCESSES"  # total processes in the job
ENV_PROCESS_ID = "REPRO_PROCESS_ID"        # this process's index [0, N)

BACKENDS = ("nccl", "gloo")


@dataclasses.dataclass(frozen=True)
class MultihostSpec:
    """One process's view of the job: who coordinates, how many, which am I."""

    coordinator: str
    num_processes: int
    process_id: int


def multihost_env(env: Optional[Mapping[str, str]] = None
                  ) -> Optional[MultihostSpec]:
    """Parse the launch env trio.  ``None`` when unset (single-process run);
    a *partially* set trio is a launcher bug and raises rather than quietly
    running single-process on one host of a would-be cluster."""
    env = os.environ if env is None else env
    raw = {name: env.get(name) for name in
           (ENV_COORDINATOR, ENV_NUM_PROCESSES, ENV_PROCESS_ID)}
    if all(v is None for v in raw.values()):
        return None
    missing = [name for name, v in raw.items() if v is None]
    if missing:
        raise ValueError(
            f"partial multihost environment: {missing} unset while "
            f"{[n for n, v in raw.items() if v is not None]} set — export "
            "all three or none")
    try:
        num = int(raw[ENV_NUM_PROCESSES])
        pid = int(raw[ENV_PROCESS_ID])
    except ValueError as e:
        raise ValueError(f"non-integer multihost environment: {e}") from None
    if num < 1:
        raise ValueError(f"{ENV_NUM_PROCESSES} must be >= 1, got {num}")
    if not 0 <= pid < num:
        raise ValueError(
            f"{ENV_PROCESS_ID} must be in [0, {num}), got {pid}")
    return MultihostSpec(raw[ENV_COORDINATOR], num, pid)


def init_group(coordinator: str, world_size: int, rank: int, device="cuda",
               backend: Optional[str] = None,
               timeout: Optional[float] = None) -> None:
    """``init_process_group`` over ``tcp://coordinator``, after selecting this
    rank's card (``rank % device_count()``) when ``device`` is CUDA.  A CUDA
    device without a card raises, as does any failed init: nothing falls
    back to gloo or to the CPU."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.runtime.engine import resolve_device

    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the NCCL backend needs device='cuda'")
    if dev.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    kwargs = {}
    if timeout is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=float(timeout))
    dist.init_process_group(backend=backend, init_method=f"tcp://{coordinator}",
                            world_size=int(world_size), rank=int(rank),
                            **kwargs)


_MULTIHOST_ACTIVE: Optional[MultihostSpec] = None


def initialize_multihost(spec: Optional[MultihostSpec] = None,
                         env: Optional[Mapping[str, str]] = None,
                         device="cuda", backend: Optional[str] = None,
                         timeout: Optional[float] = None
                         ) -> Optional[MultihostSpec]:
    """Idempotent ``torch.distributed`` init from the env trio (or ``spec``).

    No-op (returns ``None``) when the trio is unset.  ``backend`` defaults
    to NCCL for ``device="cuda"`` and gloo for ``"cpu"``; ``timeout``
    (seconds) bounds every collective, so a dead peer fails the survivors
    instead of hanging them.  Calling again with the same spec returns it;
    a *different* spec raises (one process is one cluster member, forever).
    """
    global _MULTIHOST_ACTIVE
    if spec is None:
        spec = multihost_env(env)
    if spec is None:
        return None
    if _MULTIHOST_ACTIVE is not None:
        if _MULTIHOST_ACTIVE != spec:
            raise RuntimeError(
                f"multihost already initialized as {_MULTIHOST_ACTIVE}, "
                f"refusing to re-initialize as {spec}")
        return _MULTIHOST_ACTIVE
    init_group(spec.coordinator, spec.num_processes, spec.process_id,
               device=device, backend=backend, timeout=timeout)
    _MULTIHOST_ACTIVE = spec
    return spec


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    from repro_torch.core.runtime.faults import process_rank

    return process_rank()


def process_count() -> int:
    """The world size (1 without a process group)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return int(dist.get_world_size())
    return 1


def fetch_global(x) -> np.ndarray:
    """Device-to-host fetch of an engine output.  The engine runs its
    collectives at dispatch (``all_reduce`` over ``data``, ``all_gather``
    over ``cand``), so every output is whole on every rank and the fetch
    is a plain copy; NumPy arrays pass through."""
    if isinstance(x, np.ndarray):
        return x
    import torch

    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
