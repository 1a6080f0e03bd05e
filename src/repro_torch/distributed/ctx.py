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

**Activation sharding.**  Model code is mesh-agnostic; launchers activate
(mesh, rules) with :func:`use_sharding` and the layers call
:func:`constrain` on intermediate activations, the counterpart of the
reference's ``with_sharding_constraint``: inside the context it
redistributes its DTensor argument to the placements the rules give,
outside it returns its argument itself, so every single-device path keeps
its numbers bit for bit.  Inside the context, plain tensors that meet
DTensors (masks, positions, rope tables, cache indices) count as
replicated (``implicit_replication``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import threading
from contextvars import ContextVar
from typing import Mapping, Optional, Tuple

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
    if backend == "gloo" and dev.type == "cuda":
        _gloo_cuda_all_gather()


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
    is a plain copy; NumPy arrays pass through.  A DTensor (the LM on a
    mesh) is gathered whole first, which is a collective."""
    if isinstance(x, np.ndarray):
        return x
    import torch

    if isinstance(x, torch.Tensor):
        return whole(x).detach().cpu().numpy()
    return np.asarray(x)


# -- activation-sharding context ---------------------------------------------

_ACTIVE: ContextVar[Optional[Tuple[object, object]]] = ContextVar(
    "repro_torch_sharding_ctx", default=None)


_OPEN = threading.Lock()
_open = {"depth": 0, "replicate": None}  # use_sharding contexts, any thread


@contextlib.contextmanager
def use_sharding(mesh, rules):
    """Run the model on ``mesh`` under ``rules`` (a ``ShardingRules``):
    ``constrain`` places activations, and plain tensors meeting DTensors
    count as replicated.  Backward runs inside it too: DTensor's implicit
    replication is one process-wide switch (not reentrant), turned on by
    the outermost context and off when the last one closes, so a
    recomputation that re-enters the context on autograd's thread
    (``recompute_context``) leaves it on."""
    from torch.distributed.tensor.experimental import implicit_replication

    token = _ACTIVE.set((mesh, rules))
    with _OPEN:
        _open["depth"] += 1
        if _open["depth"] == 1:
            _open["replicate"] = implicit_replication()
            _open["replicate"].__enter__()
    try:
        yield
    finally:
        _ACTIVE.reset(token)
        with _OPEN:
            _open["depth"] -= 1
            if _open["depth"] == 0:
                _open["replicate"].__exit__(None, None, None)


_ALL_GATHER_LIB = None


def _gloo_cuda_all_gather() -> None:
    """Carry PyTorch's functional all-gather over CUDA tensors on gloo
    groups by the c10d ``all_gather_into_tensor``.

    DTensor gathers through ``_c10d_functional.all_gather_into_tensor``,
    and with gloo over CUDA tensors that kernel crashes the process
    (SIGSEGV, torch 2.11 on the H100; two ranks sharing one card must use
    gloo, since NCCL refuses them).  The c10d collective that gloo does
    carry over CUDA tensors gives the same result, so a process whose
    default group is gloo over CUDA tensors registers it as that op's CUDA
    kernel, once, when the group is made (``init_group``).  A group of
    another backend still reaches the op's own kernel; an NCCL or CPU
    process registers nothing."""
    global _ALL_GATHER_LIB
    if _ALL_GATHER_LIB is not None:
        return
    import torch

    own = torch.library.Library("_c10d_functional", "IMPL")
    own.impl("all_gather_into_tensor", _all_gather_into_tensor, "CUDA")
    _ALL_GATHER_LIB = own


def _all_gather_into_tensor(inp, group_size, group_name):
    """The CUDA kernel ``_gloo_cuda_all_gather`` registers: a gloo group
    gathers by the blocking c10d call, any other by the op's own kernel."""
    import torch
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    group = _resolve_process_group(group_name)
    if dist.get_backend(group) != "gloo":
        op = torch.ops._c10d_functional.all_gather_into_tensor.default
        return op._op_dk(torch._C.DispatchKey.CompositeExplicitAutograd,
                         inp, group_size, group_name)
    out = inp.new_empty((inp.shape[0] * group_size, *inp.shape[1:]))
    dist.all_gather_into_tensor(out, inp.contiguous(), group=group)
    return out


def active_sharding() -> Optional[Tuple[object, object]]:
    """The (mesh, rules) of the innermost ``use_sharding``, or None."""
    return _ACTIVE.get()


def constrain(x, *axes):
    """Constrain ``x``'s sharding by logical axis names (None = replicated):
    ``x`` itself outside ``use_sharding``, else ``x`` as a DTensor placed
    as the rules give on the active mesh (a plain tensor counts as
    replicated)."""
    active = _ACTIVE.get()
    if active is None:
        return x
    mesh, rules = active
    from repro_torch.models.params import logical_to_pspec, placements

    want = placements(logical_to_pspec(axes, rules.rules, x.shape, mesh), mesh)
    return as_dtensor(x, mesh).redistribute(mesh, want)


def as_dtensor(x, mesh):
    """``x`` as a DTensor on ``mesh``: a plain tensor (whole on every rank)
    becomes a replicated one, with no collective."""
    from torch.distributed.tensor import DTensor, Replicate

    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def write_seq(dst, start: int, value) -> None:
    """``dst[:, start:start + n] = value`` in place, ``n = value.shape[1]``:
    the reference's ``dynamic_update_slice`` along a cache's sequence dim.

    ``dst`` may be a DTensor whose sequence dim is sharded (``cache_seq``):
    ``value`` is then placed as ``dst`` is but whole along that dim, and
    each rank writes the rows that fall in its own shard, with no further
    collective."""
    n = value.shape[1]
    if _ACTIVE.get() is None or not _is_dtensor(dst):
        dst[:, start:start + n] = value
        return
    from torch.distributed.tensor import Replicate, Shard

    want = tuple(Replicate() if isinstance(p, Shard) and p.dim == 1 else p
                 for p in dst.placements)
    local_v = as_dtensor(value, dst.device_mesh).redistribute(
        dst.device_mesh, want).to_local()
    local = dst.to_local()
    first = local_offset(dst)[1]
    lo, hi = max(start, first), min(start + n, first + local.shape[1])
    if lo < hi:
        local[:, lo - first:hi - first] = local_v[:, lo - start:hi - start]


def whole(x):
    """``x`` whole on this rank: a DTensor's ``full_tensor()`` (a
    collective: every rank calls it), anything else as it is."""
    return x.full_tensor() if _is_dtensor(x) else x


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


@contextlib.contextmanager
def local_region():
    """Suspend ``use_sharding`` for code that runs on one rank's local
    shards (plain tensors): ``constrain`` returns its argument there."""
    token = _ACTIVE.set(None)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def local_offset(x) -> Tuple[int, ...]:
    """Where this rank's shard of the DTensor ``x`` starts, per dim (the
    index arithmetic runs on real tensors, also under ``FakeTensorMode``)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)

    with unset_fake_temporarily():
        return tuple(compute_local_shape_and_global_offset(
            x.shape, x.device_mesh, x.placements)[1])


def recompute_context(context_fn=None):
    """A ``context_fn`` for ``torch.utils.checkpoint``: ``context_fn``'s
    (forward, recompute) pair, with the recomputation run under the
    forward's ``use_sharding``.  Backward may recompute on autograd's
    device thread, where the context is not active, and a recomputation
    must place its tensors as the forward did.  Outside ``use_sharding``
    it is ``context_fn`` itself."""
    active = _ACTIVE.get()
    if active is None:
        return context_fn

    def both():
        fwd, rec = (context_fn() if context_fn is not None else
                    (contextlib.nullcontext(), contextlib.nullcontext()))
        return fwd, _entered(rec, use_sharding(*active))

    return both


@contextlib.contextmanager
def _entered(*managers):
    with contextlib.ExitStack() as stack:
        for m in managers:
            stack.enter_context(m)
        yield
