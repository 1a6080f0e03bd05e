"""Roofline terms and the per-device measurements of one step (PyTorch port
of the JAX package's ``launch/hlo_stats.py``).

The reference reads a compiled SPMD executable: ``cost_analysis()`` for
per-device flops and bytes, and the optimized HLO text for collective
traffic.  The port has no HLO.  It runs the step eagerly inside
:class:`StepCounter`, a dispatch mode that sees every operation *below*
DTensor: after DTensor has redistributed its operands and split the work,
on one rank's local tensors.  So every count is per device, as the
reference's, replicated work included.  Under ``FakeTensorMode`` on a
``fake`` process group (``launch/dryrun.py``) nothing is allocated and no
byte moves, so a 256-rank mesh is measured in one process.

* flops: ``torch.utils.flop_counter``'s formulas, per local operation (the
  table ``FlopCounterMode`` uses, with its decomposition of operations that
  have no formula).
* bytes: the input and output bytes of every local operation that is not a
  view (a broadcast operand counted at its storage's size).  Eager PyTorch
  runs unfused, so this is an upper bound of XLA's "bytes accessed" for
  the same step.
* collectives: one record per ``_c10d_functional`` operation DTensor
  issues, with its output; :func:`collective_bytes` sums the collectives
  among them by kind (a wait is none).
* memory: the local bytes live at once (storages, counted once however
  many views share them), its peak over the step.

DTensor works out each result's global shape by running the operation on
fake tensors of the global shapes; those runs are not the step's work and
are not counted.
"""

from __future__ import annotations

import sys
import weakref
from typing import Dict, Iterable

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# The reference's collective kinds (HLO op names), keyed by the
# ``_c10d_functional`` operation that carries each one in PyTorch.
_COLLECTIVES = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute", "ragged-all-to-all",
)
_FUNCTIONAL = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
_FUNCTIONAL_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd")


def _kind(op: str):
    """The collective kind of a record's op name, or None: a kind itself
    (a ``-start`` suffix allowed, ``-done`` not a collective) or a
    functional op's schema name (``namespace::name``), which keeps its own
    name where it has no kind (nothing recorded is dropped)."""
    if op.endswith("-done"):
        return None
    base = op.removesuffix("-start")
    if base in _COLLECTIVES:
        return base
    if "::" not in base:
        return None
    name = base.split("::")[-1]
    if name.startswith("wait"):  # a collective's completion, as "-done"
        return None
    return _FUNCTIONAL.get(name, name)


def _result_bytes(results) -> int:
    """Bytes of a record's results: a tensor, or a sequence of tensors or
    of (shape, dtype) pairs."""
    if isinstance(results, torch.Tensor):
        results = [results]
    total = 0
    for r in results:
        if isinstance(r, torch.Tensor):
            total += r.numel() * r.element_size()
        else:
            shape, dtype = r
            n = 1
            for d in shape:
                n *= int(d)
            total += n * dtype.itemsize
    return total


def collective_bytes(records: Iterable) -> Dict[str, int]:
    """Per-device bytes moved by each collective kind: the sum of the
    *result*-shape sizes of every collective in ``records`` (one ``(op,
    results)`` pair a collective, as :class:`StepCounter` logs them), as
    the reference sums the result shapes in the HLO.  An all-gather counts
    its whole result, world x its input; a reduce-scatter its shard."""
    out: Dict[str, int] = {}
    for op, results in records:
        kind = _kind(op)
        if kind is None:
            continue
        out[kind] = out.get(kind, 0) + _result_bytes(results)
    return out


def roofline_terms(
    flops: float,
    hbm_bytes: float,
    coll_bytes: float,
    *,
    peak_flops: float = 989e12,   # H100 SXM dense bf16 tensor cores
    hbm_bw: float = 3.35e12,      # B/s, H100 SXM HBM3
    link_bw: float = 450e9,       # B/s each way, H100 SXM NVLink
) -> Dict[str, float]:
    """Time bounds of a step from its per-device costs.  The defaults are
    the data sheet's NVIDIA H100 SXM (80 GB HBM3) at its 700 W limit; the
    reference's defaults were a TPU's."""
    t_compute = flops / peak_flops
    t_memory = hbm_bytes / hbm_bw
    t_collective = coll_bytes / link_bw
    terms = {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_collective,
    }
    dom = max(terms, key=terms.get)
    terms["bottleneck"] = {"t_compute_s": "compute", "t_memory_s": "memory",
                           "t_collective_s": "collective"}[dom]
    step_time = max(t_compute, t_memory, t_collective)
    terms["step_time_bound_s"] = step_time
    return terms


# -- the recording mode ---------------------------------------------------------

_aten = torch.ops.aten


def _overloads(*names):
    """The aten overloads ``packet.overload`` of this torch (a name it
    lacks is left out)."""
    out = set()
    for name in names:
        packet, overload = name.split(".")
        op = getattr(getattr(_aten, packet, None), overload, None)
        if op is not None:
            out.add(op)
    return out


# Queries of a tensor's metadata: no work (FlopCounterMode skips them too).
_METADATA = _overloads(
    "sym_is_contiguous.default", "is_contiguous.default",
    "is_contiguous.memory_format", "is_strides_like_format.default",
    "is_non_overlapping_and_dense.default", "size.default",
    "sym_size.default", "stride.default", "sym_stride.default",
    "storage_offset.default", "sym_storage_offset.default", "numel.default",
    "sym_numel.default", "dim.default") | {torch.ops.prim.layout.default}
# Operations that move no bytes: aliases and uninitialized allocations.
_NO_BYTES = {"detach", "alias", "_unsafe_view", "lift_fresh", "empty",
             "empty_strided", "empty_like", "new_empty",
             "new_empty_strided"}


def _tensors(tree):
    """The tensors of a nest of tuples, lists and dicts."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


def _nbytes(t) -> int:
    """Bytes an operation moves for ``t``: its elements, at most its
    storage (a broadcast view reads its storage once)."""
    n = t.numel() * t.element_size()
    try:
        return min(n, t.untyped_storage().nbytes())
    except (RuntimeError, NotImplementedError):
        return n


def _storage_key(t):
    try:
        return t.untyped_storage()._cdata
    except (RuntimeError, NotImplementedError):
        return None


def _in_shape_propagation() -> bool:
    """True inside DTensor's run on global-shaped fake tensors (the
    ``_propagate_tensor_meta`` family), which computes no shard."""
    f = sys._getframe(2)
    while f is not None:
        if "propagate_tensor_meta" in f.f_code.co_name:
            return True
        f = f.f_back
    return False


class StepCounter(TorchDispatchMode):
    """Counts one rank's flops, bytes, collectives and live memory over the
    operations run inside it (see the module docstring).

    ``track(tree)`` counts tensors made before the mode (a step's
    arguments) as live; ``peak`` is the most local bytes live at once,
    ``records`` the ``(op name, output)`` pairs of every collective."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.records = []
        self.live = 0
        self.peak = 0
        self._storages = {}

    def track(self, tree) -> int:
        """Counts the tensors of ``tree`` as live; returns their bytes
        (each storage once)."""
        before = self.live
        for t in _tensors(tree):
            self._hold(t)
        return self.live - before

    def _hold(self, t):
        key = _storage_key(t)
        if key is None:
            return
        entry = self._storages.get(key)
        if entry is None:
            entry = self._storages[key] = [t.untyped_storage().nbytes(), 0]
            self.live += entry[0]
            self.peak = max(self.peak, self.live)
        entry[1] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key):
        entry = self._storages.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self.live -= entry[0]
            del self._storages[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        # DTensor first: it desugars into local operations and collectives,
        # which come back through this mode (as CommDebugMode relies on).
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if func in _METADATA or isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        packet = func._overloadpacket
        if packet not in flop_registry and func is not torch.ops.prim.device.default:
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if _in_shape_propagation():
            return out
        namespace = func.namespace
        if namespace in _FUNCTIONAL_NAMESPACES:
            self.records.append((func._schema.name, out))
        else:
            if packet in flop_registry:
                self.flops += flop_registry[packet](*args, **kwargs,
                                                    out_val=out)
            if not func.is_view and packet.__name__ not in _NO_BYTES:
                self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
                self.bytes += sum(_nbytes(t) for t in _tensors(out))
        for t in _tensors(out):
            self._hold(t)
        return out
