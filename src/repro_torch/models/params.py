"""Abstract-first parameter system (PyTorch port of the JAX package's
``models/params.py``).

Models are plain functions over nested-dict parameter trees.  ``*_abstract``
functions build *abstract* trees whose leaves are :class:`ParamSpec`
(shape, dtype, logical axes, initializer); ``materialize(generator, tree)``
turns one into tensors on a device.  Leaves are visited in the order
``jax.tree`` flattens a dict (sorted keys), so a tree's leaves line up one
to one with the reference's.

Each leaf's logical axis names place it on a mesh of ranks:
``logical_to_pspec`` resolves them through the sharding rules
(``distributed.sharding``) to the reference's per-dimension spec,
``placements`` turns a spec into DTensor placements, ``shardings`` gives a
tree of them, ``place`` puts a tree of whole tensors onto a mesh as
DTensors, and ``shape_structs`` gives the meta tensors (global and
per-rank shapes) that a dry run reads.  The port holds one tree per layer where the
reference stacks the layers, so a leaf's spec is the reference's stacked
leaf's spec without its leading ``layers`` entry (``None`` under every
rule).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.runtime.engine import resolve_device


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    dtype: torch.dtype = torch.bfloat16
    axes: Tuple[Optional[str], ...] = ()  # logical axis name per dim (None = replicated)
    init: str = "normal"                  # normal | zeros | ones | embed
    scale: float = 1.0

    def __post_init__(self):
        assert len(self.axes) == len(self.shape), (self.shape, self.axes)


def spec(shape, axes, dtype=torch.bfloat16, init="normal", scale=1.0) -> ParamSpec:
    return ParamSpec(tuple(shape), dtype, tuple(axes), init, scale)


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def tree_map(fn, tree):
    """``fn`` over every leaf of a nested-dict tree, keeping its structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree) -> list:
    """Leaves in ``jax.tree.leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_map_specs(fn, tree):
    return tree_map(fn, tree)


def materialize(generator: Optional[torch.Generator], tree,
                dtype_override: Optional[torch.dtype] = None, device=None):
    """Concrete init. Fan-in-scaled normal for matmuls; zeros for biases/norm
    offsets.  The rule is the reference's, ``fan_in = shape[-2]`` included
    (for ``wq`` of shape (d, h, hd) that is ``h``); the values differ, since
    ``jax.random`` is not reproducible in torch.  Normal leaves draw from
    ``generator`` in leaf order, on ``device`` (default: the generator's);
    a tree of zeros and ones needs no generator."""
    if device is None:
        if generator is None:
            raise ValueError("materialize needs a device or a generator")
        device = generator.device
    dev = resolve_device(device)

    def one(s: ParamSpec):
        dtype = dtype_override or s.dtype
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=dtype, device=dev)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=dtype, device=dev)
        if generator is None:
            raise ValueError(f"a normal leaf {s.shape} needs a generator")
        fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
        std = s.scale / math.sqrt(max(1, fan_in))
        if s.init == "embed":
            std = s.scale
        out = torch.randn(s.shape, generator=generator, dtype=torch.float32,
                          device=dev)
        return out.mul_(std).to(dtype)

    def build(t):  # sorted keys: the leaves draw in tree_leaves order
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return one(t)

    return build(tree)


def count_params(tree) -> int:
    total = 0
    for leaf in tree_leaves(tree):
        shape = leaf.shape
        total += int(np.prod(shape)) if shape else 1
    return total


# -- mesh placement ----------------------------------------------------------

def _axis_size(mesh, name: str) -> int:
    """The size of mesh axis ``name``: a ``DeviceMesh``'s named dim, or
    ``mesh.shape[name]`` for any object whose ``shape`` maps names to
    sizes (a stand-in mesh of a dry run or a test)."""
    shape = mesh.shape
    if isinstance(shape, dict):
        return int(shape[name])
    return int(mesh.size(mesh.mesh_dim_names.index(name)))


def logical_to_pspec(axes: Sequence[Optional[str]], rules: dict,
                     shape: Optional[Sequence[int]] = None,
                     mesh=None) -> tuple:
    """Resolve logical axes to a spec: one entry per dimension, ``None``
    (replicated), a mesh axis name or a tuple of names.

    With ``shape`` and ``mesh`` given, a dim whose size is not divisible by
    the product of its mesh axes drops leading axes until it divides, and
    falls back to replication when none is left (the MaxText rule: 2 KV
    heads cannot be sharded over a 16-way model axis).  A mesh axis
    appears at most once in a spec.
    """
    out = []
    used: set = set()
    for i, name in enumerate(axes):
        mesh_axes = rules.get(name) if name is not None else None
        if mesh_axes is None:
            out.append(None)
            continue
        if isinstance(mesh_axes, str):
            mesh_axes = (mesh_axes,)
        mesh_axes = tuple(a for a in mesh_axes if a not in used)
        if shape is not None and mesh is not None and mesh_axes:
            while mesh_axes:  # progressive fallback
                total = 1
                for a in mesh_axes:
                    total *= _axis_size(mesh, a)
                if shape[i] % total == 0:
                    break
                mesh_axes = mesh_axes[1:]
        used.update(mesh_axes)
        if not mesh_axes:
            out.append(None)
        else:
            out.append(mesh_axes if len(mesh_axes) != 1 else mesh_axes[0])
    return tuple(out)


def placements(pspec: tuple, mesh) -> tuple:
    """DTensor placements of ``pspec`` on ``mesh``, one per mesh dim:
    ``Shard(d)`` where the spec puts tensor dim ``d`` on that mesh axis,
    else ``Replicate()``.  A dim over several mesh axes is split in mesh
    order (major to minor), as the reference's tuple of axes is.  A mesh
    axis of size 1 replicates: its one shard is the whole tensor (and
    DTensor refuses to drop a size-1 dim that it counts as sharded)."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(pspec):
        if entry is None:
            continue
        for a in (entry,) if isinstance(entry, str) else entry:
            if _axis_size(mesh, a) > 1:
                out[names.index(a)] = Shard(dim)
    return tuple(out)


def shardings(tree, mesh, rules: dict):
    """The placements of every leaf of an abstract tree on ``mesh``."""
    def one(s: ParamSpec):
        return placements(logical_to_pspec(s.axes, rules, s.shape, mesh), mesh)

    return tree_map_specs(one, tree)


def local_shape(shape: Sequence[int], pspec: tuple, mesh) -> Tuple[int, ...]:
    """One rank's shard of a ``shape`` tensor placed by ``pspec`` (whose
    dims divide, as ``logical_to_pspec`` with a mesh guarantees)."""
    out = []
    for n, entry in zip(shape, pspec):
        for a in () if entry is None else (
                (entry,) if isinstance(entry, str) else entry):
            n //= _axis_size(mesh, a)
        out.append(n)
    return tuple(out)


class StandInMesh:
    """A mesh's axis sizes and names without a process group: all that
    ``logical_to_pspec``, ``placements`` and ``shape_structs`` read (a
    production mesh sized on a box that has none)."""

    def __init__(self, sizes: Sequence[int], names: Sequence[str]):
        self.shape = dict(zip(names, sizes))
        self.mesh_dim_names = tuple(names)


@dataclasses.dataclass(frozen=True)
class ShapeStruct:
    """A leaf placed on a mesh without memory: the meta tensor of its
    global shape, its spec and one rank's shard of it (a meta tensor)."""

    global_: torch.Tensor
    pspec: tuple
    local: torch.Tensor

    @property
    def shape(self):
        return self.global_.shape

    @property
    def dtype(self):
        return self.global_.dtype


def shape_structs(tree, mesh=None, rules: Optional[dict] = None,
                  dtype_override: Optional[torch.dtype] = None):
    """Meta tensors of every leaf's global shape; with ``mesh`` and
    ``rules``, a ``ShapeStruct`` per leaf that also holds its spec and its
    per-rank shard.  ``mesh`` may be a ``StandInMesh``: nothing here
    touches a process group."""
    def one(s: ParamSpec):
        dt = dtype_override or s.dtype
        glob = torch.empty(s.shape, dtype=dt, device="meta")
        if mesh is None:
            return glob
        ps = logical_to_pspec(s.axes, rules, s.shape, mesh)
        return ShapeStruct(glob, ps, torch.empty(local_shape(s.shape, ps, mesh),
                                                 dtype=dt, device="meta"))

    return tree_map_specs(one, tree)


def place(tree, mesh, placements_tree):
    """Each leaf of a tree of whole tensors as a DTensor on ``mesh``: every
    rank holds the same tree (materialized from the same seed, or read
    from the same snapshot) and keeps its own chunk, so placing needs no
    collective.  ``placements_tree`` is ``shardings``' tree."""
    from torch.distributed.tensor import distribute_tensor

    def walk(t, pl):
        if isinstance(t, dict):
            return {k: walk(t[k], pl[k]) for k in t}
        out = distribute_tensor(t.detach(), mesh, pl, src_data_rank=None)
        return out.requires_grad_(t.requires_grad)

    return walk(tree, placements_tree)
