"""Abstract-first parameter system (PyTorch port of the JAX package's
``models/params.py``).

Models are plain functions over nested-dict parameter trees.  ``*_abstract``
functions build *abstract* trees whose leaves are :class:`ParamSpec`
(shape, dtype, logical axes, initializer); ``materialize(generator, tree)``
turns one into tensors on a device.  Leaves are visited in the order
``jax.tree`` flattens a dict (sorted keys), so a tree's leaves line up one
to one with the reference's.

The logical axis names are kept for the sharding slice: ``logical_to_pspec``,
``shardings`` and ``shape_structs`` (mesh placement of the LM's
parameters) are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

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
