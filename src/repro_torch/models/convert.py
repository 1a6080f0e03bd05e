"""Weights carried across from the JAX package (port-only module).

``params_from_reference(tree, cfg, device)`` takes the reference's parameter
tree as numpy arrays (``jax.tree.map(np.asarray, params)``) and returns the
port's: the ``blocks`` subtree's ``head``/``scan``/``tail`` layout becomes
one tree per layer, in ``blocks.layer_kinds`` order, with each ``scan``
leaf's leading ``n_super`` axis unstacked back into layers (a stacked
scalar, the cross layer's ``attn_gate``, into 0-d tensors).  Tied
embeddings carry no ``lm_head`` on either side.  ``cache_from_reference``
does the same for caches, and ``opt_state_from_reference`` for the
optimizer state (``m``, ``v`` and, with compression, ``ef``: each a tree
shaped like the parameters).

bfloat16 arrays (numpy ``dtype.name == "bfloat16"``, the ``ml_dtypes``
type) are read through their bits, ``uint16`` -> ``int16`` ->
``torch.bfloat16``, so this module needs no ``ml_dtypes``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.runtime.engine import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.params import tree_leaves


def tensor_from_numpy(a, device) -> torch.Tensor:
    """A copy of ``a`` on ``device`` (the reference's arrays are read-only)."""
    a = np.array(a, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _unstack(blocks, cfg: ModelConfig):
    """The reference's head/scan/tail stack as {layer index: layer tree}."""
    pl = T.plan(cfg)
    p = len(pl.pattern)
    out = {}
    for i in range(len(pl.head)):
        out[str(i)] = blocks["head"][str(i)]
    for s in range(pl.n_super):
        for j in range(p):
            out[str(len(pl.head) + s * p + j)] = _index(blocks["scan"][str(j)], s)
    base = len(pl.head) + pl.n_super * p
    for i in range(len(pl.tail)):
        out[str(base + i)] = blocks["tail"][str(i)]
    return out


def _index(tree, s: int):
    if isinstance(tree, dict):
        return {k: _index(v, s) for k, v in tree.items()}
    return np.asarray(tree)[s]


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tensor_from_numpy(tree, device)


def params_from_reference(tree, cfg: ModelConfig, device="cuda", model=None):
    """The reference's parameter tree (numpy leaves) as the port's, on
    ``device``.  With ``model`` (an ``LM``), its parameters are overwritten
    in place with the carried values, and its tree is returned."""
    dev = resolve_device(device)
    out = dict(tree)
    out["blocks"] = _unstack(tree["blocks"], cfg)
    if cfg.tie_embeddings and "lm_head" in out:
        raise ValueError("tied embeddings: the reference tree has an lm_head")
    port = _to_device(out, dev)
    if model is None:
        return port
    mine = model.params
    if sorted(_paths(mine)) != sorted(_paths(port)):
        raise ValueError("the reference tree and the model's differ in keys")
    with torch.no_grad():
        for dst, src in zip(tree_leaves(mine), tree_leaves(port)):
            if dst.shape != src.shape:
                raise ValueError(f"shape {tuple(src.shape)} for a "
                                 f"{tuple(dst.shape)} parameter")
            dst.copy_(src)
    return mine


def opt_state_from_reference(state, cfg: ModelConfig, device="cuda"):
    """The reference's optimizer state (numpy leaves; ``m``, ``v`` and
    optionally ``ef``, each shaped like the parameters) as the port's."""
    return {k: params_from_reference(v, cfg, device) for k, v in state.items()}


def cache_from_reference(cache, cfg: ModelConfig, device="cuda"):
    """The reference's cache tree (numpy leaves) as the port's."""
    return _to_device(_unstack(cache, cfg), resolve_device(device))


def _paths(tree, prefix: Optional[str] = None):
    if not isinstance(tree, dict):
        return [prefix]
    return [p for k, v in tree.items()
            for p in _paths(v, k if prefix is None else f"{prefix}.{k}")]
