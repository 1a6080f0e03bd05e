"""Layer-stack assembly (PyTorch port of the JAX package's
``models/transformer.py``).

The reference groups layers into an unrolled head, scanned super-blocks of
one pattern period (parameters stacked on a leading ``layers`` axis) and an
unrolled tail (``StackPlan``).  The port keeps ``plan`` but holds one tree
per layer, keyed by its index, and loops over them in Python: the layer
order is ``blocks.layer_kinds(cfg)``, which is head, then the pattern
``n_super`` times, then tail (``models/convert.py`` unstacks the reference's
``scan`` leaves into that order).

``stack_apply`` (the training forward) keeps the reference's remat units:
each head and tail layer alone, and each scanned super-block (one pattern
period: one layer for qwen2, two for gemma2) as one unit (``_remat``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.ctx import recompute_context
from repro_torch.models import blocks


@dataclasses.dataclass(frozen=True)
class StackPlan:
    head: List[Tuple[str, str]]      # unrolled leading layers
    pattern: List[Tuple[str, str]]   # one super-block period
    n_super: int                     # scanned super-blocks
    tail: List[Tuple[str, str]]      # unrolled trailing layers


def plan(cfg: ModelConfig) -> StackPlan:
    kinds = blocks.layer_kinds(cfg)
    p = len(cfg.pattern)
    n_head = cfg.moe.n_dense_layers if cfg.moe else 0
    assert n_head % p == 0 or p == 1, "dense head must align with the pattern"
    rest = cfg.n_layers - n_head
    n_super = rest // p if cfg.scan_layers else 0
    return StackPlan(
        head=kinds[:n_head],
        pattern=kinds[n_head : n_head + p] if n_super else [],
        n_super=n_super,
        tail=kinds[n_head + n_super * p :],
    )


def stacked_layers(cfg: ModelConfig) -> List[List[int]]:
    """The layer indices whose leaves the reference stacks into one
    ``scan`` leaf: one list per position in the pattern (empty when no
    layer is scanned).  A per-tensor rule of the reference (weight decay's
    rank, int8 compression's scale) sees each list as one tensor."""
    pl = plan(cfg)
    n_head, p = len(pl.head), len(pl.pattern)
    return [[n_head + u * p + j for u in range(pl.n_super)] for j in range(p)]


def stack_abstract(cfg: ModelConfig):
    return {str(i): blocks.layer_abstract(cfg, t, c)
            for i, (t, c) in enumerate(blocks.layer_kinds(cfg))}


_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_matmuls(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _MATMULS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_context():
    return create_selective_checkpoint_contexts(_save_matmuls)


def _remat(fn, cfg: ModelConfig):
    """``fn`` as one remat unit under ``cfg.remat``, when autograd records:

    - ``"none"``: no wrapping; backward keeps every activation;
    - ``"full"``: ``torch.utils.checkpoint`` keeps only the unit's inputs
      and recomputes the rest in backward (the reference's
      ``jax.checkpoint``, which saves only layer boundaries);
    - ``"dots"``: selective checkpointing that keeps the outputs of 2-D
      matmuls (``aten.mm``, ``aten.addmm``: every weight product) and
      recomputes the rest.  It stands in for
      ``checkpoint_dots_with_no_batch_dims``; as there, the attention's
      batched products (``aten.bmm``) are recomputed.  It differs where
      torch lowers a product otherwise than XLA: a ``dot_general`` with no
      batch dimension that torch runs as ``bmm`` is recomputed here.
    """
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    context_fn = recompute_context(
        _dots_context if cfg.remat == "dots" else None)
    if context_fn is None:
        return lambda *a: checkpoint(fn, *a, use_reentrant=False)
    return lambda *a: checkpoint(fn, *a, use_reentrant=False,
                                 context_fn=context_fn)


def stack_apply(params, x, cfg: ModelConfig, *, positions, vis_embeds=None):
    """Training/scoring forward. Returns (x, aux)."""
    pl = plan(cfg)
    kinds = blocks.layer_kinds(cfg)
    n_head, p = len(pl.head), len(pl.pattern)
    n_scan = pl.n_super * p
    # remat units: head layers one by one, super-blocks, tail layers.
    units = ([[i] for i in range(n_head)]
             + [list(range(n_head + u * p, n_head + (u + 1) * p))
                for u in range(pl.n_super)]
             + [[i] for i in range(n_head + n_scan, len(kinds))])

    def unit_fn(layers):
        def run(xx):
            au = torch.zeros((), dtype=torch.float32, device=xx.device)
            for i in layers:
                t, c = kinds[i]
                xx, a = blocks.layer_apply(
                    params[str(i)], xx, t, c, cfg,
                    positions=positions, vis_embeds=vis_embeds)
                au = au + a
            return xx, au
        return _remat(run, cfg)

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layers in units:
        x, a = unit_fn(layers)(x)
        aux = aux + a
    return x, aux


def cache_abstract(cfg: ModelConfig, batch: int, max_len: int):
    return {str(i): blocks.cache_abstract(cfg, t, batch, max_len)
            for i, (t, _) in enumerate(blocks.layer_kinds(cfg))}


def stack_prefill(params, x, cfg: ModelConfig, cache, *, positions, vis_embeds=None):
    for i, (t, c) in enumerate(blocks.layer_kinds(cfg)):
        x, cache[str(i)] = blocks.layer_prefill(
            params[str(i)], x, t, c, cfg, positions=positions,
            cache=cache[str(i)], vis_embeds=vis_embeds)
    return x, cache


def stack_decode(params, x, cfg: ModelConfig, cache, cache_len, *, positions):
    for i, (t, c) in enumerate(blocks.layer_kinds(cfg)):
        x, cache[str(i)] = blocks.layer_decode(
            params[str(i)], x, t, c, cfg, cache=cache[str(i)],
            cache_len=cache_len, positions=positions)
    return x, cache
