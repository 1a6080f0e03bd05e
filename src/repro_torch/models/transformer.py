"""Layer-stack assembly (PyTorch port of the JAX package's
``models/transformer.py``).

The reference groups layers into an unrolled head, scanned super-blocks of
one pattern period (parameters stacked on a leading ``layers`` axis) and an
unrolled tail (``StackPlan``).  The port keeps ``plan`` but holds one tree
per layer, keyed by its index, and loops over them in Python: the layer
order is ``blocks.layer_kinds(cfg)``, which is head, then the pattern
``n_super`` times, then tail (``models/convert.py`` unstacks the reference's
``scan`` leaves into that order).  Remat is a training concern and waits
for the training slice.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch

from repro_torch.configs.base import ModelConfig
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


def stack_abstract(cfg: ModelConfig):
    return {str(i): blocks.layer_abstract(cfg, t, c)
            for i, (t, c) in enumerate(blocks.layer_kinds(cfg))}


def stack_apply(params, x, cfg: ModelConfig, *, positions, vis_embeds=None):
    """Scoring forward. Returns (x, aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, (t, c) in enumerate(blocks.layer_kinds(cfg)):
        x, a = blocks.layer_apply(params[str(i)], x, t, c, cfg,
                                  positions=positions, vis_embeds=vis_embeds)
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
