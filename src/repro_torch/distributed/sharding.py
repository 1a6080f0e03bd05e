"""Logical-axis sharding rules (MaxText-style) for the production meshes
(PyTorch port of the JAX package's ``distributed/sharding.py``).

Mesh axes (the ``mesh_dim_names`` of a ``DeviceMesh`` of ranks):
  pod    — outermost DP axis across pods (multi-pod mesh only)
  data   — within-pod DP / FSDP axis
  model  — tensor/expert-parallel axis

Logical names used by the model code:

  batch     activation batch dim            -> (pod, data)
  fsdp      parameter ZeRO shard dim        -> (pod, data)
  heads     attention heads / q-proj out    -> model
  kv_heads  kv heads                        -> model
  mlp       FFN hidden                      -> model
  vocab     embedding rows / logits         -> model
  experts   MoE expert dim                  -> model
  embed     d_model                         -> None (replicated; FSDP takes
            the other dim of every matrix, so nothing is fully replicated)
  seq       sequence dim of activations     -> None (context-parallel opt-in)
  cache_seq KV-cache sequence dim           -> None
  layers    scan/stack dim                  -> None

A spec is a plain tuple with one entry per tensor dimension: ``None``, a
mesh axis name or a tuple of names (``models.params.logical_to_pspec``);
``models.params.placements`` turns it into DTensor placements.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    rules: dict

    def pspec(self, axes) -> tuple:
        # imported here: models imports the runtime, which imports this
        # package
        from repro_torch.models.params import logical_to_pspec

        return logical_to_pspec(axes, self.rules)

    def with_overrides(self, **kv) -> "ShardingRules":
        new = dict(self.rules)
        new.update(kv)
        return ShardingRules(new)


def default_rules(multi_pod: bool = False, *, fsdp: bool = True,
                  context_parallel: bool = False) -> ShardingRules:
    dp: Tuple[str, ...] = ("pod", "data") if multi_pod else ("data",)
    rules = {
        "batch": dp,
        "fsdp": dp if fsdp else None,
        "heads": "model",
        "kv_heads": "model",
        "mlp": "model",
        "vocab": "model",
        # EP degree = model axis (the reference found that extending
        # experts over the data axes gathers the whole dispatch tensor).
        "experts": "model",
        "embed": None,
        "embed_tp": "model",   # alternative: shard d_model itself (decode TP)
        "seq": dp if context_parallel else None,
        # KV caches shard their sequence dim over the model axis: kv_heads
        # rarely divide a 16-way axis, and an unsharded long cache
        # replicates on every rank.
        "cache_seq": "model",
        "layers": None,
        "state": "model",      # SSM / RG-LRU recurrent width
        # Flash-tile fallback chain: when neither kv_heads nor the group dim
        # divides the model axis, the q-chunk dim carries it instead.
        "attn_q": "model",
    }
    return ShardingRules(rules)


def batch_pspec(rules: ShardingRules) -> tuple:
    return rules.pspec(("batch", None))


def act_pspec(rules: ShardingRules, *axes) -> tuple:
    return rules.pspec(axes)
