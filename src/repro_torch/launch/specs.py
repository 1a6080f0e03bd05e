"""Stand-ins for every model input, with no memory (PyTorch port of the JAX
package's ``launch/specs.py``).

``input_specs(cfg, shape, mesh, rules)`` returns the argument tree the
step function of that shape takes:

  train    -> {"tokens", "labels"} (+ modality inputs)
  prefill  -> {"tokens"} (+ modality inputs) and a zeroed cache tree
  decode   -> {"tokens": (B,1)}, cache tree, cache_len scalar

Each leaf is ``models.params.shape_structs``': without a mesh a meta
tensor of the global shape, with one a ``ShapeStruct`` (the global meta
tensor, its spec and one rank's shard).  The reference's scalar stand-ins
(``cache_len``, the train step's ``step``) are 0-d int32 tensors holding a
value, since the port's decode step reads the cache length as a number.
The port holds one cache tree per layer where the reference stacks the
scanned layers.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import LM_SHAPES, ModelConfig, ShapeConfig
from repro_torch.distributed.sharding import ShardingRules
from repro_torch.models import model as M
from repro_torch.models.params import shape_structs, spec


def _rules_of(mesh, rules: Optional[ShardingRules]):
    return rules.rules if mesh is not None else None


def _sds(shape, dtype, mesh, rules: ShardingRules, axes):
    return shape_structs(spec(shape, axes, dtype=dtype), mesh,
                         _rules_of(mesh, rules))


def scalar(value: int) -> torch.Tensor:
    """A 0-d int32 scalar input (the reference's ``ShapeDtypeStruct((),
    int32)``), holding ``value``."""
    return torch.tensor(int(value), dtype=torch.int32)


def batch_specs(cfg: ModelConfig, sh: ShapeConfig, mesh,
                rules: ShardingRules):
    b = sh.global_batch
    s = sh.seq_len if sh.kind != "decode" else 1
    out = {}
    if cfg.frontend == "audio_frames":
        out["frames"] = _sds((b, sh.seq_len if sh.kind != "decode" else 1,
                              cfg.d_model), torch.bfloat16, mesh, rules,
                             ("batch", None, None))
    else:
        out["tokens"] = _sds((b, s), torch.int32, mesh, rules,
                             ("batch", None))
    if sh.kind == "train":
        out["labels"] = _sds((b, s), torch.int32, mesh, rules,
                             ("batch", None))
    if cfg.frontend == "vision_patches" and sh.kind != "decode":
        out["vis_embeds"] = _sds((b, cfg.n_vis_tokens, cfg.d_model),
                                 torch.bfloat16, mesh, rules,
                                 ("batch", None, None))
    return out


def cache_specs(cfg: ModelConfig, sh: ShapeConfig, mesh, rules: ShardingRules):
    ab = M.abstract_cache(cfg, sh.global_batch, sh.seq_len)
    return shape_structs(ab, mesh, _rules_of(mesh, rules))


def param_specs(cfg: ModelConfig, mesh, rules: ShardingRules):
    return shape_structs(M.abstract_params(cfg), mesh, _rules_of(mesh, rules))


def input_specs(cfg: ModelConfig, shape_name: str, mesh, rules: ShardingRules):
    """Full argument tree for the step function of this shape."""
    sh = LM_SHAPES[shape_name]
    batch = batch_specs(cfg, sh, mesh, rules)
    if sh.kind == "train":
        return {"batch": batch}
    if sh.kind == "prefill":
        return {"batch": batch, "cache": cache_specs(cfg, sh, mesh, rules)}
    return {
        "batch": batch,
        "cache": cache_specs(cfg, sh, mesh, rules),
        "cache_len": scalar(sh.seq_len),
    }
