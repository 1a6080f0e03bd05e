"""Distributed state for the port: atomic, self-validating level
checkpoints (``checkpoint.py``), multi-host initialization and the LM's
activation-sharding context over ``torch.distributed`` (``ctx.py``), the
LM's logical-axis sharding rules (``sharding.py``) and elastic recovery
onto a smaller mesh (``elastic.py``)."""

from repro_torch.distributed import checkpoint, ctx, elastic, sharding
from repro_torch.distributed.ctx import (
    MultihostSpec,
    fetch_global,
    initialize_multihost,
    multihost_env,
    process_count,
    process_index,
)
from repro_torch.distributed.sharding import (
    ShardingRules,
    act_pspec,
    batch_pspec,
    default_rules,
)

__all__ = [
    "checkpoint",
    "ctx",
    "elastic",
    "sharding",
    "MultihostSpec",
    "fetch_global",
    "initialize_multihost",
    "multihost_env",
    "process_count",
    "process_index",
    "ShardingRules",
    "default_rules",
    "batch_pspec",
    "act_pspec",
]
