"""Distributed state for the port: atomic, self-validating level
checkpoints (``checkpoint.py``), multi-host initialization over
``torch.distributed`` (``ctx.py``) and elastic recovery onto a smaller
mesh (``elastic.py``).  The LM's activation-sharding rules are not
ported."""

from repro_torch.distributed import checkpoint, ctx, elastic
from repro_torch.distributed.ctx import (
    MultihostSpec,
    fetch_global,
    initialize_multihost,
    multihost_env,
    process_count,
    process_index,
)

__all__ = [
    "checkpoint",
    "ctx",
    "elastic",
    "MultihostSpec",
    "fetch_global",
    "initialize_multihost",
    "multihost_env",
    "process_count",
    "process_index",
]
