"""Durable state for the port: atomic, self-validating level checkpoints
(``checkpoint.py``).  The multi-device mesh, elastic rebuild and multi-host
launcher of the JAX package are not ported yet."""

from repro_torch.distributed import checkpoint

__all__ = ["checkpoint"]
