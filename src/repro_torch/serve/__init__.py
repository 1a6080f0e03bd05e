"""Serving layer: the streaming frequent-itemset ``MiningService``
(PyTorch port of the JAX package's ``serve``).

The JAX package also resolves ``ServeEngine``, the LM decode engine, from
its model stack; the LM scaffolding is not ported, so asking for it here
raises ``AttributeError``.
"""

from repro_torch.serve.engine import (
    ErrorCertificate,
    IngestReport,
    MiningService,
    ServeResult,
)

__all__ = ["MiningService", "ServeResult", "IngestReport", "ErrorCertificate"]


def __getattr__(name):
    if name == "ServeEngine":
        raise AttributeError(
            "ServeEngine belongs to the LM scaffolding, which repro_torch has "
            "not ported yet (ROADMAP queue item 10)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
