"""Serving layer: the streaming frequent-itemset ``MiningService``
(PyTorch port of the JAX package's ``serve``).

``ServeEngine``, the LM decode engine, lives in ``repro_torch.serve.lm``
and is imported lazily, as in the reference, so the mining path never pulls
in the model stack.
"""

from repro_torch.serve.engine import (
    ErrorCertificate,
    IngestReport,
    MiningService,
    ServeResult,
)

__all__ = ["MiningService", "ServeResult", "IngestReport",
           "ErrorCertificate", "ServeEngine"]


def __getattr__(name):
    if name == "ServeEngine":
        from repro_torch.serve.lm import ServeEngine

        return ServeEngine
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
