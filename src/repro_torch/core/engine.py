"""Back-compat shim: the counting engine lives in the job runtime.

``MapReduceEngine`` (the single-device counting core with the async
double-buffered wave dispatch and the device-side Job1) is in
``repro_torch.core.runtime.engine``.  Import from there in new code.
"""

from repro_torch.core.runtime.engine import MapReduceEngine, PendingCounts

__all__ = ["MapReduceEngine", "PendingCounts"]
