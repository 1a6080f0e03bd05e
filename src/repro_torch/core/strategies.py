"""Back-compat shim: strategies live in the job runtime.

The SPC/FPC/DPC wave schedulers are in
``repro_torch.core.runtime.strategies`` (threaded through the runners'
pipelined ``count_async`` API).  Import from there in new code.
"""

from repro_torch.core.runtime.strategies import (  # noqa: F401
    dpc,
    fpc,
    get,
    spc,
)

__all__ = ["spc", "fpc", "dpc", "get"]
