"""Backend-agnostic MapReduce job runtime (PyTorch port).

``job.py``          ``CountJob`` and ``JobProfile`` (the per-job profile schema).
``engine.py``       the single-device counting core with the async
                    double-buffered chunk queue and the device-side Job1.
``runners.py``      ``BaseRunner`` and ``TorchRunner`` (one device).
``strategies.py``   the SPC, FPC and DPC level-wise schedulers.
``device_loop.py``  the device-resident level ladder (``device_loop=True``)
                    and the device-side SPC cut-back filter.
``cache.py``        the shared encoded-dataset cache (``DATASET_CACHE``).
"""

from repro_torch.core.runtime.job import CountJob, JobProfile
from repro_torch.core.runtime.cache import (
    DATASET_CACHE,
    EncodedDatasetCache,
    dataset_digest,
)
from repro_torch.core.runtime.device_loop import (
    LevelLadder,
    apriori_gen_device,
    filter_candidates_device,
    join_pair_count,
)
from repro_torch.core.runtime.engine import (
    MapReduceEngine,
    PendingCounts,
    resolve_device,
)
from repro_torch.core.runtime.runners import BaseRunner, TorchRunner, make_runner

__all__ = [
    "CountJob",
    "JobProfile",
    "DATASET_CACHE",
    "EncodedDatasetCache",
    "dataset_digest",
    "LevelLadder",
    "apriori_gen_device",
    "filter_candidates_device",
    "join_pair_count",
    "MapReduceEngine",
    "PendingCounts",
    "resolve_device",
    "BaseRunner",
    "TorchRunner",
    "make_runner",
]
