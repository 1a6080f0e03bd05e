"""Backend-agnostic MapReduce job runtime (PyTorch port).

``job.py``          ``CountJob`` and ``JobProfile`` (the per-job profile schema).
``engine.py``       the counting core (one device, or a rank of a mesh with
                    its collectives) with the async double-buffered chunk
                    queue and the device-side Job1.
``runners.py``      ``BaseRunner``, ``SimRunner`` (the paper's Hadoop cost
                    model over the Java-equivalent structures, with an
                    optional thread or process pool), ``TorchRunner``
                    (one device) and ``ShardedRunner`` (a mesh of ranks).
``strategies.py``   the SPC, FPC and DPC level-wise schedulers.
``device_loop.py``  the device-resident level ladder (``device_loop=True``)
                    and the device-side SPC cut-back filter.
``cache.py``        the shared encoded-dataset cache (``DATASET_CACHE``).
``faults.py``       seeded fault injection (``FaultPlan``/``FaultSpec``) and
                    the Hadoop-style ``RetryPolicy`` of ``SimRunner``.
``sweep.py``        grid plumbing: ``aggregate_profiles``,
                    ``itemset_digest`` and ``run_parity_cell``.
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
    ladder,
)
from repro_torch.core.runtime.engine import (
    MapReduceEngine,
    PendingCounts,
    resolve_device,
)
from repro_torch.core.runtime.faults import (
    DeviceLostError,
    FaultPlan,
    FaultSpec,
    JobFailedError,
    MapperCrashError,
    PartialCorruptionError,
    RetryPolicy,
)
from repro_torch.core.runtime.runners import (
    BaseRunner,
    ShardedRunner,
    SimRunner,
    TorchRunner,
    make_runner,
)
from repro_torch.core.runtime.sweep import (
    CellResult,
    aggregate_profiles,
    itemset_digest,
    run_parity_cell,
)

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
    "ladder",
    "MapReduceEngine",
    "PendingCounts",
    "resolve_device",
    "DeviceLostError",
    "FaultPlan",
    "FaultSpec",
    "JobFailedError",
    "MapperCrashError",
    "PartialCorruptionError",
    "RetryPolicy",
    "BaseRunner",
    "ShardedRunner",
    "SimRunner",
    "TorchRunner",
    "make_runner",
    "CellResult",
    "aggregate_profiles",
    "itemset_digest",
    "run_parity_cell",
]
