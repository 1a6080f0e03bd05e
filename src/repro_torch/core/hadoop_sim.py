"""MapReduce Apriori driver over the paper's Java-equivalent structures.

A thin front-end over the job runtime: the Job1/Job2 mapper loops live in
``core.runtime.runners.SimRunner``, which executes the decomposition of
Algorithms 1-4 — per-mapper candidate generation + structure build + chunk
counting (Algorithm 3), per-mapper combiner, then the global reducer — on
host CPUs, with per-phase wall-clock measurement.  By default mappers run
sequentially but are timed individually; the reported parallel time of an
iteration is ``max(mapper times) + reduce time``, what an N-slot Hadoop
cluster would see.  ``executor="thread"`` or ``"process"`` runs them on a
real pool instead.  The saturation the paper observes (Fig 5) emerges
mechanically: every mapper re-runs apriori-gen and rebuilds C_k, a fixed
cost that parallelism cannot shrink.

``run_mapreduce_apriori`` drives ``SimRunner`` through the same
``FrequentItemsetMiner`` level loop (SPC strategy) as the device backends,
so both tracks emit the same per-job ``JobProfile`` rows.  The cluster model
holds no tensor and needs no device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

from repro_torch.core.itemsets import Itemset
from repro_torch.core.runtime import JobProfile, SimRunner
from repro_torch.core.sequential import SEQUENTIAL_STORES

# Back-compat alias: per-iteration stats are the unified JobProfile.
IterationProfile = JobProfile


@dataclasses.dataclass
class HadoopSimResult:
    structure: str
    n_mappers: int
    min_count: int
    iterations: List[JobProfile]
    itemsets: Dict[Itemset, int]

    @property
    def parallel_seconds(self) -> float:
        return sum(it.parallel_seconds for it in self.iterations)

    @property
    def sequential_seconds(self) -> float:
        return sum(it.sequential_seconds for it in self.iterations)


def run_mapreduce_apriori(
    transactions: Sequence[Sequence[int]],
    min_support: float,
    structure: str = "trie",
    n_mappers: int = 4,
    max_k: int = 16,
    child_max_size: int = 20,
    executor=None,
) -> HadoopSimResult:
    """``executor`` (None | "thread" | "process" | Executor) runs the
    mappers concurrently instead of the sequential timed simulation — see
    ``SimRunner``; counts are identical either way."""
    if structure not in SEQUENTIAL_STORES:
        raise ValueError(f"unknown structure {structure!r}")
    from repro_torch.core.miner import FrequentItemsetMiner

    runner = SimRunner(structure=structure, n_mappers=n_mappers,
                       child_max_size=child_max_size, executor=executor)
    try:
        res = FrequentItemsetMiner(
            min_support=min_support, strategy="spc", max_k=max_k,
            runner=runner,
        ).mine(transactions)
    finally:
        runner.close()
    return HadoopSimResult(
        structure=structure, n_mappers=n_mappers, min_count=res.min_count,
        iterations=res.levels, itemsets=res.itemsets,
    )
