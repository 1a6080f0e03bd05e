"""MapReduce Apriori with pluggable candidate stores, on PyTorch."""

from repro_torch.core.itemsets import apriori_gen, brute_force_frequent
from repro_torch.core.miner import FrequentItemsetMiner, MiningResult
from repro_torch.core.runtime import (
    CountJob,
    JobProfile,
    MapReduceEngine,
    TorchRunner,
)

__all__ = [
    "FrequentItemsetMiner",
    "MiningResult",
    "MapReduceEngine",
    "CountJob",
    "JobProfile",
    "TorchRunner",
    "apriori_gen",
    "brute_force_frequent",
]
