"""MapReduce Apriori with pluggable candidate stores, on PyTorch.

Drivers (``FrequentItemsetMiner``, ``run_mapreduce_apriori``) submit jobs
to runners: ``SimRunner`` (the paper's Hadoop cost model),
``TorchRunner`` (one device) or ``ShardedRunner`` (a mesh of
``torch.distributed`` ranks), which report through one ``JobProfile``
schema.
"""

from repro_torch.core.itemsets import apriori_gen, brute_force_frequent
from repro_torch.core.miner import FrequentItemsetMiner, MiningResult
from repro_torch.core.runtime import (
    CountJob,
    JobProfile,
    MapReduceEngine,
    ShardedRunner,
    SimRunner,
    TorchRunner,
)
from repro_torch.core.hadoop_sim import HadoopSimResult, run_mapreduce_apriori

__all__ = [
    "FrequentItemsetMiner",
    "MiningResult",
    "MapReduceEngine",
    "CountJob",
    "JobProfile",
    "ShardedRunner",
    "SimRunner",
    "TorchRunner",
    "HadoopSimResult",
    "apriori_gen",
    "brute_force_frequent",
    "run_mapreduce_apriori",
]
