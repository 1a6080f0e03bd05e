"""Job spec and the unified per-job profile schema (PyTorch port: the same
fields as the JAX package's ``core/runtime/job.py``, so
``dataclasses.asdict`` rows compare one to one).

``JobProfile`` replaces both of the repo's historical profiling dataclasses
(``hadoop_sim.IterationProfile`` and ``miner.LevelStats``): every runner —
the Hadoop cost-model simulator and the device backends alike — reports one row
per counting job through this schema, so ``benchmarks/`` can put the
Java-equivalent and array-store paths side by side in one table.

Phase fields (seconds; a backend leaves phases it does not have at 0.0):

====================  ====================================================
``gen_seconds``       candidate generation (host ``apriori_gen_matrix``,
                      or max-over-mappers apriori-gen in the simulator)
``build_seconds``     candidate-structure build (max-over-mappers tree /
                      trie construction in the simulator)
``encode_seconds``    host->device candidate encode + dispatch (device
                      runners), with the waits on earlier chunks' results
                      that the dispatch queue's depth forces
``count_seconds``     mapper counting: device wait (device runners) or
                      max-over-mappers transaction scan (simulator)
``reduce_seconds``    reducer: partial-count merge (simulator) or
                      host-side threshold/fetch bookkeeping (device runners)
====================  ====================================================

``mapper_seconds`` keeps the simulator's per-mapper wall clocks so its
max-mapper parallel-time model (``parallel_seconds``) survives unification;
device jobs leave it empty, making ``parallel_seconds == seconds``.  When the
simulator runs its mappers on a real executor pool, ``seconds`` is measured
concurrent wall time and ``parallel_seconds`` stays the model — comparing
the two per job validates the ``max(mappers) + reduce`` cost model.

``inflight_depth`` records the async dispatch queue depth the engine-backed
runners actually ran with — the auto-sized depth when the engine was built
with ``inflight=None``; 0 on runners without a dispatch queue (simulator).
``inflight_retunes`` is the engine's cumulative count of mid-run depth
re-tunes (``inflight=None`` re-samples the depth when a wave's *per-chunk*
(C, k) work — min(C, cand_block) * k — drifts more than 2x from the shape
it was tuned on); 0 when auto-sizing is off or no wave ever drifted.

Fault-tolerance telemetry (all zero on a clean run with recovery enabled —
the fields record what the recovery layer *did*, not what it cost):
``retries`` counts failed task attempts that were re-run (crashes and
digest-failed partials), ``speculative_launches`` backup copies launched
against stragglers, ``speculative_wins`` tasks whose backup finished first
(the original's duplicate result was discarded), and ``backoff_seconds``
the cumulative retry backoff the job waited out.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class JobProfile:
    k: int                      # (top) level the job counted
    n_candidates: int = 0
    n_frequent: int = 0
    seconds: float = 0.0        # total job wall-clock as the driver saw it
    gen_seconds: float = 0.0
    build_seconds: float = 0.0
    encode_seconds: float = 0.0
    count_seconds: float = 0.0
    reduce_seconds: float = 0.0
    mapper_seconds: List[float] = dataclasses.field(default_factory=list)
    inflight_depth: int = 0     # effective async queue depth (engine runners)
    inflight_retunes: int = 0   # cumulative mid-run depth re-tunes (auto mode)
    retries: int = 0            # failed task attempts that were re-run
    speculative_launches: int = 0   # straggler backup copies launched
    speculative_wins: int = 0   # tasks whose backup finished first
    backoff_seconds: float = 0.0    # cumulative retry backoff waited
    # Device-resident ladder telemetry: the padded transaction count and item
    # columns the level was counted over (shrinks per level with trimming;
    # 0 on the host-loop paths, which never resize the placed DB).
    n_pad: int = 0
    f_pad: int = 0
    # Out-of-core telemetry: transaction chunks the job streamed through
    # (ChunkedDatasetReader ingestion); 0 on the resident-DB paths.
    chunks: int = 0

    @property
    def parallel_seconds(self) -> float:
        """Simulated-cluster time: max mapper + reduce (the paper's model).

        Backends without per-mapper timing report their wall clock."""
        if self.mapper_seconds:
            return max(self.mapper_seconds) + self.reduce_seconds
        return self.seconds

    @property
    def sequential_seconds(self) -> float:
        if self.mapper_seconds:
            return sum(self.mapper_seconds) + self.reduce_seconds
        return self.seconds


@dataclasses.dataclass
class CountJob:
    """One counting job: count every row of ``cand`` over the placed DB.

    ``cand``      (C, k) int32 candidate matrix in dense item ids, rows in
                  lexicographic order (the canonical level-matrix form).
    ``min_count`` the job's support threshold, carried for bookkeeping (a
                  runner may log or shard by it). Runners return *raw* global
                  counts for every candidate row — thresholding is the
                  strategy's reduce step, never per-mapper (a local pre-filter
                  at min_count would drop itemsets whose partial counts are
                  individually small but globally frequent).
    ``level``     optional (L, k-1) frequent-level matrix the wave was
                  generated from.  The simulator uses it to re-run
                  apriori-gen + structure build *inside every mapper* — the
                  per-iteration fixed cost the paper measures.  Speculative
                  waves (FPC/DPC tails) carry ``level=None`` and the
                  structure is built from ``cand`` directly.
    """

    k: int
    cand: np.ndarray
    min_count: int = 1
    level: Optional[np.ndarray] = None

    @property
    def n_candidates(self) -> int:
        return int(self.cand.shape[0]) if self.cand.size else 0
