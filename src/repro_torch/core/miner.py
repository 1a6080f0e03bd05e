"""User-facing frequent-itemset miner: the paper's Driver (Algorithm 1).

The PyTorch counterpart of the JAX package's ``core/miner.py``.
``FrequentItemsetMiner`` is a thin driver over the job runtime: it ingests
the database into a runner, submits Job1 (the 1-itemset histogram),
dense-remaps over the frequent items, and iterates a strategy, which owns
the per-level counting jobs.  It takes the JAX miner's arguments plus
``device`` (default ``"cuda"``; a CUDA-less machine raises unless the caller
asks for ``"cpu"``).  ``mine`` also takes a ``ChunkedDatasetReader``, which
streams every job through fixed-size transaction chunks (``device_loop``
must then stay False).  ``device_loop=True`` runs the SPC levels as the
device-resident ladder (``runtime/device_loop.py``), trimming the DB per
level when ``trim``.  The mesh, candidate sharding, per-level checkpoints
and caller-supplied runners are not ported yet and raise
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.itemsets import Itemset
from repro_torch.core.runtime import device_loop as _dl
from repro_torch.core.runtime import strategies
from repro_torch.core.runtime.engine import resolve_device
from repro_torch.core.runtime.job import JobProfile
from repro_torch.core.runtime.runners import BaseRunner, make_runner

# Distinguishes "inflight not configured" (default depth 1) from an explicit
# inflight=None, which means auto-size the queue depth (engine semantics).
_UNSET = object()


@dataclasses.dataclass
class MiningResult:
    itemsets: Dict[Itemset, int]          # frequent itemset -> global support count
    min_count: int
    n_transactions: int
    levels: List[JobProfile]
    item_map: np.ndarray                  # dense id -> original item id

    def frequent_at(self, k: int) -> Dict[Itemset, int]:
        return {s: c for s, c in self.itemsets.items() if len(s) == k}

    @property
    def max_k(self) -> int:
        return max((len(s) for s in self.itemsets), default=0)


class FrequentItemsetMiner:
    def __init__(
        self,
        min_support: float = 0.01,
        store: Optional[str] = None,
        strategy: str = "spc",
        mesh=None,
        data_axes: Optional[Tuple[str, ...]] = None,
        cand_axes: Optional[Tuple[str, ...]] = None,
        max_k: int = 16,
        block_n: Optional[int] = None,
        cand_block: Optional[int] = None,
        inflight=_UNSET,
        encode_ahead: Optional[int] = None,
        checkpoint_dir: Optional[str] = None,
        runner: Optional[BaseRunner] = None,
        elastic_restarts: int = 2,
        device_loop: bool = False,
        trim: bool = True,
        device="cuda",
    ) -> None:
        for given, what in ((mesh is not None, "mesh"),
                            (bool(cand_axes), "cand_axes"),
                            (data_axes not in (None, ("data",)), "data_axes"),
                            (checkpoint_dir is not None, "checkpoint_dir"),
                            (runner is not None, "runner=")):
            if given:
                raise NotImplementedError(f"{what} is not yet ported")
        self.min_support = min_support
        self.store = store if store is not None else "perfect_hash"
        self.strategy = strategy
        self.max_k = max_k
        self.block_n = block_n if block_n is not None else 2048
        self.cand_block = cand_block if cand_block is not None else 32_768
        # inflight=None passes through to the engine as "auto-size the
        # async queue depth"; unset means the fixed default of 1.
        self.inflight = 1 if inflight is _UNSET else inflight
        self.encode_ahead = encode_ahead if encode_ahead is not None else 2
        if device_loop and strategy != "spc":
            # The ladder *is* the SPC schedule fused on the device: FPC/DPC's
            # speculative combined waves have no fused counterpart.
            raise ValueError(
                "device_loop=True fuses the SPC level loop on the device; "
                f"it cannot run the {strategy!r} strategy")
        self.device_loop = device_loop
        self.trim = trim
        # elastic_restarts acts only with a mesh, refused above; it is
        # accepted for the same signature.
        self.device = resolve_device(device)

    def _make_runner(self) -> BaseRunner:
        return make_runner(store=self.store, block_n=self.block_n,
                           cand_block=self.cand_block, inflight=self.inflight,
                           encode_ahead=self.encode_ahead, device=self.device)

    def mine(self, transactions: Sequence[Sequence[int]]) -> MiningResult:
        """Mine the frequent itemsets of ``transactions`` (lists of item
        ids, or a ``ChunkedDatasetReader`` to mine a ``.dat`` out of core)
        at ``min_support``: itemsets in original ids with their supports,
        and one ``JobProfile`` per counting job."""
        n = len(transactions)
        min_count = max(1, int(np.ceil(self.min_support * n)))
        with self._make_runner() as runner:
            self.active_runner = runner  # introspection: tests/benchmarks
            return self._mine_once(runner, transactions, n, min_count)

    def _mine_once(self, runner: BaseRunner, transactions, n: int,
                   min_count: int) -> MiningResult:
        runner.ingest(transactions)
        # Job1: frequent 1-itemsets over the raw item universe.
        hist, prof1 = runner.job1()
        frequent_items = np.nonzero(hist >= min_count)[0]
        item_map = frequent_items.astype(np.int64)  # dense id -> original id
        itemsets: Dict[Itemset, int] = {
            (int(it),): int(hist[it]) for it in frequent_items
        }
        prof1.n_frequent = len(frequent_items)
        levels = [prof1]
        # L1 in dense ids is simply 0..F-1, one item per row.
        level_mat = np.arange(len(item_map), dtype=np.int32).reshape(-1, 1)

        # Dense re-encode over frequent items only (Apriori property: no
        # candidate may contain an infrequent item) and make the DB resident.
        runner.place(item_map)
        if self.device_loop:
            combiner = functools.partial(_dl.ladder, trim=self.trim)
        else:
            combiner = strategies.get(self.strategy)
        for stats, freq_dense in combiner(
            runner, level_mat, min_count, start_k=2, max_k=self.max_k
        ):
            levels.append(stats)
            for s, c in freq_dense.items():
                itemsets[tuple(int(item_map[i]) for i in s)] = int(c)

        return MiningResult(
            itemsets=itemsets, min_count=min_count, n_transactions=n,
            levels=levels, item_map=item_map,
        )
