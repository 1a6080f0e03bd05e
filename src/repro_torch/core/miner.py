"""User-facing frequent-itemset miner: the paper's Driver (Algorithm 1).

The PyTorch counterpart of the JAX package's ``core/miner.py``.
``FrequentItemsetMiner`` is a thin driver over the job runtime: it ingests
the database into a runner, submits Job1 (the 1-itemset histogram),
dense-remaps over the frequent items, and iterates a strategy, which owns
the per-level counting jobs — checkpointing after every counting job when
``checkpoint_dir`` is set, so a preempted mine resumes at the last
completed level (the Hadoop analogue: completed jobs are never re-run).

Per-level checkpoints ride the snapshot store (``distributed.checkpoint``):
one atomic, digest-stamped snapshot per completed level, so torn writes are
ignored, bit rot is detected and quarantined, and a corrupt newest level
falls back to the previous one.  On ``DeviceLostError`` (a ``device_loss``
fault of the runner's ``FaultPlan``) a mesh runner is rebuilt on the ranks
that survive (``_elastic_rebuild``) and the mine resumes from the last
level checkpoint; the lost ranks leave ``mine()`` with the error.  On one
device there is nothing to rebuild onto, so the error propagates after the
runner's outstanding work is abandoned; a new miner with the same
``checkpoint_dir`` on a fresh runner resumes.  Either way the itemsets AND
supports equal a fault-free run's.

Any runner works (``runner=``): ``TorchRunner`` (array-layout stores on the
card), ``ShardedRunner`` (the same over a mesh of ranks; built here from
``mesh=``, ``data_axes=``, ``cand_axes=``) or ``SimRunner`` (the paper's
Hadoop cost model over the Java-equivalent structures); all report the same
``JobProfile`` rows.  It takes the JAX miner's arguments plus ``device``
(default: the mesh's device type, else ``"cuda"``; a CUDA-less machine
raises unless the caller asks for ``"cpu"``).  ``mine``
also takes a ``ChunkedDatasetReader``, which streams every job through
fixed-size transaction chunks (``device_loop`` must then stay False).
``device_loop=True`` runs the SPC levels as the device-resident ladder
(``runtime/device_loop.py``), trimming the DB per level when ``trim``.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.itemsets import Itemset, level_to_matrix, sort_level
from repro_torch.core.runtime import device_loop as _dl
from repro_torch.core.runtime import strategies
from repro_torch.core.runtime.engine import resolve_device
from repro_torch.core.runtime.faults import DeviceLostError
from repro_torch.core.runtime.job import JobProfile
from repro_torch.core.runtime.runners import BaseRunner, make_runner

# Back-compat alias: the old per-level stats type is the unified JobProfile.
LevelStats = JobProfile

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
        device=None,
    ) -> None:
        if runner is not None and (
            any(v is not None
                for v in (store, mesh, data_axes, cand_axes, block_n,
                          cand_block, encode_ahead))
            or inflight is not _UNSET
        ):
            # An explicit runner owns its backend config; silently ignoring
            # these would mine with a different setup than requested.
            raise ValueError(
                "pass backend config either through runner= or through "
                "store/mesh/data_axes/cand_axes/block_n/cand_block/"
                "inflight/encode_ahead — not both")
        self.min_support = min_support
        self.store = store if store is not None else "perfect_hash"
        self.strategy = strategy
        self.mesh = mesh
        self.data_axes = data_axes if data_axes is not None else ("data",)
        self.cand_axes = cand_axes if cand_axes is not None else ()
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
        self.checkpoint_dir = checkpoint_dir
        self.runner = runner
        # How many device losses a single mine() survives before giving up
        # (each one rebuilds a smaller mesh and resumes).
        self.elastic_restarts = elastic_restarts
        # A caller-supplied runner carries its own device (a SimRunner has
        # none), so only a runner built here needs a usable one; with a
        # mesh it is the mesh's.
        if device is None:
            device = mesh.device_type if mesh is not None else "cuda"
        self.device = resolve_device(device) if runner is None else None

    def _make_runner(self) -> BaseRunner:
        if self.runner is not None:
            return self.runner
        return make_runner(store=self.store, mesh=self.mesh,
                           data_axes=self.data_axes, cand_axes=self.cand_axes,
                           block_n=self.block_n, cand_block=self.cand_block,
                           inflight=self.inflight,
                           encode_ahead=self.encode_ahead, device=self.device)

    def _config(self, runner: BaseRunner) -> dict:
        """The run configuration stamped into checkpoints; a checkpoint from
        a different config must never silently resume this run.  The stamp
        uses ``config_signature()`` (not ``describe()``), so a resume with
        other mapper slots or block sizes still matches."""
        return {"runner": runner.config_signature(),
                "strategy": self.strategy, "max_k": self.max_k,
                "device_loop": bool(self.device_loop),
                "trim": bool(self.device_loop and self.trim)}

    def mine(self, transactions: Sequence[Sequence[int]]) -> MiningResult:
        """Mine the frequent itemsets of ``transactions`` (lists of item
        ids, or a ``ChunkedDatasetReader`` to mine a ``.dat`` out of core)
        at ``min_support``: itemsets in original ids with their supports,
        and one ``JobProfile`` per counting job.

        On ``DeviceLostError`` the runner is closed (its outstanding work
        abandoned) and a mesh runner is rebuilt on the surviving ranks,
        which re-enter the mining loop (restoring the last level checkpoint
        when ``checkpoint_dir`` is set, recomputing otherwise); see
        ``_elastic_rebuild``.  A runner this miner built is closed when the
        mine ends; a caller-supplied one stays open for its caller.
        """
        n = len(transactions)
        min_count = max(1, int(np.ceil(self.min_support * n)))
        runner = self._make_runner()
        restarts = 0
        try:
            while True:
                self.active_runner = runner  # introspection: tests
                try:
                    return self._mine_once(runner, transactions, n, min_count)
                except DeviceLostError as err:
                    restarts += 1
                    runner.close(wait=False)
                    if restarts > self.elastic_restarts:
                        raise
                    runner = self._elastic_rebuild(runner, err)
        finally:
            if self.runner is None:
                runner.close()

    def _elastic_rebuild(self, runner: BaseRunner,
                         err: DeviceLostError) -> BaseRunner:
        """A replacement runner on the largest mesh the surviving ranks
        support (the tail of the rank grid is lost).

        Building the survivors' groups is collective over the whole world,
        so every rank takes part, the lost ones included; a lost rank then
        re-raises: it *is* the lost device.  Only rank 0 writes checkpoints
        and it always survives; every level ends in a barrier after its
        snapshot (``_mine_once``), so the survivors restore what rank 0
        wrote.  One device, a simulated runner, or a mesh that does not
        span the world (an earlier loss already shed ranks, which cannot
        join new groups) re-raise.
        """
        engine = getattr(runner, "engine", None)
        if engine is None or engine.mesh is None:
            raise err  # nothing to shrink: single-device or simulated runner
        import torch.distributed as dist

        from repro_torch.core.runtime.runners import ShardedRunner
        from repro_torch.distributed import elastic

        if engine.mesh.mesh.numel() != dist.get_world_size():
            raise err
        survivors = elastic.surviving_devices(engine.mesh, err.lost)
        if not survivors:
            raise err
        mesh = elastic.elastic_data_cand_mesh(
            survivors, want_cand=bool(engine.cand_axes),
            device=engine.mesh.device_type)
        if mesh.get_coordinate() is None:
            raise err  # this rank was lost
        return ShardedRunner(
            store=engine.store_name, mesh=mesh, data_axes=("data",),
            cand_axes=("cand",) if engine.cand_axes else (),
            block_n=engine.block_n, cand_block=engine.cand_block,
            inflight=None if engine.inflight_auto else engine.inflight,
            encode_ahead=engine.encode_ahead,
            fault_plan=getattr(runner, "fault_plan", None))

    def _mine_once(self, runner: BaseRunner, transactions, n: int,
                   min_count: int) -> MiningResult:
        # Ingest before the restore: a resumed runner still needs the DB to
        # place() it.
        runner.ingest(transactions)

        state = self._try_restore(n, min_count, self._config(runner))
        if state is None:
            # Job1: frequent 1-itemsets over the raw item universe.
            hist, prof1 = runner.job1()
            frequent_items = np.nonzero(hist >= min_count)[0]
            item_map = frequent_items.astype(np.int64)  # dense id -> original
            itemsets: Dict[Itemset, int] = {
                (int(it),): int(hist[it]) for it in frequent_items
            }
            prof1.n_frequent = len(frequent_items)
            levels = [prof1]
            # L1 in dense ids is simply 0..F-1, one item per row.
            level_mat = np.arange(len(item_map), dtype=np.int32).reshape(-1, 1)
            k = 2
        else:
            itemsets, levels, level, k, item_map = state
            level_mat = level_to_matrix(level)

        # Dense re-encode over frequent items only (Apriori property: no
        # candidate may contain an infrequent item) and make the DB resident.
        runner.place(item_map)
        if self.device_loop:
            combiner = functools.partial(_dl.ladder, trim=self.trim)
        else:
            combiner = strategies.get(self.strategy)
        for stats, freq_dense in combiner(
            runner, level_mat, min_count, start_k=k, max_k=self.max_k
        ):
            levels.append(stats)
            for s, c in freq_dense.items():
                itemsets[tuple(int(item_map[i]) for i in s)] = int(c)
            # A combined (FPC/DPC) wave yields mixed itemset sizes; the next
            # level the strategy continues from — and the only thing a
            # restore may rebuild into a (C, k) matrix — is the top-k slice.
            top_k = max((len(s) for s in freq_dense), default=0)
            level = sort_level(s for s in freq_dense if len(s) == top_k)
            self._checkpoint(itemsets, levels, level, stats.k + 1, item_map,
                             n, min_count, self._config(runner),
                             fault_plan=getattr(runner, "fault_plan", None))
            engine = getattr(runner, "engine", None)
            if self.checkpoint_dir is not None and engine is not None:
                # Only rank 0 writes: no rank goes on to the next level
                # (where it may die) before the snapshot is on disk.
                engine.barrier()

        return MiningResult(
            itemsets=itemsets, min_count=min_count, n_transactions=n,
            levels=levels, item_map=item_map,
        )

    # -- fault tolerance ------------------------------------------------
    # Per-level state rides the snapshot store (``distributed.checkpoint``):
    # one digest-stamped snapshot per completed level keyed by
    # ``step=next_k``, the item_map as the tensor tree and everything else
    # JSON-packed in the manifest's ``extra``, in the JAX miner's format.

    def _checkpoint(self, itemsets, levels, level, next_k, item_map, n,
                    min_count, config, fault_plan=None):
        if self.checkpoint_dir is None:
            return
        from repro_torch.distributed import checkpoint as ckpt

        # ``level`` arrives in dense ids; persist original ids so a restart
        # (which recomputes the dense remap) stays consistent.
        orig_level = [[int(item_map[i]) for i in s] for s in level]
        extra = {
            "itemsets": [[list(s), c] for s, c in itemsets.items()],
            "levels": [dataclasses.asdict(s) for s in levels],
            "level": orig_level,
            "next_k": next_k,
            "n": n,
            "min_count": min_count,
            "config": json.dumps(config, sort_keys=True),
        }
        ckpt.save(self.checkpoint_dir, step=next_k,
                  tree={"item_map": np.asarray(item_map)}, extra=extra,
                  fault_plan=fault_plan)

    def _try_restore(self, n: int, min_count: int, config: dict):
        if self.checkpoint_dir is None or \
                not os.path.isdir(self.checkpoint_dir):
            return None
        from repro_torch.distributed import checkpoint as ckpt

        out = ckpt.load(self.checkpoint_dir)
        if out is None:
            return None
        arrays, _step, extra = out
        if int(extra.get("n", -1)) != n or \
                int(extra.get("min_count", -1)) != min_count:
            return None  # stale checkpoint from a different run
        if extra.get("config") != json.dumps(config, sort_keys=True):
            # Written under a different runner/store/strategy/max_k:
            # resuming would silently mix configs.
            return None
        itemsets = {tuple(s): int(c) for s, c in extra["itemsets"]}
        levels = [JobProfile(**d) for d in extra["levels"]]
        level = [tuple(s) for s in extra["level"]]
        next_k = int(extra["next_k"])
        item_map = np.asarray(arrays["item_map"])
        # Stored levels are in original ids; the loop needs dense ids.
        remap = {int(orig): dense for dense, orig in enumerate(item_map)}
        dense_level = [tuple(remap[i] for i in s) for s in level]
        return itemsets, levels, dense_level, next_k, item_map
