"""MapReduce counting engine on PyTorch, on one device or over a mesh of
``torch.distributed`` ranks.

Mapper = the per-block count over this rank's transaction tensors;
Combiner = the in-block reduction inside the store's ``count_block`` (sum
over Nb); Shuffle + Reducer = the sum over row blocks, then ``all_reduce``
of the per-shard count vectors over the ``data`` group (the reference's
``lax.psum``), then host-side min-support thresholding in the strategy.
The PyTorch counterpart of the JAX package's ``core/runtime/engine.py``:
there is no ``jit`` (PyTorch runs eagerly) and asynchrony is the device
stream's own order.

The transaction tensors are placed once and reused across levels; per wave
only the small (C, k) int32 candidate matrix crosses to the device, and the
store's ``encode_candidates`` builds its candidate tensors there.

**Meshes** (``mesh=``, a ``DeviceMesh`` from ``launch/mesh.py``; one rank
drives one device).  ``place`` pads N to the ``data`` shard multiple (pad
rows go to the tail and match nothing) and keeps this rank's contiguous
row block ``[r*n/d, (r+1)*n/d)``.  With ``cand_axes`` each wave chunk's
candidate rows are padded to the ``cand`` shard multiple and this rank
encodes and counts only its own contiguous slice; the per-shard vectors
are stitched back by ``all_gather`` over the ``cand`` group.  Integer adds
and concatenation: counts are identical to one device's.  The collectives
are issued at *dispatch*, in FIFO order, so every rank issues the same
collectives in the same order whatever its queue depth or ``drain_ready``
timing; they run on every mesh, size-1 groups included, so a one-card
mesh drives the same path as a cluster.  A synchronous collective makes
the current stream wait for it on NCCL (the host goes on) and blocks the
host until it is done on gloo; either way the FIFO entry's CUDA event is
recorded after it, so ``drain_ready`` never reads an unreduced vector.
``count_block_async`` (out-of-core chunks, serving deltas) stays
un-sharded, as in the reference: every rank counts the whole block.

Wave dispatch is asynchronous and double-buffered at both stages:
``count_candidates_async`` splits a wave into ``cand_block`` chunks; up to
``encode_ahead`` chunks sit encoded ahead of their count dispatch, and up to
``inflight`` dispatched chunk results stay outstanding before the oldest is
fetched to the host.  Results resolve strictly in dispatch order, so counts
are identical at any depth; ``inflight=0`` runs chunk by chunk and
``inflight=None`` sizes the depth from a measured chunk.

Job1 (the 1-itemset histogram) is a device job too: ``count_items_device``
bincounts this rank's rows of the padded transaction matrix and reduces
over ``data`` like every other counting job.
"""

from __future__ import annotations

import collections
import time
from typing import Deque, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.stores import ARRAY_STORES, EncodedDB, pad_candidates
from repro_torch.core.stores.base import ITEM_PAD
from repro_torch.distributed.ctx import fetch_global
from repro_torch.trace import span


def resolve_device(device="cuda") -> torch.device:
    """The device a port entry point runs on.  A CUDA device without a
    usable card raises: the port never drops quietly to the CPU, which a
    caller asks for explicitly with ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU")
    return dev


class PendingCounts:
    """Handle for an in-flight counting wave; ``result()`` blocks and joins.

    Chunk results resolve strictly in dispatch order through the engine's
    FIFO, so counts are independent of the ``inflight`` depth.
    """

    def __init__(self, engine: "MapReduceEngine", n_chunks: int) -> None:
        self._engine = engine
        self._parts: List[Optional[np.ndarray]] = [None] * n_chunks
        self._cancelled = False

    @property
    def done(self) -> bool:
        return all(p is not None for p in self._parts)

    def poll(self) -> bool:
        """Non-blocking: fetch whatever chunk results the device has already
        finished (in FIFO order), then report whether this wave is joined."""
        if self._cancelled:
            raise RuntimeError(
                "counting wave was cancelled: place() re-placed the DB "
                "while this handle's chunks were still in flight")
        self._engine.drain_ready()
        return self.done

    def result(self) -> np.ndarray:
        while not self.done:
            if self._cancelled or not self._engine._queue:
                raise RuntimeError(
                    "counting wave was cancelled: place() re-placed the DB "
                    "while this handle's chunks were still in flight")
            self._engine._force_oldest()
        if not self._parts:
            return np.zeros((0,), np.int64)
        return np.concatenate(self._parts)


class MapReduceEngine:
    def __init__(
        self,
        store: str = "perfect_hash",
        block_n: int = 2048,
        cand_block: int = 32_768,
        inflight: Optional[int] = 1,
        encode_ahead: int = 2,
        device=None,
        mesh=None,
        data_axes: Tuple[str, ...] = ("data",),
        cand_axes: Tuple[str, ...] = (),
    ) -> None:
        if store not in ARRAY_STORES:
            raise ValueError(f"unknown store {store!r}; pick from {list(ARRAY_STORES)}")
        if cand_axes and mesh is None:
            raise ValueError("cand_axes requires a mesh with those axes")
        self.mesh = mesh
        self.data_axes = tuple(data_axes)
        self.cand_axes = tuple(cand_axes)
        self._data_group = self._cand_group = None
        self._data_index = self._cand_index = 0
        if mesh is not None:
            device = self._join_mesh(mesh, device)
        self.device = resolve_device("cuda" if device is None else device)
        self.store = ARRAY_STORES[store]
        self.store_name = store
        self.block_n = block_n
        self.cand_block = cand_block  # bounds per-dispatch candidate memory
        # inflight=None => auto: pick the depth from the first clean chunk's
        # measured device latency vs host dispatch time; until tuned, run
        # classic double buffering.
        self.inflight_auto = inflight is None
        self._inflight_tuned = False
        self.inflight = 1 if inflight is None else inflight
        self.encode_ahead = encode_ahead
        # Per-chunk work (min(C, cand_block) * k) the depth was last tuned
        # on, and the cumulative mid-run re-tunes (surfaced via JobProfile).
        self._tuned_work: Optional[int] = None
        self._retune_pending = False
        self.inflight_retunes = 0
        self._trans_device: Optional[dict] = None
        self._enc: Optional[EncodedDB] = None
        self._local_enc: Optional[EncodedDB] = None
        # FIFO of (pending, slot, device_counts, n_valid, done_event).
        self._queue: Deque[tuple] = collections.deque()
        # Host seconds spent issuing collectives, and how many (telemetry).
        self.collective_seconds = 0.0
        self.collectives = 0

    def _join_mesh(self, mesh, device):
        """Check the mesh's axes, find this rank's place on it and the groups
        of its two roles; returns the device (the mesh's type; a ``device``
        of another type raises)."""
        names = tuple(mesh.mesh_dim_names or ())
        missing = [a for a in self.data_axes + self.cand_axes
                   if a not in names]
        if missing:
            raise ValueError(f"mesh has axes {list(names)}, missing {missing}")
        if len(self.data_axes) > 1 or len(self.cand_axes) > 1:
            raise ValueError("data_axes and cand_axes name at most one mesh "
                             "axis each")
        if device is not None and torch.device(device).type != mesh.device_type:
            raise ValueError(f"device {str(device)!r} disagrees with the "
                             f"mesh's device type {mesh.device_type!r}")
        coord = mesh.get_coordinate()
        if coord is None:
            raise ValueError("this rank is not on the mesh")
        if self.data_axes:
            self._data_index = int(coord[names.index(self.data_axes[0])])
            self._data_group = mesh.get_group(self.data_axes[0])
        if self.cand_axes:
            self._cand_index = int(coord[names.index(self.cand_axes[0])])
            self._cand_group = mesh.get_group(self.cand_axes[0])
        return mesh.device_type

    # -- placement ---------------------------------------------------------
    def _axis_size(self, axes: Tuple[str, ...]) -> int:
        if self.mesh is None or not axes:
            return 1
        names = tuple(self.mesh.mesh_dim_names)
        return int(self.mesh.mesh.shape[names.index(axes[0])])

    @property
    def n_data_shards(self) -> int:
        return self._axis_size(self.data_axes)

    @property
    def n_cand_shards(self) -> int:
        return self._axis_size(self.cand_axes)

    def abandon(self) -> None:
        """Void every outstanding chunk handle and drop the dispatch queue."""
        for entry in self._queue:
            entry[0]._cancelled = True
        self._queue.clear()

    def _row_block(self, n: int) -> Tuple[int, int]:
        """This rank's rows of an n-row matrix padded to the data shards."""
        per = n // self.n_data_shards
        return self._data_index * per, (self._data_index + 1) * per

    def place(self, enc: EncodedDB) -> None:
        """Pad N to the data shard multiple and copy this rank's row block
        of the store's transaction tensors to the device; keep them."""
        self.abandon()  # handles from a prior DB are void
        shards = self.n_data_shards
        n_padded = -(-enc.n_transactions // shards) * shards
        with span("repro_torch.engine.place.pack"):
            enc = enc.pad_transactions_to(n_padded)
            local = enc.row_block(*self._row_block(n_padded))
            trans = self.store.transaction_inputs(local)
        with span("repro_torch.engine.place.copy"):
            self._trans_device = {
                k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in trans.items()}
        self._enc = enc
        self._local_enc = local

    def _blocked_count(self, trans: dict, cands: dict) -> torch.Tensor:
        """Mapper body: a loop over Nb-row blocks bounds peak (Nb, C) memory;
        a ragged tail block is counted on its own.  One span covers the
        whole loop: a span a block would put thousands of profiler ranges
        in a traced job."""
        n = next(iter(trans.values())).shape[0]
        block_n = max(1, min(self.block_n, n))  # n == 0 guarded by callers
        n_blocks = max(1, n // block_n)
        usable = n_blocks * block_n
        partial = None
        with span("repro_torch.engine.launch"):
            for b in range(n_blocks):
                block = {k: v[b * block_n:(b + 1) * block_n]
                         for k, v in trans.items()}
                part = self.store.count_block(block, cands)
                partial = part if partial is None else partial + part
            if usable < n:  # ragged tail block
                partial = partial + self.store.count_block(
                    {k: v[usable:] for k, v in trans.items()}, cands)
        return partial

    # -- collectives -----------------------------------------------------------
    def all_reduce_data(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``t`` reduced (``"sum"`` or ``"max"``) over the data group, in
        place; a no-op without a mesh."""
        if self.mesh is None or self._data_group is None:
            return t
        import torch.distributed as dist

        t0 = time.perf_counter()
        dist.all_reduce(t, op=dist.ReduceOp.SUM if op == "sum"
                        else dist.ReduceOp.MAX, group=self._data_group)
        self.collective_seconds += time.perf_counter() - t0
        self.collectives += 1
        return t

    def reduce_counts(self, local: torch.Tensor) -> torch.Tensor:
        """Per-shard counts of this rank's candidate slice over its rows ->
        the wave's whole count vector: ``all_reduce`` over data (shuffle +
        reduce), then ``all_gather`` over cand (the stitch).  The identity
        without a mesh."""
        if self.mesh is None:
            return local
        local = self.all_reduce_data(local.contiguous())
        if self._cand_group is None:
            return local
        import torch.distributed as dist

        t0 = time.perf_counter()
        parts = [torch.empty_like(local) for _ in range(self.n_cand_shards)]
        dist.all_gather(parts, local, group=self._cand_group)
        self.collective_seconds += time.perf_counter() - t0
        self.collectives += 1
        return torch.cat(parts)

    def barrier(self) -> None:
        """Hold the host until every rank of the mesh got here: a sum over
        data, then over cand (together they span the grid), fetched to the
        host.  A no-op without a mesh."""
        if self.mesh is None:
            return
        import torch.distributed as dist

        t = torch.ones(1, dtype=torch.int64, device=self.device)
        for group in (self._data_group, self._cand_group):
            if group is not None:
                dist.all_reduce(t, group=group)
        int(t.item())

    def cand_slice(self, n_rows: int) -> Tuple[int, int]:
        """This rank's rows of a candidate matrix padded to the cand shards."""
        per = n_rows // self.n_cand_shards
        return self._cand_index * per, (self._cand_index + 1) * per

    # -- counting ------------------------------------------------------------
    def _dispatch_encode(self, chunk: np.ndarray, f_pad: int,
                         sharded: bool = True) -> dict:
        """Ship one padded (C, k) chunk and dispatch its device-side encode
        (nothing here waits for the device).  ``sharded``: under candidate
        sharding, pad C to the cand shard multiple and encode only this
        rank's slice (the shard-local encode)."""
        shards = self.n_cand_shards if sharded else 1
        with span("repro_torch.engine.encode"):
            cand_p = pad_candidates(chunk, f_pad, shards=shards)
            if shards > 1:
                lo, hi = self.cand_slice(cand_p.shape[0])
                cand_p = cand_p[lo:hi]
            cand_dev = torch.from_numpy(
                np.ascontiguousarray(cand_p, dtype=np.int32)).to(self.device)
            return self.store.encode_candidates(cand_dev, f_pad=f_pad)

    def _dispatch_count(self, trans: dict, cands: dict, reduce: bool = True):
        """Dispatch the count of an encoded chunk over ``trans`` and, with
        ``reduce``, its collectives; returns the device counts and, on CUDA,
        an event recorded after both (every FIFO entry carries one, so
        ``drain_ready`` never blocks on a CUDA entry nor reads an unreduced
        vector)."""
        dev = self._blocked_count(trans, cands)
        if reduce:
            dev = self.reduce_counts(dev)
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        return dev, event

    def _count_encoded(self, pending: PendingCounts, encoded: Deque) -> None:
        """Move the oldest encode slot into the count FIFO; drain the count
        FIFO down to ``inflight`` outstanding results."""
        slot, cands, n_valid = encoded.popleft()
        dev, event = self._dispatch_count(self._trans_device, cands)
        self._queue.append((pending, slot, dev, n_valid, event))
        while len(self._queue) > self.inflight:
            self._force_oldest()

    def _force_oldest(self) -> None:
        """Fetch the oldest outstanding chunk result to the host (blocking)."""
        pending, slot, dev, c, _ = self._queue.popleft()
        with span("repro_torch.engine.wait"):
            counts = fetch_global(dev)
            pending._parts[slot] = counts[:c].astype(np.int64)

    def drain_ready(self) -> int:
        """Fetch every *leading* queue entry whose device result is already
        computed (``torch.cuda.Event.query``); never block.  Returns the
        number of chunks joined."""
        joined = 0
        while self._queue:
            event = self._queue[0][4]
            if event is not None and not event.query():
                break
            self._force_oldest()
            joined += 1
        return joined

    def count_candidates_async(self, cand: np.ndarray) -> PendingCounts:
        """Dispatch a counting wave without blocking.

        cand: (C, k) dense-id candidate matrix.  The wave streams through in
        ``cand_block``-sized chunks; at most ``inflight`` chunk results stay
        queued on the device before the oldest is forced to the host.
        """
        if self._enc is None:
            raise RuntimeError("call place(enc) first")
        if cand.size == 0:
            return PendingCounts(self, 0)
        cand = np.ascontiguousarray(np.asarray(cand, dtype=np.int32))
        if self._enc.n_transactions == 0:
            # Degenerate DB: zero transactions support nothing.
            pending = PendingCounts(self, 1)
            pending._parts[0] = np.zeros((cand.shape[0],), np.int64)
            return pending
        # Drift is judged on the work of one dispatched chunk.
        chunk_work = (min(int(cand.shape[0]), self.cand_block)
                      * int(cand.shape[1]))
        if (self.inflight_auto and self._inflight_tuned
                and self._tuned_work is not None
                and not (self._tuned_work / 2 <= chunk_work
                         <= self._tuned_work * 2)):
            # Per-chunk work drifted more than 2x from the tuned shape:
            # re-tune on the next clean chunk.
            self._inflight_tuned = False
            self._retune_pending = True
        starts = range(0, cand.shape[0], self.cand_block)
        pending = PendingCounts(self, len(starts))
        encoded: Deque[tuple] = collections.deque()
        ahead = self.encode_ahead if self.inflight > 0 else 0
        for slot, i in enumerate(starts):
            chunk = cand[i : i + self.cand_block]
            if (self.inflight_auto and not self._inflight_tuned
                    and slot == 1 and chunk.shape[0] == self.cand_block):
                while encoded:  # the sample must not queue behind slot 0
                    self._count_encoded(pending, encoded)
                self._tune_inflight(pending, slot, chunk, chunk_work)
                ahead = self.encode_ahead if self.inflight > 0 else 0
                continue
            encoded.append((slot,
                            self._dispatch_encode(chunk, self._enc.f_pad),
                            chunk.shape[0]))
            if len(encoded) > ahead:
                self._count_encoded(pending, encoded)
        while encoded:  # counts of the trailing encode slots (all async)
            self._count_encoded(pending, encoded)
        return pending

    def _tune_inflight(self, pending: PendingCounts, slot: int,
                       chunk: np.ndarray, chunk_work: int) -> None:
        """Auto-size the queue depth (``inflight=None``): depth = device
        completion latency / host dispatch time of the wave's second, full
        chunk, clamped to [1, 8].  Counts are identical at any depth."""
        while self._queue:
            self._force_oldest()
        t0 = time.perf_counter()
        dev, event = self._dispatch_count(
            self._trans_device, self._dispatch_encode(chunk, self._enc.f_pad))
        submit_s = time.perf_counter() - t0
        self._queue.append((pending, slot, dev, chunk.shape[0], event))
        t0 = time.perf_counter()
        self._force_oldest()
        wait_s = time.perf_counter() - t0
        self.inflight = int(np.clip(
            round(wait_s / max(submit_s, 1e-6)), 1, 8))
        self._inflight_tuned = True
        self._tuned_work = chunk_work
        if self._retune_pending:  # a mid-run re-tune actually fired
            self.inflight_retunes += 1
            self._retune_pending = False

    def count_candidates(self, cand: np.ndarray) -> np.ndarray:
        """Blocking wrapper: (C, k) candidate matrix -> int64[C] counts."""
        return self.count_candidates_async(cand).result()

    # -- counting over an ad-hoc block (out-of-core chunks, serving deltas) --
    def count_block_async(self, enc_block: EncodedDB,
                          cand: np.ndarray) -> PendingCounts:
        """Count ``cand`` over an *ad-hoc* encoded transaction block instead
        of the placed DB: the out-of-core chunk count and the serving
        delta primitive.

        The block's store tensors go to the device with the dispatch
        (nothing is re-placed, so the resident DB is untouched); the
        candidates go in ``cand_block`` chunks, each encoded on the device
        and counted by ``_blocked_count`` over the block's row blocks, and
        the results flow through the same FIFO as the wave pipeline, with
        at most ``inflight`` outstanding.
        """
        cand = np.ascontiguousarray(np.asarray(cand, dtype=np.int32))
        if cand.size == 0:
            return PendingCounts(self, 0)
        if enc_block.n_transactions == 0:
            pending = PendingCounts(self, 1)
            pending._parts[0] = np.zeros((cand.shape[0],), np.int64)
            return pending
        trans = {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                 for k, v in self.store.transaction_inputs(enc_block).items()}
        starts = range(0, cand.shape[0], self.cand_block)
        pending = PendingCounts(self, len(starts))
        for slot, i in enumerate(starts):
            chunk = cand[i : i + self.cand_block]
            dev, event = self._dispatch_count(
                trans, self._dispatch_encode(chunk, enc_block.f_pad,
                                             sharded=False), reduce=False)
            self._queue.append((pending, slot, dev, chunk.shape[0], event))
            while len(self._queue) > self.inflight:
                self._force_oldest()
        return pending

    def count_block(self, enc_block: EncodedDB, cand: np.ndarray) -> np.ndarray:
        """Blocking wrapper around :meth:`count_block_async`."""
        return self.count_block_async(enc_block, cand).result()

    # -- the device-resident level ladder ------------------------------------
    def level_ladder(self, min_count: int, trim: bool = True,
                     fault_plan=None):
        """The fused gen -> encode -> count -> prune loop over the placed DB
        (``runtime/device_loop.py``), with optional on-device trimming."""
        from repro_torch.core.runtime.device_loop import LevelLadder

        return LevelLadder(self, min_count, trim=trim, fault_plan=fault_plan)

    # -- L1 (Job1: OneItemsetMapper + reducer) -------------------------------
    def count_items_device(self, padded: np.ndarray, n_items: int) -> np.ndarray:
        """Device-side Job1: histogram of the (N, L) padded id matrix.  Rows
        hold *unique* sorted ids padded with ITEM_PAD, so presence counting
        is a bincount; pads (and any id >= n_items) land in a dump slot.
        On a mesh each rank bincounts its row block and the histograms are
        summed over data, as every other counting job."""
        n = padded.shape[0]
        if n == 0 or n_items == 0:
            return np.zeros((n_items,), np.int64)
        shards = self.n_data_shards
        n_padded = -(-n // shards) * shards
        if n_padded != n:
            pad = np.full((n_padded - n, padded.shape[1]), ITEM_PAD, np.int32)
            padded = np.concatenate([padded, pad])
        lo, hi = self._row_block(n_padded)
        p = torch.from_numpy(
            np.ascontiguousarray(padded[lo:hi], dtype=np.int32)).to(self.device)
        ids = torch.clamp(p, max=n_items).reshape(-1).to(torch.int64)
        hist = torch.bincount(ids, minlength=n_items + 1)[:n_items]
        hist = self.all_reduce_data(hist.contiguous())
        return fetch_global(hist).astype(np.int64)
