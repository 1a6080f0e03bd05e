"""Execution backends behind one runner interface (PyTorch port).

A runner owns job execution only — drivers own *what* to count, runners own
*how*:

``ingest(transactions)``   take the raw database (original item ids);
``job1()``                 the 1-itemset histogram job -> (hist, JobProfile);
``place(item_map)``        dense re-encode over the frequent items and make
                           the DB resident for counting jobs;
``count_async(job)``       submit a ``CountJob``; the returned handle's
                           ``result()`` -> (int64[C] counts, JobProfile).

``TorchRunner`` is the single-device counterpart of the JAX package's
``JaxRunner``.  Given a ``ChunkedDatasetReader`` instead of transaction
lists, it mines out of core: nothing is materialised, Job1 and every
counting job stream the reader's chunks (``encode_block`` plus the engine's
``count_block_async`` per chunk) and sum the per-chunk counts.  The Hadoop
cost-model ``SimRunner``, the multi-device runner and fault injection are
not ported yet.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.itemsets import filter_candidates_matrix
from repro_torch.core.runtime.cache import DATASET_CACHE, dataset_digest
from repro_torch.core.runtime.device_loop import filter_candidates_device
from repro_torch.core.runtime.engine import MapReduceEngine
from repro_torch.core.runtime.job import CountJob, JobProfile
from repro_torch.core.stores import (
    EncodedDB, encode_db_from_padded, padded_from_transactions)
from repro_torch.core.stores.base import dense_remap_padded


class BaseRunner:
    kind = "base"
    supports_async = False  # True => count_async overlaps with host work

    def describe(self) -> str:
        raise NotImplementedError

    def config_signature(self) -> str:
        """The backend identity a checkpoint is stamped with."""
        return self.describe()

    def close(self, wait: bool = True) -> None:
        """Release runner-owned resources (dispatch queues)."""

    def __enter__(self) -> "BaseRunner":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close(wait=exc_type is None)

    def ingest(self, transactions: Sequence[Sequence[int]]) -> None:
        raise NotImplementedError

    @property
    def n_raw_items(self) -> int:
        """max original item id + 1 of the ingested DB."""
        return self._n_raw

    def job1(self) -> Tuple[np.ndarray, JobProfile]:
        raise NotImplementedError

    def place(self, item_map: np.ndarray) -> None:
        raise NotImplementedError

    def count_async(self, job: CountJob):
        raise NotImplementedError

    def count(self, job: CountJob) -> Tuple[np.ndarray, JobProfile]:
        return self.count_async(job).result()

    def filter_candidates(self, cand: np.ndarray,
                          level_mat: np.ndarray) -> np.ndarray:
        """Keep the rows of ``cand`` whose every (k-1)-subset is in
        ``level_mat`` — the SPC cut-back.  Device runners override it."""
        return filter_candidates_matrix(cand, level_mat)


def _as_reader(transactions):
    """The ingested object, as a ChunkedDatasetReader if it is one (lazy
    import: core stays importable without the data package)."""
    from repro_torch.data.chunked import ChunkedDatasetReader

    if isinstance(transactions, ChunkedDatasetReader):
        return transactions
    return None


class _TorchPending:
    """Job handle over the engine's ``PendingCounts``; adds the profile.

    A resident job has one engine handle; an out-of-core job has one per
    streamed chunk (``chunks`` of them), and ``result()`` sums their count
    vectors in int64: support counts are additive over disjoint transaction
    blocks, so the total equals the count over the whole DB.
    """

    def __init__(self, runner: "TorchRunner", job: CountJob, parts,
                 encode_s: float, chunks: int = 0) -> None:
        self._runner = runner
        self._job = job
        self._parts = parts
        self._encode_s = encode_s
        self._chunks = chunks

    def poll(self) -> bool:
        return all(p.poll() for p in self._parts)

    def result(self) -> Tuple[np.ndarray, JobProfile]:
        t0 = time.perf_counter()
        counts = np.zeros((int(self._job.cand.shape[0]),), np.int64)
        for p in self._parts:
            counts += p.result()
        wait_s = time.perf_counter() - t0
        prof = JobProfile(
            k=self._job.k, n_candidates=self._job.n_candidates,
            seconds=self._encode_s + wait_s,
            encode_seconds=self._encode_s, count_seconds=wait_s,
            inflight_depth=self._runner.engine.inflight,
            inflight_retunes=self._runner.engine.inflight_retunes,
            chunks=self._chunks,
        )
        return counts, prof


class TorchRunner(BaseRunner):
    """Single-device MapReduce runner on PyTorch (array-layout stores) —
    the counterpart of the JAX package's ``JaxRunner``."""

    kind = "torch"

    @property
    def supports_async(self) -> bool:
        # inflight=0 forces every chunk during dispatch (fully synchronous),
        # so speculative host-side generation would be pure wasted work.
        return self.engine.inflight > 0

    def __init__(self, store: str = "perfect_hash", block_n: int = 2048,
                 cand_block: int = 32_768, inflight: Optional[int] = 1,
                 encode_ahead: int = 2, device="cuda") -> None:
        self.engine = MapReduceEngine(
            store=store, block_n=block_n, cand_block=cand_block,
            inflight=inflight, encode_ahead=encode_ahead, device=device)
        self._padded_raw: Optional[np.ndarray] = None
        self._n_raw = 0
        self._raw_digest: Optional[str] = None
        self._reader = None  # a ChunkedDatasetReader when mining out of core
        self._chunk_item_map: Optional[np.ndarray] = None

    def describe(self) -> str:
        return f"{self.kind}/{self.engine.store_name}"

    def close(self, wait: bool = True) -> None:
        """Abandon the engine's outstanding dispatch queue."""
        self.engine.abandon()

    def ingest(self, transactions: Sequence[Sequence[int]]) -> None:
        reader = _as_reader(transactions)
        if reader is not None:
            # Out of core: nothing is materialised; every job streams the
            # reader's chunks, so peak host memory stays about one chunk.
            self._reader = reader
            self._padded_raw = None
            self._n_raw = reader.n_raw_items
            self._raw_digest = None
            self._chunk_item_map = None
            return
        # The single host pass over the raw lists; everything downstream
        # (Job1, dense re-encode, counting) is vectorized or on the device.
        self._reader = None
        self._padded_raw, self._n_raw = padded_from_transactions(transactions)
        self._raw_digest = None  # lazily computed on first place()

    def job1(self) -> Tuple[np.ndarray, JobProfile]:
        t0 = time.perf_counter()
        if self._reader is not None:
            # Per-chunk device histograms summed on the host: a bincount is
            # additive over disjoint blocks, so this equals the whole-DB job.
            hist = np.zeros((self._n_raw,), np.int64)
            n_chunks = 0
            for chunk in self._reader.chunks():
                hist += self.engine.count_items_device(chunk, self._n_raw)
                n_chunks += 1
            wall = time.perf_counter() - t0
            prof = JobProfile(k=1, n_candidates=int(np.count_nonzero(hist)),
                              seconds=wall, count_seconds=wall,
                              chunks=n_chunks)
            return hist, prof
        hist = self.engine.count_items_device(self._padded_raw, self._n_raw)
        wall = time.perf_counter() - t0
        # n_candidates = distinct items actually observed.
        prof = JobProfile(k=1, n_candidates=int(np.count_nonzero(hist)),
                          seconds=wall, count_seconds=wall)
        return hist, prof

    def place(self, item_map: np.ndarray) -> None:
        """Dense re-encode over the frequent items, served through the shared
        encoded-dataset cache (keyed by raw-DB digest, store, f_pad and
        item-map digest), then copied to the device.  Out of core only the
        item map is kept (jobs encode each chunk with ``encode_block``) and
        the cache is skipped: a cached EncodedDB is the whole DB."""
        if self._reader is not None:
            self._chunk_item_map = np.asarray(item_map, np.int64)
            return
        if self._raw_digest is None:
            self._raw_digest = dataset_digest(self._padded_raw)
        item_arr = np.asarray(item_map, np.int64)
        f_pad = ((len(item_arr) // 128) + 1) * 128  # EncodedDB's F_pad
        key = (self._raw_digest, self.engine.store_name, f_pad,
               dataset_digest(item_arr))
        enc = DATASET_CACHE.get_or_build(key, lambda: self._encode(item_arr))
        self.engine.place(enc)

    def _encode(self, item_map: np.ndarray):
        dense = dense_remap_padded(self._padded_raw, item_map,
                                   n_raw=self._n_raw)
        return encode_db_from_padded(dense, n_items=len(item_map))

    def encode_block(self, padded_raw: np.ndarray,
                     item_map: np.ndarray) -> EncodedDB:
        """Dense-encode an ad-hoc block of raw-id rows over a frequent-item
        map: the same remap and F_pad as ``place()``, so the block's tensors
        line up with the candidates' encoding."""
        dense = dense_remap_padded(padded_raw, item_map)
        return encode_db_from_padded(dense, n_items=len(item_map))

    def count_block_async(self, enc_block: EncodedDB, cand: np.ndarray):
        """Count a candidate matrix over an ad-hoc encoded block instead of
        the placed DB, through the engine's shared FIFO."""
        return self.engine.count_block_async(enc_block, cand)

    def filter_candidates(self, cand: np.ndarray,
                          level_mat: np.ndarray) -> np.ndarray:
        """SPC cut-back on the device (same rows, same order)."""
        return filter_candidates_device(cand, level_mat,
                                        device=self.engine.device)

    def count_async(self, job: CountJob):
        if self._reader is not None:
            return self._count_chunked_async(job)
        t0 = time.perf_counter()
        pending = self.engine.count_candidates_async(job.cand)
        return _TorchPending(self, job, [pending], time.perf_counter() - t0)

    def _count_chunked_async(self, job: CountJob) -> _TorchPending:
        """Stream the reader through one counting job: per chunk,
        ``encode_block`` and the engine's block count; the handle sums the
        per-chunk vectors.  The engine forces the oldest result to the host
        once ``inflight`` chunk counts are outstanding, so dispatch never
        runs further ahead of the device than the queue."""
        if self._chunk_item_map is None:
            raise RuntimeError("call place(item_map) first")
        t0 = time.perf_counter()
        parts = []
        for chunk in self._reader.chunks():
            enc = self.encode_block(chunk, self._chunk_item_map)
            parts.append(self.engine.count_block_async(enc, job.cand))
        return _TorchPending(self, job, parts, time.perf_counter() - t0,
                             chunks=len(parts))


def make_runner(store: str = "perfect_hash", mesh=None,
                cand_axes: Tuple[str, ...] = (), block_n: int = 2048,
                cand_block: int = 32_768, inflight: Optional[int] = 1,
                encode_ahead: int = 2, fault_plan=None,
                device="cuda") -> BaseRunner:
    """Default runner selection for drivers.  Only the single-device runner
    is ported; a mesh, candidate axes or a fault plan raise."""
    if mesh is not None or cand_axes:
        raise NotImplementedError("the multi-device runner is not yet ported")
    if fault_plan is not None:
        raise NotImplementedError("fault injection is not yet ported")
    return TorchRunner(store=store, block_n=block_n, cand_block=cand_block,
                       inflight=inflight, encode_ahead=encode_ahead,
                       device=device)
