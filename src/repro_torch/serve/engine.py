"""Streaming frequent-itemset mining service over a sliding window (PyTorch
port of the JAX package's ``serve/engine.py``).

``MiningService`` is the serving counterpart of the batch
``FrequentItemsetMiner``: transactions arrive in batches, live in
fixed-size *slots* forming a sliding window, and frequent-itemset queries
are served from a continuously maintained count state instead of re-mining
the window per request.

Exactness by additivity.  Support counts are additive over disjoint
transaction sets, so between full refreshes the service maintains:

* the exact per-item histogram over the raw item universe (bincount deltas
  on ingest/evict): L1 at any threshold falls out directly; and
* the full candidate lattice of the last refresh (every candidate matrix
  the level loop counted, the *negative border* included), with counts
  delta-updated per ingested/evicted block: add the new block's
  contribution, subtract the evicted block's.

A query walks the Apriori lattice from those tracked counts: L1 from the
histogram, ``C_k = apriori_gen(L_{k-1})`` per level, counts looked up in
the tracked lattice.  If every generated candidate is tracked, the answer
is the batch miner's answer over the exact current window; if one escapes,
the state is stale and a refresh re-mines the window through the resident
runner.  ``margin`` mines the refresh lattice at ``ceil(margin *
min_count)`` so support-boundary flicker stays inside the tracked lattice;
answers are always filtered at the true threshold.  Queries below the
margin band ("below_track") refresh at the queried threshold.

Hardening:

* **Per-basket eviction** (``eviction="basket"`` / ``evict(n)``): baskets
  leave the head slot through a signed delta on the sub-slot block, down
  to a one-row block, so the window cap is exact in baskets.
* **Bounded-staleness serving** (``query(staleness=s)``): within the
  churn budget the query answers from current counts with an
  :class:`ErrorCertificate` bounding the drift and the misses.  L1 is
  always exact.
* **Background refresh**: the lattice rebuild is a cooperative state
  machine over the engine's wave FIFO, advanced non-blockingly from
  ``ingest()`` and stale queries (``poll()`` on pending handles, which on
  the card reads each FIFO entry's CUDA event).  Blocks that arrive
  mid-refresh are logged and replayed onto the new lattice at handoff.
* **Compaction**: after sustained churn, tracked rows outside the
  generatable closure are pruned (``tracked_keep_mask``).

Delta dispatch is asynchronous: ingest encodes each block over the tracked
item map and pushes one delta counting job per tracked level through the
engine's FIFO (``count_block_async``); on the kernel stores each job runs
the hand-written kernels.  Results are joined non-blockingly as they land
and forced only when a query needs exactness.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.itemsets import Itemset, apriori_gen_matrix, level_to_matrix
from repro_torch.core.runtime import BaseRunner, CountJob, make_runner
from repro_torch.core.stores.base import (
    ITEM_PAD,
    padded_from_transactions,
    tracked_keep_mask,
)


@dataclasses.dataclass(frozen=True)
class ErrorCertificate:
    """Provable error bounds for one served answer.

    ``max_drift``:  every *reported* itemset's support is within this many
                    counts of its exact support over the current window
                    (the volume of dispatched-but-unjoined delta blocks).
    ``miss_bound``: every itemset *absent* from the answer has exact
                    support strictly below this: ``min_count + max_drift``
                    for a fully tracked walk, widened to
                    ``track_count_ref + ingested_since_refresh`` if the walk
                    skipped untracked candidates.
    ``max_drift == 0`` and ``miss_bound == min_count`` certify exactness.
    """

    max_drift: int
    miss_bound: int
    undrained: int          # transactions in un-joined delta blocks
    churn: int              # transactions ingested+evicted since refresh
    refresh_in_flight: bool

    def is_exact(self, min_count: int) -> bool:
        return self.max_drift == 0 and self.miss_bound <= min_count


@dataclasses.dataclass
class ServeResult:
    """One served query over the current window.

    ``stale_reason``: ``"cold"`` / ``"drift"`` / ``"untracked"`` /
    ``"below_track"`` escaped to a blocking refresh; ``"stale"`` was served
    approximately under a ``staleness=`` budget (see ``certificate``);
    ``None`` means the tracked walk served exactly.
    """

    itemsets: Dict[Itemset, int]   # frequent itemset -> support count
    min_count: int
    n_transactions: int            # window size the query was served over
    refreshed: bool                # True if this query ran a blocking refresh
    stale_reason: Optional[str]
    seconds: float = 0.0
    certificate: Optional[ErrorCertificate] = None
    refresh_in_flight: bool = False

    def frequent_at(self, k: int) -> Dict[Itemset, int]:
        return {s: c for s, c in self.itemsets.items() if len(s) == k}


@dataclasses.dataclass
class IngestReport:
    """One ingest/evict call: window movement and async delta dispatches."""

    n_ingested: int
    n_evicted: int
    n_slots: int                   # live slots after the call
    window: int                    # window size after the call
    delta_jobs: int                # per-level delta counts dispatched (async)
    seconds: float


@dataclasses.dataclass
class _Slot:
    """One window slot: the raw baskets plus their padded matrix (kept so
    eviction can uncount the exact rows it once counted)."""

    transactions: List[List[int]]
    padded: np.ndarray             # (n, L) int32 raw ids, ITEM_PAD-padded
    seq: int


class _TrackedLevel:
    """One tracked candidate level: the (C, k) dense-id matrix counted at the
    last refresh and its delta-maintained exact counts."""

    __slots__ = ("cand", "counts", "_index")

    def __init__(self, cand: np.ndarray, counts: np.ndarray) -> None:
        self.cand = np.ascontiguousarray(cand, dtype=np.int32)
        self.counts = np.asarray(counts, dtype=np.int64).copy()
        self._index: Optional[Dict[bytes, int]] = None

    def rows_of(self, queries: np.ndarray) -> np.ndarray:
        """int64[Q] row index per query row; -1 where untracked."""
        if self._index is None:
            self._index = {row.tobytes(): i for i, row in enumerate(self.cand)}
        q = np.ascontiguousarray(queries, dtype=np.int32)
        return np.fromiter(
            (self._index.get(row.tobytes(), -1) for row in q),
            dtype=np.int64, count=q.shape[0])


# One in-flight delta record: every per-level job dispatched for one signed
# block, joined atomically (all levels or none) so tracked counts always
# reflect whole blocks and the un-joined volume is countable in baskets.
_DeltaRecord = Tuple[int, int, List[Tuple[int, object]]]  # (sign, n, jobs)


class MiningService:
    """Incremental frequent-itemset server over a slot-based sliding window.

    ``ingest(batch)`` appends baskets to fixed-size slots (evicting the
    oldest slots, or with ``eviction="basket"`` the oldest baskets, once the
    window is full) and dispatches async delta counting; ``query()`` returns
    the frequent itemsets of the exact current window, itemsets AND
    supports equal to a batch ``FrequentItemsetMiner`` run over
    ``window()``.  ``query(staleness=s)`` trades exactness for latency under
    a certified error bound.

    ``device`` is where the runner built from ``store`` counts (the CUDA
    card unless ``device="cpu"``; with ``mesh=``, a ``DeviceMesh`` from
    ``launch/mesh.py``, the mesh's device and a ``ShardedRunner``: the
    window DB, Job1 and refresh waves shard over ``data`` while the delta
    path stays un-sharded, as in the reference); a ``runner=`` brings its
    own.  Requires
    an engine-backed runner: the resident window DB, the delta path and the
    ladder refresh all live on the engine.
    """

    def __init__(
        self,
        min_support: float = 0.01,
        store: Optional[str] = None,
        n_slots: int = 8,
        slot_size: int = 256,
        mesh=None,
        runner: Optional[BaseRunner] = None,
        staleness: float = 0.5,
        margin: float = 0.8,
        max_k: int = 16,
        device_loop: bool = False,
        trim: bool = True,
        eviction: str = "slot",
        compact_churn: float = 4.0,
        device=None,
    ) -> None:
        if runner is not None and (store is not None or mesh is not None):
            raise ValueError(
                "pass backend config either through runner= or through "
                "store/mesh — not both")
        if n_slots < 1 or slot_size < 1:
            raise ValueError("n_slots and slot_size must be >= 1")
        if eviction not in ("slot", "basket"):
            raise ValueError(
                f"eviction must be 'slot' or 'basket', got {eviction!r}")
        self.min_support = float(min_support)
        self.n_slots = int(n_slots)
        self.slot_size = int(slot_size)
        self.staleness = float(staleness)
        if not 0.0 < margin <= 1.0:
            raise ValueError("margin must be in (0, 1]")
        self.margin = float(margin)
        self.max_k = int(max_k)
        self.device_loop = bool(device_loop)
        self.trim = bool(trim)
        self.eviction = eviction
        # Compact the tracked lattice once the drained delta volume since the
        # last compaction exceeds this multiple of the window (0 disables).
        self.compact_churn = float(compact_churn)
        self.runner = runner if runner is not None else make_runner(
            store=store if store is not None else "perfect_hash", mesh=mesh,
            device=device)
        if not hasattr(self.runner, "engine"):
            raise ValueError(
                f"MiningService needs an engine-backed runner, got "
                f"{self.runner.describe()} — it has no resident device "
                "state to delta-update")
        # -- window state --------------------------------------------------
        self._slots: Deque[_Slot] = collections.deque()
        self._seq = 0
        self._window_n = 0
        # -- exact incremental state ---------------------------------------
        self._hist = np.zeros((0,), np.int64)   # raw-id item histogram
        self._item_map = np.zeros((0,), np.int64)
        self._lookup = np.full((1,), -1, np.int64)  # raw -> dense (or -1)
        self._levels: Dict[int, _TrackedLevel] = {}
        self._refreshed_once = False
        self._track_count_ref = 0   # absolute threshold the lattice tracks
        self._churn = 0             # txns added+evicted since the last refresh
        self._ingested_since_refresh = 0
        self._evicted_since_refresh = 0
        self._pending_deltas: List[_DeltaRecord] = []
        self._drained_since_compact = 0
        self._refresh_job: Optional[dict] = None
        # -- telemetry -----------------------------------------------------
        self.refreshes = 0
        self.delta_jobs = 0
        self.total_ingested = 0
        self.total_evicted = 0
        self.stale_served = 0
        self.compactions = 0
        self.compacted_rows = 0

    # -- window ------------------------------------------------------------
    @property
    def window_size(self) -> int:
        return self._window_n

    def window(self) -> List[List[int]]:
        """The exact current window contents, oldest basket first: the
        input a parity-checking batch mine must run over."""
        return [t for slot in self._slots for t in slot.transactions]

    def close(self) -> None:
        self._abort_refresh()
        self.runner.close()

    def __enter__(self) -> "MiningService":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    # -- ingest / evict ------------------------------------------------------
    def ingest(self, transactions: Sequence[Sequence[int]]) -> IngestReport:
        """Append a batch of baskets; evict expired ones; dispatch deltas.

        The batch is cut into ``slot_size`` blocks, each becoming one slot.
        In ``"slot"`` mode the oldest whole slot is evicted once the ring is
        full; in ``"basket"`` mode the window holds exactly ``n_slots *
        slot_size`` baskets and only the overflow is evicted, per basket,
        from the head slot.  Evicted rows are *subtracted* exactly as new
        rows are added.
        """
        t0 = time.perf_counter()
        batch = [list(t) for t in transactions]
        added = evicted = 0
        jobs0 = self.delta_jobs
        cap = self.n_slots * self.slot_size
        for i in range(0, len(batch), self.slot_size):
            block = batch[i : i + self.slot_size]
            if self.eviction == "basket":
                overflow = self._window_n + len(block) - cap
                if overflow > 0:
                    evicted += self._evict_baskets(overflow)
            elif len(self._slots) == self.n_slots:
                old = self._slots.popleft()
                self._apply_padded(old.padded, sign=-1)
                evicted += len(old.transactions)
                self._window_n -= len(old.transactions)
            padded, _ = padded_from_transactions(block)
            slot = _Slot(transactions=block, padded=padded, seq=self._seq)
            self._seq += 1
            self._slots.append(slot)
            self._apply_padded(padded, sign=+1)
            self._window_n += len(block)
            added += len(block)
        self.total_ingested += added
        self.total_evicted += evicted
        # Off-query-path upkeep, both non-blocking: join the delta results
        # that already landed and advance a background refresh by one unit.
        self._drain_deltas(block=False)
        self._pump_refresh(block=False)
        return IngestReport(
            n_ingested=added, n_evicted=evicted, n_slots=len(self._slots),
            window=self._window_n, delta_jobs=self.delta_jobs - jobs0,
            seconds=time.perf_counter() - t0)

    def evict(self, n: int = 1) -> IngestReport:
        """Evict the ``n`` oldest baskets (sub-slot granularity): each
        maximal run of head-slot rows leaves through one signed delta block,
        so ``evict(1)`` is a one-row delta."""
        t0 = time.perf_counter()
        jobs0 = self.delta_jobs
        evicted = self._evict_baskets(int(n))
        self.total_evicted += evicted
        self._drain_deltas(block=False)
        self._pump_refresh(block=False)
        return IngestReport(
            n_ingested=0, n_evicted=evicted, n_slots=len(self._slots),
            window=self._window_n, delta_jobs=self.delta_jobs - jobs0,
            seconds=time.perf_counter() - t0)

    def _evict_baskets(self, n: int) -> int:
        """Remove the ``n`` oldest baskets from the head of the window,
        uncounting each head-slot run as one signed sub-block."""
        evicted = 0
        while n > 0 and self._slots:
            head = self._slots[0]
            m = min(n, len(head.transactions))
            self._apply_padded(head.padded[:m], sign=-1)
            head.transactions = head.transactions[m:]
            head.padded = head.padded[m:]
            self._window_n -= m
            evicted += m
            n -= m
            if not head.transactions:
                self._slots.popleft()
        return evicted

    def _apply_padded(self, padded: np.ndarray, sign: int) -> None:
        """Fold one block into (sign=+1) or out of (sign=-1) the incremental
        state: the exact histogram delta on the host, per-level candidate
        deltas dispatched to the device, and, while a refresh is in flight,
        a replay-log entry so the block also reaches the *new* lattice."""
        n = padded.shape[0]
        if n == 0:
            return
        real = padded[padded < ITEM_PAD]
        if real.size:
            top = int(real.max()) + 1
            if top > len(self._hist):
                self._hist = np.concatenate(
                    [self._hist, np.zeros((top - len(self._hist),), np.int64)])
            # Rows are unique-sorted, so a flat bincount is presence counting.
            self._hist += sign * np.bincount(real, minlength=len(self._hist)
                                             ).astype(np.int64)
        self._churn += n
        if sign > 0:
            self._ingested_since_refresh += n
        else:
            self._evicted_since_refresh += n
        if self._refresh_job is not None:
            self._refresh_job["log"].append((sign, padded))
        self._dispatch_deltas(padded, sign)

    def _dispatch_deltas(self, padded: np.ndarray, sign: int) -> None:
        """Dispatch one block's per-level delta jobs (async, grouped into a
        single record so the block joins atomically)."""
        if not self._levels or padded.shape[0] == 0:
            return
        if not (padded < ITEM_PAD).any():
            return  # all-empty transactions support nothing: exact no-op
        enc = None
        jobs: List[Tuple[int, object]] = []
        for k, tl in self._levels.items():
            if tl.cand.size:
                if enc is None:
                    enc = self.runner.encode_block(padded, self._item_map)
                jobs.append((k, self.runner.count_block_async(enc, tl.cand)))
                self.delta_jobs += 1
        if jobs:
            self._pending_deltas.append((sign, padded.shape[0], jobs))

    def _undrained(self) -> int:
        """Transactions whose delta blocks are dispatched but not joined:
        the volume every certificate's drift bound is derived from."""
        return sum(n for _, n, _ in self._pending_deltas)

    def _drain_deltas(self, block: bool = True) -> None:
        """Join outstanding delta jobs into the tracked counts.

        ``block=False`` joins only the leading records whose every per-level
        job has already finished on the device (``poll``), so it never
        blocks.
        """
        while self._pending_deltas:
            sign, n, jobs = self._pending_deltas[0]
            if not block and not all(p.poll() for _, p in jobs):
                break
            for k, pend in jobs:
                self._levels[k].counts += sign * pend.result()
            self._drained_since_compact += n
            self._pending_deltas.pop(0)
        if not self._pending_deltas:
            self._maybe_compact()

    # -- lattice compaction --------------------------------------------------
    def _maybe_compact(self) -> None:
        if (not self.compact_churn or not self._levels
                or not self._refreshed_once):
            return
        if (self._drained_since_compact
                < self.compact_churn * max(1, self._window_n)):
            return
        self._compact()

    def _compact(self) -> None:
        """Prune tracked rows outside the generatable closure at the track
        threshold: a row survives iff every (k-1)-subset is a surviving row
        with *current* count >= ``_track_count_ref``.  Every row a walk at a
        threshold >= the track threshold can generate survives, so
        compaction never creates a staleness escape.  Runs only with no
        pending deltas (their results are sized to the old matrices)."""
        assert not self._pending_deltas
        tc = self._track_count_ref
        prev = np.flatnonzero(
            self._hist[self._item_map] >= tc).astype(np.int32).reshape(-1, 1)
        removed = 0
        for k in sorted(self._levels):
            tl = self._levels[k]
            keep = tracked_keep_mask(tl.cand, prev)
            removed += int(tl.cand.shape[0] - keep.sum())
            cand = tl.cand[keep]          # boolean mask keeps lex order
            counts = tl.counts[keep]
            self._levels[k] = _TrackedLevel(cand, counts)
            prev = cand[counts >= tc]
        self.compactions += 1
        self.compacted_rows += removed
        self._drained_since_compact = 0

    # -- query ---------------------------------------------------------------
    def query(self, min_support: Optional[float] = None,
              staleness: Optional[float] = None) -> ServeResult:
        """Frequent itemsets of the current window.

        ``staleness=None`` (default): exact, equal to a batch mine of
        ``window()``, refreshing (blocking) if needed.  ``staleness=s``: if
        the churn since the last refresh is within ``s * window``, answer
        immediately from current counts with an :class:`ErrorCertificate`;
        beyond the budget, fall back to exact.
        """
        t0 = time.perf_counter()
        ms = self.min_support if min_support is None else float(min_support)
        self._pump_refresh(block=False)
        n = self._window_n
        live = self._refresh_job is not None
        if n == 0:
            return ServeResult(
                itemsets={}, min_count=1, n_transactions=0, refreshed=False,
                stale_reason=None, seconds=time.perf_counter() - t0,
                certificate=ErrorCertificate(0, 1, 0, 0, live),
                refresh_in_flight=live)
        min_count = max(1, int(np.ceil(ms * n)))
        reason: Optional[str] = None
        served: Optional[Dict[Itemset, int]] = None
        cert: Optional[ErrorCertificate] = None
        if not self._refreshed_once:
            reason = "cold"
        elif min_count < self._track_count_ref:
            # The lattice is provably incomplete below its track threshold:
            # refresh at the queried threshold, never walk or approximate.
            reason = "below_track"
        elif staleness is not None:
            if self._churn > float(staleness) * n:
                reason = "drift"     # over the caller's budget: go exact
            else:
                served, cert, reason = self._serve_approx(min_count, n)
        elif self._churn > self.staleness * n:
            reason = "drift"
        else:
            self._drain_deltas()
            served = self._serve_from_tracked(min_count)
            if served is None:
                reason = "untracked"
        refreshed = served is None
        if refreshed:
            served = self._refresh_blocking(min_count)
        live = self._refresh_job is not None
        if cert is None:  # exact answer (tracked walk or fresh refresh)
            cert = ErrorCertificate(0, min_count, 0, self._churn, live)
        return ServeResult(itemsets=served, min_count=min_count,
                           n_transactions=n, refreshed=refreshed,
                           stale_reason=reason,
                           seconds=time.perf_counter() - t0,
                           certificate=cert, refresh_in_flight=live)

    def _serve_approx(self, min_count: int, n: int):
        """Bounded-staleness answer: current counts, skipping untracked
        candidates, plus the certificate bounding both kinds of error.
        Starts a background refresh whenever the exact path would have
        escaped, so served answers converge back to exact."""
        self._drain_deltas(block=False)
        served, skipped = self._serve_stale(min_count)
        undrained = self._undrained()
        miss = min_count + undrained
        if skipped:
            miss = max(miss,
                       self._track_count_ref + self._ingested_since_refresh)
        if self._refresh_job is None and (
                skipped or self._churn > self.staleness * n):
            svc_count = max(1, int(np.ceil(self.min_support * n)))
            self._start_refresh(min(min_count, svc_count))
            self._pump_refresh(block=False)
        cert = ErrorCertificate(
            max_drift=undrained, miss_bound=miss, undrained=undrained,
            churn=self._churn, refresh_in_flight=self._refresh_job is not None)
        reason = "stale" if (skipped or undrained) else None
        if reason == "stale":
            self.stale_served += 1
        return served, cert, reason

    def _serve_from_tracked(self, min_count: int) -> Optional[Dict[Itemset, int]]:
        """Walk the Apriori lattice from the delta-maintained counts; None if
        any generated candidate escapes the tracked lattice (stale)."""
        l1_raw = np.nonzero(self._hist >= min_count)[0]
        # Raw ids outside the refresh item map resolve to -1 through the
        # lookup's guard slot: a newly frequent item is a staleness signal.
        dense = self._lookup[np.minimum(l1_raw, len(self._lookup) - 1)]
        if (dense < 0).any():
            return None
        result: Dict[Itemset, int] = {
            (int(r),): int(self._hist[r]) for r in l1_raw}
        # item_map is sorted, so dense ids inherit l1_raw's ascending order.
        level = dense.astype(np.int32).reshape(-1, 1)
        k = 2
        while level.size and k <= self.max_k:
            cand = apriori_gen_matrix(level)
            if cand.size == 0:
                break
            tl = self._levels.get(k)
            if tl is None:
                return None  # the refresh lattice never reached this depth
            rows = tl.rows_of(cand)
            if (rows < 0).any():
                return None  # candidate born after the refresh: stale
            counts = tl.counts[rows]
            keep = counts >= min_count
            level = cand[keep]
            for row, c in zip(level, counts[keep]):
                result[tuple(int(self._item_map[i]) for i in row)] = int(c)
            k += 1
        return result

    def _serve_stale(self, min_count: int):
        """The approximate walk: like ``_serve_from_tracked`` but *skips*
        untracked candidates, counting every skip so the certificate can
        widen ``miss_bound``.  L1 comes from the exact histogram (unmapped
        frequent items included), so level 1 is always exact."""
        l1_raw = np.nonzero(self._hist >= min_count)[0]
        result: Dict[Itemset, int] = {
            (int(r),): int(self._hist[r]) for r in l1_raw}
        dense = self._lookup[np.minimum(l1_raw, len(self._lookup) - 1)]
        skipped = int((dense < 0).sum())  # unmapped items: supersets unseen
        level = dense[dense >= 0].astype(np.int32).reshape(-1, 1)
        k = 2
        while level.size and k <= self.max_k:
            cand = apriori_gen_matrix(level)
            if cand.size == 0:
                break
            tl = self._levels.get(k)
            if tl is None or tl.cand.size == 0:
                skipped += int(cand.shape[0])
                break
            rows = tl.rows_of(cand)
            tracked = rows >= 0
            skipped += int((~tracked).sum())
            counts = np.zeros((cand.shape[0],), np.int64)
            counts[tracked] = tl.counts[rows[tracked]]
            keep = tracked & (counts >= min_count)
            level = cand[keep]
            for row, c in zip(level, counts[keep]):
                result[tuple(int(self._item_map[i]) for i in row)] = int(c)
            k += 1
        return result, skipped

    # -- refresh: cooperative state machine ----------------------------------
    def refresh_async(self, min_support: Optional[float] = None) -> bool:
        """Start (or advance) a background lattice refresh; never blocks.
        Returns True while a refresh remains in flight after the call."""
        if self._window_n == 0:
            return False
        ms = self.min_support if min_support is None else float(min_support)
        if self._refresh_job is None:
            self._start_refresh(max(1, int(np.ceil(ms * self._window_n))))
        self._pump_refresh(block=False)
        return self._refresh_job is not None

    def _start_refresh(self, min_count: int) -> None:
        job = {
            "min_count": int(min_count),
            "track_count": max(1, int(np.ceil(self.margin * min_count))),
            "log": [],       # (sign, padded) blocks applied mid-refresh
            "waiting": None,  # the handle the generator is parked on
        }
        job["gen"] = self._refresh_gen(job)
        self._refresh_job = job

    def _abort_refresh(self) -> None:
        job, self._refresh_job = self._refresh_job, None
        if job is not None:
            job["gen"].close()

    def _pump_refresh(self, block: bool = False) -> bool:
        """Advance the in-flight refresh: one unit per non-blocking call, or
        run to handoff when blocking.  Returns True iff the refresh
        completed (handoff done) in this call."""
        job = self._refresh_job
        if job is None:
            return False
        gen = job["gen"]
        while True:
            waiting = job["waiting"]
            if waiting is not None and not block and not waiting.poll():
                return False
            job["waiting"] = None
            try:
                job["waiting"] = next(gen)
            except StopIteration:
                self._handoff(job)
                return True
            except BaseException:
                self._refresh_job = None
                raise
            if not block:
                return False

    def _refresh_gen(self, job: dict):
        """The refresh state machine: yields ``None`` after a bounded unit
        of host/device work, or a pending wave handle to park on.  Runs over
        the *snapshot* window taken at start; blocks applied after the
        snapshot land in ``job["log"]`` and are replayed at handoff."""
        runner = self.runner
        track_count = job["track_count"]
        # Unit 1: join outstanding old-lattice deltas and take the window
        # snapshot + host ingest pass.
        self._drain_deltas()
        hist_snap = self._hist.copy()
        runner.ingest(self.window())
        yield None
        # Unit 2: device Job1 + placement.  The drain directly before
        # place() is load-bearing: place() abandons every outstanding engine
        # handle, delta handles included, so any delta dispatched since
        # unit 1 must be joined first (no yield between drain and place).
        hist, _ = runner.job1()
        self._check_hist(hist, hist_snap)
        item_map = np.nonzero(hist >= track_count)[0].astype(np.int64)
        job["item_map"] = item_map
        self._drain_deltas()
        runner.place(item_map)
        yield None
        level = np.arange(len(item_map), dtype=np.int32).reshape(-1, 1)
        if self.device_loop and level.size:
            levels = yield from self._ladder_gen(level, track_count)
        else:
            levels = {}
            k = 2
            cand = apriori_gen_matrix(level)
            while cand.size and k <= self.max_k:
                pend = runner.count_async(CountJob(
                    k=k, cand=cand, min_count=track_count, level=level))
                yield pend
                counts, _prof = pend.result()
                levels[k] = _TrackedLevel(cand, counts)
                level = cand[counts >= track_count]
                cand = apriori_gen_matrix(level)
                k += 1
        job["levels"] = levels

    def _ladder_gen(self, level: np.ndarray, track_count: int):
        """Ladder-mode refresh: the fused ``LevelLadder`` (optionally with
        on-device trimming) mines the margin-frequent lattice one level per
        unit; the negative border (the candidates the ladder pruned) is then
        counted through the wave pipeline so the tracked lattice is
        complete.  Counts are exact either way, so both refresh modes give
        the same lattice."""
        from repro_torch.core.itemsets import _rows_member
        from repro_torch.core.runtime import device_loop as _dl

        freq_by_k: Dict[int, Dict[Itemset, int]] = {}
        for prof, freq in _dl.ladder(self.runner, level, track_count,
                                     start_k=2, max_k=self.max_k,
                                     trim=self.trim):
            freq_by_k[prof.k] = freq
            yield None
        # Border waves ride the async FIFO back to back: wave k+1's host-side
        # generation overlaps wave k's device count.
        waves = []
        prev = level
        k = 2
        while prev.size and k <= self.max_k:
            cand = apriori_gen_matrix(prev)
            if cand.size == 0:
                break
            freq = freq_by_k.get(k, {})
            fmat = level_to_matrix(list(freq))
            member = (_rows_member(fmat, cand) if fmat.size
                      else np.zeros((cand.shape[0],), bool))
            border = cand[~member]
            pend = self.runner.count_async(CountJob(
                k=k, cand=border, min_count=track_count,
                level=prev)) if border.size else None
            waves.append((k, cand, member, freq, pend))
            prev = fmat
            k += 1
        levels: Dict[int, _TrackedLevel] = {}
        for k, cand, member, freq, pend in waves:
            counts = np.zeros((cand.shape[0],), np.int64)
            for i in np.flatnonzero(member):
                counts[i] = freq[tuple(int(x) for x in cand[i])]
            if pend is not None:
                yield pend
                bcounts, _prof = pend.result()
                counts[~member] = bcounts
            levels[k] = _TrackedLevel(cand, counts)
        return levels

    def _handoff(self, job: dict) -> None:
        """Install the freshly mined lattice and replay everything that
        arrived while the refresh was in flight: old-lattice delta handles
        are discarded whole, and each logged block reaches the new lattice
        through a fresh signed dispatch over the new item map."""
        item_map = job["item_map"]
        self._item_map = item_map
        lookup = np.full((len(self._hist) + 1,), -1, np.int64)
        if len(item_map):
            lookup[item_map] = np.arange(len(item_map), dtype=np.int64)
        self._lookup = lookup
        self._levels = job["levels"]
        self._track_count_ref = int(job["track_count"])
        self._pending_deltas = []  # old-lattice handles: discarded whole
        self._refresh_job = None
        self._churn = 0
        self._ingested_since_refresh = 0
        self._evicted_since_refresh = 0
        for sign, padded in job["log"]:
            n = padded.shape[0]
            self._churn += n
            if sign > 0:
                self._ingested_since_refresh += n
            else:
                self._evicted_since_refresh += n
            self._dispatch_deltas(padded, sign)
        self._refreshed_once = True
        self._drained_since_compact = 0
        self.refreshes += 1

    def _refresh_blocking(self, min_count: int) -> Dict[Itemset, int]:
        """Exact escape path: ride a compatible in-flight refresh to its
        handoff, or run a fresh one to completion, then serve from the new
        lattice."""
        job = self._refresh_job
        if job is not None and job["track_count"] <= min_count:
            self._pump_refresh(block=True)
            self._drain_deltas()
            served = self._serve_from_tracked(min_count)
            if served is not None:
                return served
            # Mid-refresh churn outran the ridden lattice: mine fresh below.
        self._abort_refresh()
        self._start_refresh(min_count)
        self._pump_refresh(block=True)
        self._drain_deltas()
        served = self._serve_from_tracked(min_count)
        if served is None:  # cannot happen: no churn since the handoff
            raise AssertionError(
                "freshly refreshed lattice failed to serve its own threshold")
        return served

    def _check_hist(self, hist: np.ndarray,
                    ref: Optional[np.ndarray] = None) -> None:
        """Self-check: the device Job1 over the (snapshot) window must equal
        the delta-maintained histogram, the additivity invariant the whole
        serving path rests on."""
        h = self._hist if ref is None else ref
        m = len(hist)
        if not (np.array_equal(h[:m], hist[:m])
                and not h[m:].any() and not hist[m:].any()):
            raise AssertionError(
                "delta-maintained histogram diverged from the window Job1 "
                "histogram — the additivity invariant is broken")

    # -- telemetry -----------------------------------------------------------
    def stats(self) -> dict:
        return {
            "window": self._window_n,
            "slots": len(self._slots),
            "refreshes": self.refreshes,
            "delta_jobs": self.delta_jobs,
            "pending_deltas": len(self._pending_deltas),
            "undrained": self._undrained(),
            "total_ingested": self.total_ingested,
            "total_evicted": self.total_evicted,
            "tracked_levels": sorted(self._levels),
            "tracked_candidates": int(sum(
                tl.cand.shape[0] for tl in self._levels.values())),
            "track_count_ref": self._track_count_ref,
            "stale_served": self.stale_served,
            "compactions": self.compactions,
            "compacted_rows": self.compacted_rows,
            "refresh_in_flight": self._refresh_job is not None,
        }
