"""Execution backends behind one runner interface (PyTorch port).

A runner owns job execution only — drivers own *what* to count, runners own
*how*:

``ingest(transactions)``   take the raw database (original item ids);
``job1()``                 the 1-itemset histogram job -> (hist, JobProfile);
``place(item_map)``        dense re-encode over the frequent items and make
                           the DB resident for counting jobs;
``count_async(job)``       submit a ``CountJob``; the returned handle's
                           ``result()`` -> (int64[C] counts, JobProfile).

``SimRunner`` is the paper's Hadoop cluster model over the Java-equivalent
structures (``core/sequential``): every Job2 mapper re-runs apriori-gen and
rebuilds its candidate structure (the paper's per-iteration fixed cost), and
the profile keeps per-mapper wall clocks so ``JobProfile.parallel_seconds``
reproduces the ``max(mappers) + reduce`` cluster model.  By default mappers
run sequentially (timed individually); ``executor=`` runs them on a real
``concurrent.futures`` thread or process pool instead.  Partial counts merge
in mapper-slot order either way, so pooled counts are exactly the sequential
counts.  Its mappers are plain Python: they hold no tensor and never touch
the device, so a pool forked from a process that holds a CUDA context stays
safe.

``TorchRunner`` is the counterpart of the JAX package's ``JaxRunner``.
Given a ``ChunkedDatasetReader`` instead of transaction lists, it mines out
of core: nothing is materialised, Job1 and every counting job stream the
reader's chunks (``encode_block`` plus the engine's ``count_block_async``
per chunk) and sum the per-chunk counts.  ``ShardedRunner`` is the same
runner over a ``DeviceMesh`` of ``torch.distributed`` ranks (one rank per
device): transactions shard over ``data`` and, with ``cand_axes``, each
wave's candidates over ``cand`` (see ``engine.py``).

Fault tolerance (``fault_plan=`` / ``retry=``, see ``runtime/faults.py``):
``SimRunner`` recovers from task failures the way Hadoop does — every mapper
attempt is digest-checked and, on a crash or corrupted partial, retried with
exponential backoff up to ``RetryPolicy.max_attempts``; stragglers get a
speculative backup copy whose first result wins.  ``TorchRunner`` consults
the plan at job dispatch: ``process_exit`` kills the process whose rank it
names, ``device_loss`` abandons the engine's outstanding work and raises
``DeviceLostError``, from which a new miner resumes at its level
checkpoint (on a mesh, the miner first rebuilds a smaller one).  Every
runner is a context manager; ``close()`` is guaranteed even when a mapper
raises mid-job (no leaked process pools).
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.itemsets import (
    apriori_gen,
    filter_candidates_matrix,
    matrix_to_level,
)
from repro_torch.core.runtime.cache import DATASET_CACHE, dataset_digest
from repro_torch.core.runtime.device_loop import filter_candidates_device
from repro_torch.core.runtime.engine import MapReduceEngine
from repro_torch.core.runtime.faults import (
    DEFAULT_RETRY,
    DeviceLostError,
    FaultAction,
    FaultPlan,
    JobFailedError,
    MapperCrashError,
    PartialCorruptionError,
    RetryPolicy,
    corrupt_partial,
    partial_digest,
    process_rank,
)
from repro_torch.core.runtime.job import CountJob, JobProfile
from repro_torch.core.sequential import SEQUENTIAL_STORES
from repro_torch.core.stores import (
    EncodedDB, encode_db_from_padded, padded_from_transactions)
from repro_torch.core.stores.base import dense_remap_padded
from repro_torch.trace import span


def _chunks(transactions: Sequence[Sequence[int]], n_mappers: int):
    """Split the DB into exactly ``n_mappers`` input splits (sizes differ by
    at most one, empty splits allowed), so ``JobProfile.parallel_seconds``
    models an m-slot cluster with every slot represented."""
    n = len(transactions)
    base, extra = divmod(n, n_mappers)
    out, start = [], 0
    for i in range(n_mappers):
        size = base + (1 if i < extra else 0)
        out.append(transactions[start : start + size])
        start += size
    return out


# -- mapper bodies ----------------------------------------------------------
# Module-level functions (not methods) so a process-pool executor can pickle
# them; each returns its own phase timings measured inside the worker.

def _job1_mapper(chunk) -> Tuple[Dict[int, int], float]:
    """OneItemsetMapper + in-chunk combiner (Algorithm 2)."""
    t0 = time.perf_counter()
    local: Dict[int, int] = {}
    for t in chunk:
        for item in set(t):
            local[int(item)] = local.get(int(item), 0) + 1  # combiner folded in
    return local, time.perf_counter() - t0


def _job2_mapper(chunk, store_cls, structure: str, child_max_size: int,
                 level, cand_rows):
    """One Job2 mapper (Algorithm 3): gen + build + chunk count, phase-timed.

    ``level is not None``: the mapper re-generates C_k from the cached
    L_{k-1} and builds its own structure — the paper's per-mapper fixed
    cost.  ``level is None`` (speculative FPC/DPC wave): C_k ships via
    distributed cache and only the structure build is paid.
    """
    t0 = time.perf_counter()
    if level is not None:
        _, store, gen_s, build_s = _generate_and_build(
            store_cls, structure, level, child_max_size
        )
    else:
        gen_s = 0.0
        t1 = time.perf_counter()
        if structure == "hash_tree":
            store = store_cls(cand_rows, child_max_size=child_max_size)
        else:
            store = store_cls(cand_rows)
        build_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    for t in chunk:
        store.count_transaction(t)
    local = {s: c for s, c in store.counts().items() if c > 0}
    count_s = time.perf_counter() - t1
    return local, gen_s, build_s, count_s, time.perf_counter() - t0


def _generate_and_build(store_cls, structure: str, level, child_max_size: int):
    """One mapper's per-iteration fixed cost, phase-timed.

    The hash tree consumes an externally generated C_k (Algorithm 4); the
    trie family generates C_k from its own L_{k-1} structure.
    """
    t0 = time.perf_counter()
    if structure == "hash_tree":
        cands = apriori_gen(level)
        gen_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        store = store_cls(cands, child_max_size=child_max_size)
    else:
        cands = store_cls(level).generate_candidates()
        gen_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        store = store_cls(cands)
    return cands, store, gen_s, time.perf_counter() - t1


def _guarded_mapper(action: Optional[FaultAction], fn, args):
    """Run one mapper task attempt under an optional fault order.

    Returns ``(result, digest)`` where ``digest`` is the integrity hash of
    the partial counts taken *inside the worker* — corruption is applied
    after the digest, modelling a torn shuffle transfer, so the host-side
    re-hash catches it.  Module-level (and ``FaultAction`` a frozen
    dataclass) so process pools can pickle the whole task.
    """
    if action is not None and action.kind == "crash":
        raise MapperCrashError("injected mapper crash")
    if action is not None and action.kind == "hang":
        time.sleep(action.delay)
    out = fn(*args)
    digest = partial_digest(out[0])
    if action is not None and action.kind == "corrupt":
        out = (corrupt_partial(out[0], action.seed),) + tuple(out[1:])
    return out, digest


class _MapTelemetry:
    """Per-job recovery counters a mapper wave fills in (-> JobProfile)."""

    __slots__ = ("retries", "speculative_launches", "speculative_wins",
                 "backoff_seconds")

    def __init__(self) -> None:
        self.retries = 0
        self.speculative_launches = 0
        self.speculative_wins = 0
        self.backoff_seconds = 0.0

    def fill(self, prof: JobProfile) -> JobProfile:
        prof.retries = self.retries
        prof.speculative_launches = self.speculative_launches
        prof.speculative_wins = self.speculative_wins
        prof.backoff_seconds = self.backoff_seconds
        return prof


class _Done:
    """Completed-job handle: sync backends return results immediately."""

    def __init__(self, counts: np.ndarray, profile: JobProfile) -> None:
        self._out = (counts, profile)

    def poll(self) -> bool:
        return True

    def result(self) -> Tuple[np.ndarray, JobProfile]:
        return self._out


class BaseRunner:
    kind = "base"
    supports_async = False  # True => count_async overlaps with host work

    def describe(self) -> str:
        raise NotImplementedError

    def config_signature(self) -> str:
        """The backend identity a checkpoint is stamped with.  Unlike
        ``describe()`` it must be stable across changes that never alter
        results (mapper slots, executor mode, block sizes) while still
        rejecting resumes across a different backend kind, store, or
        structure."""
        return self.describe()

    def close(self, wait: bool = True) -> None:
        """Release runner-owned resources (pools, dispatch queues)."""

    def __enter__(self) -> "BaseRunner":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        # A crashed job must not leak pools: close without waiting on
        # still-running (possibly hung) mapper attempts.
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


class SimRunner(BaseRunner):
    """The paper's Hadoop cluster cost model over the Java-equivalent stores.

    ``executor=None`` (default) runs mappers sequentially, timed individually
    — the simulated cluster.  ``executor="thread"`` / ``"process"`` runs each
    job's mappers concurrently on a ``concurrent.futures`` pool of
    ``n_mappers`` workers (a caller-owned ``Executor`` instance is also
    accepted), so ``JobProfile.seconds`` becomes *measured* concurrent wall
    time while ``parallel_seconds`` keeps the ``max(mappers) + reduce``
    model — the two are directly comparable per job.  Counts are identical
    in every mode: partials merge in mapper-slot order.
    """

    kind = "sim"
    supports_async = False

    def __init__(self, structure: str = "trie", n_mappers: int = 4,
                 child_max_size: int = 20, executor=None,
                 retry: Optional[RetryPolicy] = DEFAULT_RETRY,
                 fault_plan: Optional[FaultPlan] = None) -> None:
        if structure not in SEQUENTIAL_STORES:
            raise ValueError(f"unknown structure {structure!r}")
        if isinstance(executor, str) and executor not in ("thread", "process"):
            raise ValueError(
                f"unknown executor {executor!r}; pick 'thread', 'process', "
                "None, or pass a concurrent.futures.Executor"
            )
        self.structure = structure
        self.store_cls = SEQUENTIAL_STORES[structure]
        self.n_mappers = n_mappers
        self.child_max_size = child_max_size
        self.executor = executor
        # retry=None disables the recovery layer entirely (no digests, no
        # fault consultation beyond injection) — the pre-fault-tolerance
        # fast path, kept for the robustness-tax benchmark.
        self.retry = retry
        self.fault_plan = fault_plan
        self._pool = None
        self._owns_pool = False
        self._raw: Optional[Sequence[Sequence[int]]] = None
        self._chunks_raw: Optional[List[Sequence[Sequence[int]]]] = None
        self._item_map: Optional[np.ndarray] = None
        self._n_raw = 0

    def describe(self) -> str:
        base = f"sim/{self.structure}/m{self.n_mappers}"
        if self.executor is None:
            return base
        mode = self.executor if isinstance(self.executor, str) else "pool"
        return f"{base}+{mode}"

    def config_signature(self) -> str:
        # Mapper-slot count and executor mode never change *results*, only
        # the cost model — a resumed run on a reprovisioned cluster (more or
        # fewer slots) is legitimate, exactly like Hadoop job restart.
        return f"sim/{self.structure}"

    # -- mapper execution: sequential loop or real concurrency --------------
    def _ensure_pool(self):
        if self._pool is None:
            import concurrent.futures as cf

            if self.executor == "thread":
                self._pool = cf.ThreadPoolExecutor(max_workers=self.n_mappers)
                self._owns_pool = True
            elif self.executor == "process":
                self._pool = cf.ProcessPoolExecutor(max_workers=self.n_mappers)
                self._owns_pool = True
            else:
                self._pool = self.executor
        return self._pool

    def close(self, wait: bool = True) -> None:
        """Shut down a pool this runner created (no-op otherwise).

        ``wait=False`` abandons still-running attempts (a failed job must
        not block on its own hung stragglers); queued tasks are cancelled.
        """
        if self._owns_pool and self._pool is not None:
            self._pool.shutdown(wait=wait, cancel_futures=True)
            self._pool = None
            self._owns_pool = False

    # -- the task-recovery scheduler ----------------------------------------
    def _map(self, fn, tasks: List[tuple], k: int = 0,
             tele: Optional[_MapTelemetry] = None) -> List:
        """Run one job's mapper wave; results come back in mapper-slot order
        regardless of executor scheduling, retries, or speculation, so the
        reduce merge — and therefore every count — is deterministic.

        With ``retry`` set this is a miniature Hadoop task scheduler: each
        slot's attempt is digest-validated; crashes and corrupted partials
        are retried with exponential backoff up to ``max_attempts``;
        stragglers (pooled executors) get a speculative backup whose first
        result wins.  A job that exhausts a slot's attempts raises
        ``JobFailedError`` — and in *every* failure mode the runner-owned
        pool is closed rather than leaked.
        """
        tele = tele if tele is not None else _MapTelemetry()
        try:
            if self.retry is None:
                return self._map_plain(fn, tasks, k)
            if self.executor is None:
                return self._map_sequential(fn, tasks, k, tele)
            return self._map_pooled(fn, tasks, k, tele)
        except BaseException:
            self.close(wait=False)
            raise

    def _action(self, k: int, slot: int, attempt: int) -> Optional[FaultAction]:
        if self.fault_plan is None:
            return None
        return self.fault_plan.mapper_action(k=k, slot=slot, attempt=attempt)

    def _map_plain(self, fn, tasks: List[tuple], k: int) -> List:
        """Recovery disabled: faults (if any) are injected but not caught —
        a crash propagates and the pool is closed by ``_map``'s guard."""
        if self.executor is None and self.fault_plan is None:
            return [fn(*args) for args in tasks]
        if self.executor is None:
            return [_guarded_mapper(self._action(k, s, 0), fn, args)[0]
                    for s, args in enumerate(tasks)]
        pool = self._ensure_pool()
        futs = [pool.submit(_guarded_mapper, self._action(k, s, 0), fn, args)
                for s, args in enumerate(tasks)]
        return [f.result()[0] for f in futs]

    def _map_sequential(self, fn, tasks: List[tuple], k: int,
                        tele: _MapTelemetry) -> List:
        """Single-threaded recovery loop (the simulated cluster).  A hang
        longer than the policy timeout models Hadoop's speculative kill:
        the scheduler waits out the timeout window, charges a speculative
        launch, and re-runs the attempt instead of sleeping the full hang.
        """
        policy = self.retry
        results = []
        for slot, args in enumerate(tasks):
            attempt = 0
            while True:
                if attempt >= policy.max_attempts:
                    raise JobFailedError(
                        f"mapper slot {slot} of level-{k} job failed "
                        f"{policy.max_attempts} attempts")
                action = self._action(k, slot, attempt)
                if (action is not None and action.kind == "hang"
                        and policy.speculation and policy.timeout is not None
                        and action.delay > policy.timeout):
                    time.sleep(policy.timeout)  # the window the cluster waits
                    tele.speculative_launches += 1
                    tele.speculative_wins += 1
                    attempt += 1
                    continue
                try:
                    out, digest = _guarded_mapper(action, fn, args)
                    if partial_digest(out[0]) != digest:
                        raise PartialCorruptionError(
                            f"slot {slot} partial counts failed digest")
                    results.append(out)
                    break
                except (MapperCrashError, PartialCorruptionError):
                    tele.retries += 1
                    attempt += 1
                    if attempt < policy.max_attempts:
                        b = policy.backoff * policy.backoff_factor ** (attempt - 1)
                        tele.backoff_seconds += b
                        time.sleep(b)
        return results

    def _map_pooled(self, fn, tasks: List[tuple], k: int,
                    tele: _MapTelemetry) -> List:
        """Concurrent recovery scheduler over the executor pool: bounded
        retry with backoff plus speculative re-execution of stragglers.
        First result per slot wins; late duplicates are discarded, so the
        merged counts are exactly the sequential counts."""
        import concurrent.futures as cf

        policy = self.retry
        pool = self._ensure_pool()
        n = len(tasks)
        results: List = [None] * n
        settled = [False] * n
        attempts = [0] * n
        backups = [False] * n
        inflight: Dict = {}  # future -> (slot, speculative, t_submit)
        durations: List[float] = []

        def submit(slot: int, speculative: bool = False) -> None:
            action = self._action(k, slot, attempts[slot])
            attempts[slot] += 1
            fut = pool.submit(_guarded_mapper, action, fn, tasks[slot])
            inflight[fut] = (slot, speculative, time.perf_counter())

        def straggler_threshold() -> Optional[float]:
            if policy.timeout is not None:
                return policy.timeout
            if not policy.speculation or len(durations) < max(1, n // 2):
                return None  # not enough signal for the dynamic threshold
            med = float(np.median(durations))
            return max(policy.speculation_min_wait,
                       policy.speculation_factor * med)

        for slot in range(n):
            submit(slot)
        while not all(settled):
            done, _ = cf.wait(list(inflight), timeout=0.02,
                              return_when=cf.FIRST_COMPLETED)
            for fut in done:
                slot, speculative, t0 = inflight.pop(fut)
                try:
                    out, digest = fut.result()
                    if partial_digest(out[0]) != digest:
                        raise PartialCorruptionError(
                            f"slot {slot} partial counts failed digest")
                except (MapperCrashError, PartialCorruptionError):
                    if settled[slot]:
                        continue  # another attempt already delivered
                    tele.retries += 1
                    others = any(s == slot for s, _, _ in inflight.values())
                    if attempts[slot] >= policy.max_attempts:
                        if others:
                            continue  # a live attempt may still save the slot
                        raise JobFailedError(
                            f"mapper slot {slot} of level-{k} job failed "
                            f"{policy.max_attempts} attempts")
                    b = policy.backoff * policy.backoff_factor ** (
                        attempts[slot] - 1)
                    tele.backoff_seconds += b
                    time.sleep(b)
                    backups[slot] = False  # the retry may straggle anew
                    submit(slot)
                    continue
                if not settled[slot]:  # first result wins
                    settled[slot] = True
                    results[slot] = out
                    durations.append(time.perf_counter() - t0)
                    if speculative:
                        tele.speculative_wins += 1
                # else: duplicate from original/backup race — discarded
            threshold = straggler_threshold()
            if threshold is None:
                continue
            now = time.perf_counter()
            for fut, (slot, _, t0) in list(inflight.items()):
                if (not settled[slot] and not backups[slot]
                        and now - t0 > threshold
                        and attempts[slot] < policy.max_attempts):
                    backups[slot] = True
                    tele.speculative_launches += 1
                    submit(slot, speculative=True)
        return results

    def ingest(self, transactions: Sequence[Sequence[int]]) -> None:
        if _as_reader(transactions) is not None:
            raise TypeError(
                "out-of-core chunked ingestion needs an engine-backed "
                "runner (torch); SimRunner models the Hadoop "
                "cluster over in-memory input splits"
            )
        self._raw = transactions
        self._n_raw = max((max(t) for t in transactions if len(t)), default=-1) + 1
        self._chunks_raw = None  # stale until the next place(item_map)
        self._item_map = None

    # -- Job1: OneItemsetMapper + combiner + reducer (Algorithm 2) ----------
    def job1(self) -> Tuple[np.ndarray, JobProfile]:
        t_job = time.perf_counter()
        tele = _MapTelemetry()
        results = self._map(
            _job1_mapper, [(c,) for c in _chunks(self._raw, self.n_mappers)],
            k=1, tele=tele,
        )
        partials = [local for local, _ in results]
        mapper_times = [sec for _, sec in results]
        t0 = time.perf_counter()
        hist = np.zeros((self._n_raw,), np.int64)
        for local in partials:
            for item, c in local.items():
                hist[item] += c
        reduce_s = time.perf_counter() - t0
        prof = tele.fill(JobProfile(
            k=1, n_candidates=int(np.count_nonzero(hist)),
            seconds=time.perf_counter() - t_job,
            count_seconds=max(mapper_times, default=0.0),
            reduce_seconds=reduce_s, mapper_seconds=mapper_times,
        ))
        return hist, prof

    def place(self, item_map: np.ndarray) -> None:
        # Mappers stay faithful to Algorithm 3 and consume the *raw*
        # transaction chunks (infrequent items included, exactly the workload
        # the paper's cluster measures). The driver's dense-id jobs are
        # translated to original ids at the (small) candidate matrix instead
        # — item_map is sorted ascending, so translation preserves the
        # canonical lexicographic row order.
        self._item_map = np.asarray(item_map, np.int64)
        self._chunks_raw = _chunks(self._raw, self.n_mappers)

    # -- Job2 (Algorithm 3): per-mapper gen + build + count, global reduce --
    def count_async(self, job: CountJob) -> _Done:
        return _Done(*self.count(job))

    def count(self, job: CountJob) -> Tuple[np.ndarray, JobProfile]:
        assert self._chunks_raw is not None, "call place(item_map) first"
        t_job = time.perf_counter()
        cand_rows = matrix_to_level(self._item_map[job.cand]
                                    if job.cand.size else job.cand)
        level = matrix_to_level(self._item_map[job.level]) if (
            job.level is not None and job.level.size) else None
        tele = _MapTelemetry()
        results = self._map(_job2_mapper, [
            (chunk, self.store_cls, self.structure, self.child_max_size,
             level, cand_rows)
            for chunk in self._chunks_raw
        ], k=job.k, tele=tele)
        partials = [local for local, _, _, _, _ in results]
        gen_times = [g for _, g, _, _, _ in results]
        build_times = [b for _, _, b, _, _ in results]
        count_times = [c for _, _, _, c, _ in results]
        mapper_times = [m for _, _, _, _, m in results]
        t0 = time.perf_counter()
        index = {s: i for i, s in enumerate(cand_rows)}
        counts = np.zeros((len(cand_rows),), np.int64)
        for local in partials:
            for s, c in local.items():
                i = index.get(s)
                if i is not None:
                    counts[i] += c
        reduce_s = time.perf_counter() - t0
        prof = tele.fill(JobProfile(
            k=job.k, n_candidates=len(cand_rows),
            seconds=time.perf_counter() - t_job,
            gen_seconds=max(gen_times, default=0.0),
            build_seconds=max(build_times, default=0.0),
            count_seconds=max(count_times, default=0.0),
            reduce_seconds=reduce_s, mapper_seconds=mapper_times,
        ))
        return counts, prof


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
    """MapReduce runner on PyTorch (array-layout stores), on one device or,
    given a ``mesh``, this rank's share of it — the counterpart of the JAX
    package's ``JaxRunner``.  ``device=None`` is the mesh's device type,
    else ``"cuda"``."""

    kind = "torch"

    @property
    def supports_async(self) -> bool:
        # inflight=0 forces every chunk during dispatch (fully synchronous),
        # so speculative host-side generation would be pure wasted work.
        return self.engine.inflight > 0

    def __init__(self, store: str = "perfect_hash", block_n: int = 2048,
                 cand_block: int = 32_768, inflight: Optional[int] = 1,
                 encode_ahead: int = 2,
                 fault_plan: Optional[FaultPlan] = None,
                 device=None, mesh=None,
                 data_axes: Tuple[str, ...] = ("data",),
                 cand_axes: Tuple[str, ...] = ()) -> None:
        self.engine = MapReduceEngine(
            store=store, block_n=block_n, cand_block=cand_block,
            inflight=inflight, encode_ahead=encode_ahead, device=device,
            mesh=mesh, data_axes=data_axes, cand_axes=cand_axes)
        self.fault_plan = fault_plan
        self._padded_raw: Optional[np.ndarray] = None
        self._n_raw = 0
        self._raw_digest: Optional[str] = None
        self._reader = None  # a ChunkedDatasetReader when mining out of core
        self._chunk_item_map: Optional[np.ndarray] = None

    def describe(self) -> str:
        base = f"{self.kind}/{self.engine.store_name}"
        if self.engine.cand_axes:
            base += f"/c{self.engine.n_cand_shards}"
        return base

    def config_signature(self) -> str:
        # Block sizes, queue depths and mesh geometry never change counts,
        # so a resume (an elastic one on a shrunk mesh included) may pick
        # other ones; the store and the backend kind must match.
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
        with span("repro_torch.runner.job1"):
            t0 = time.perf_counter()
            if self._reader is not None:
                # Per-chunk device histograms summed on the host: a bincount
                # is additive over disjoint blocks, so this equals the
                # whole-DB job.
                hist = np.zeros((self._n_raw,), np.int64)
                n_chunks = 0
                for chunk in self._reader.chunks():
                    hist += self.engine.count_items_device(chunk, self._n_raw)
                    n_chunks += 1
                wall = time.perf_counter() - t0
                prof = JobProfile(
                    k=1, n_candidates=int(np.count_nonzero(hist)),
                    seconds=wall, count_seconds=wall, chunks=n_chunks)
                return hist, prof
            hist = self.engine.count_items_device(self._padded_raw,
                                                  self._n_raw)
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
        with span("repro_torch.runner.place.encode"):
            if self._raw_digest is None:
                self._raw_digest = dataset_digest(self._padded_raw)
            item_arr = np.asarray(item_map, np.int64)
            f_pad = ((len(item_arr) // 128) + 1) * 128  # EncodedDB's F_pad
            key = (self._raw_digest, self.engine.store_name, f_pad,
                   dataset_digest(item_arr))
            enc = DATASET_CACHE.get_or_build(
                key, lambda: self._encode(item_arr))
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
        if self.fault_plan is not None:
            if self.fault_plan.process_exit(
                    k=job.k, process=process_rank()) is not None:
                # A killed host: no cleanup, no exception.  A rerun resumes
                # from the level checkpoint.
                os._exit(137)
            spec = self.fault_plan.device_loss(k=job.k)
            if spec is not None:
                # Simulated device loss at job dispatch: outstanding work is
                # abandoned (the real failure voids it too) and the caller
                # resumes from the level checkpoint on a fresh runner.
                self.engine.abandon()
                raise DeviceLostError(lost=spec.lost, k=job.k)
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


class ShardedRunner(TorchRunner):
    """Mesh-parallel runner: transactions sharded over the data axis,
    per-shard counts ``all_reduce``-d over it — the cluster path.

    ``cand_axes`` switches the wave decomposition to the full 2-D grid: the
    candidate rows of each wave shard over the ``cand`` axis instead of
    replicating, so waves too big for one device fit (at
    ``1/n_cand_shards`` per device); per-shard counts are summed along
    ``data`` and gathered along ``cand``, identical to replication.  With
    no mesh it builds one over the world (``launch/mesh.py``).
    """

    kind = "sharded"

    def __init__(self, store: str = "perfect_hash", mesh=None,
                 data_axes: Tuple[str, ...] = ("data",),
                 cand_axes: Tuple[str, ...] = (), block_n: int = 2048,
                 cand_block: int = 32_768, inflight: Optional[int] = 1,
                 encode_ahead: int = 2,
                 fault_plan: Optional[FaultPlan] = None,
                 device=None) -> None:
        if mesh is None:
            from repro_torch.launch.mesh import (
                make_data_cand_mesh, make_data_mesh)

            build = make_data_cand_mesh if cand_axes else make_data_mesh
            mesh = build(device="cuda" if device is None else device)
        super().__init__(store=store, block_n=block_n, cand_block=cand_block,
                         inflight=inflight, encode_ahead=encode_ahead,
                         fault_plan=fault_plan, device=device, mesh=mesh,
                         data_axes=data_axes, cand_axes=cand_axes)


def make_runner(store: str = "perfect_hash", mesh=None,
                data_axes: Tuple[str, ...] = ("data",),
                cand_axes: Tuple[str, ...] = (), block_n: int = 2048,
                cand_block: int = 32_768, inflight: Optional[int] = 1,
                encode_ahead: int = 2,
                fault_plan: Optional[FaultPlan] = None,
                device=None) -> BaseRunner:
    """Default runner selection for drivers: a mesh or candidate axes mean
    ``ShardedRunner``, else the single-device ``TorchRunner``."""
    if mesh is not None or cand_axes:
        return ShardedRunner(store=store, mesh=mesh, data_axes=data_axes,
                             cand_axes=cand_axes, block_n=block_n,
                             cand_block=cand_block, inflight=inflight,
                             encode_ahead=encode_ahead, fault_plan=fault_plan,
                             device=device)
    return TorchRunner(store=store, block_n=block_n, cand_block=cand_block,
                       inflight=inflight, encode_ahead=encode_ahead,
                       fault_plan=fault_plan, device=device)
