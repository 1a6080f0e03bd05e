"""Sweep-grid plumbing: run one mining workload on several backends, assert
itemset/support identity, and aggregate per-job ``JobProfile`` rows into one
per-cell record.

The paper's contribution is a *grid* — candidate structure x dataset x
min_support x mapper count — and its follow-ups re-run the same grid on new
runtimes.  This module owns the backend-agnostic cell mechanics, so any
driver (``chip_smoke.py``, tests, ad-hoc scripts) gets the same guarantees:

``aggregate_profiles``
    Collapse a mining run's ``JobProfile`` list into one flat dict (total and
    per-phase seconds, the paper's ``parallel_seconds`` cluster model,
    candidate totals, pipeline depth stats) — the cell payload a driver
    records per backend.

``itemset_digest``
    Canonical sha256 over the sorted ``(itemset, support)`` pairs.  Two
    backends agree on a cell iff their digests match — recording the digest
    per cell makes cross-backend identity auditable from the JSON alone.

``run_parity_cell``
    Mine the same database with every backend in a cell, hard-assert that
    itemsets AND supports are identical across all of them, and return the
    shared digest plus one aggregate per backend.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Callable, Dict, List, Sequence, Tuple

from repro_torch.core.runtime.job import JobProfile


def aggregate_profiles(levels: Sequence[JobProfile]) -> Dict[str, float]:
    """One mining run's per-job profiles -> one flat per-cell record.

    ``seconds``/``parallel_seconds``/``sequential_seconds`` sum over jobs
    (the paper reports whole-run execution time); per-phase fields sum the
    same way.  ``inflight_depth`` keeps the max effective queue depth seen,
    ``inflight_retunes`` the final cumulative count (it is monotone per
    engine, and a cell runs on one engine).
    """
    levels = list(levels)
    return {
        "n_jobs": len(levels),
        "max_k": max((p.k for p in levels), default=0),
        "n_candidates": int(sum(p.n_candidates for p in levels)),
        "n_frequent": int(sum(p.n_frequent for p in levels)),
        "seconds": float(sum(p.seconds for p in levels)),
        "parallel_seconds": float(sum(p.parallel_seconds for p in levels)),
        "sequential_seconds": float(sum(p.sequential_seconds for p in levels)),
        "gen_seconds": float(sum(p.gen_seconds for p in levels)),
        "build_seconds": float(sum(p.build_seconds for p in levels)),
        "encode_seconds": float(sum(p.encode_seconds for p in levels)),
        "count_seconds": float(sum(p.count_seconds for p in levels)),
        "reduce_seconds": float(sum(p.reduce_seconds for p in levels)),
        "inflight_depth": max((p.inflight_depth for p in levels), default=0),
        "inflight_retunes": max((p.inflight_retunes for p in levels), default=0),
    }


def itemset_digest(itemsets: Dict[Tuple[int, ...], int]) -> str:
    """Canonical sha256 of ``{itemset: support}`` (order-independent)."""
    h = hashlib.sha256()
    for s, c in sorted(itemsets.items()):
        h.update((",".join(str(int(x)) for x in s) + ":" + str(int(c)) + ";")
                 .encode())
    return h.hexdigest()[:16]


@dataclasses.dataclass
class CellResult:
    """One grid cell: the shared result identity + per-backend timings."""

    digest: str                      # shared itemset/support digest
    n_itemsets: int
    min_count: int
    backends: Dict[str, Dict[str, float]]   # label -> aggregate_profiles()


def run_parity_cell(
    transactions: Sequence[Sequence[int]],
    min_support: float,
    runner_factories: Dict[str, Callable[[], object]],
    max_k: int = 16,
) -> CellResult:
    """Mine ``transactions`` once per backend and enforce cell-level parity.

    ``runner_factories`` maps a display label to a zero-arg factory (runners
    hold placed device state, so each backend gets a fresh instance).  Every
    backend must produce *identical* itemsets with *identical* support
    counts — any divergence raises with both digests in the message, naming
    the offending backend.  Runners exposing ``close()`` (executor-pooled
    ``SimRunner``) are closed after their run.
    """
    from repro_torch.core.miner import FrequentItemsetMiner

    ref_label = ref_itemsets = None
    digest = ""
    min_count = n_itemsets = 0
    backends: Dict[str, Dict[str, float]] = {}
    for label, factory in runner_factories.items():
        runner = factory()
        try:
            res = FrequentItemsetMiner(min_support=min_support, max_k=max_k,
                                       runner=runner).mine(transactions)
        finally:
            if hasattr(runner, "close"):
                runner.close()
        if ref_itemsets is None:
            ref_label, ref_itemsets = label, res.itemsets
            digest = itemset_digest(res.itemsets)
            min_count, n_itemsets = res.min_count, len(res.itemsets)
        elif res.itemsets != ref_itemsets:
            raise AssertionError(
                f"cell parity violation at min_support={min_support}: "
                f"{label} produced {itemset_digest(res.itemsets)} but "
                f"{ref_label} produced {digest}"
            )
        backends[label] = aggregate_profiles(res.levels)
    return CellResult(digest=digest, n_itemsets=n_itemsets,
                      min_count=min_count, backends=backends)
