"""Pass-combining strategies for the level-wise loop (PyTorch port).

SPC (Single Pass Counting) is the paper's own driver: one counting job per
level k.  On async runners the next level's candidates are generated
*speculatively* from C_k while the device counts, then cut back exactly to
``apriori_gen_matrix(L_k)`` once counts arrive (``filter_candidates`` keeps a
superset row iff every k-subset is frequent), so results are identical to
the sequential schedule at any ``inflight`` depth.

Levels travel as (C, k) int32 matrices; each strategy is a generator
yielding ``(JobProfile, {itemset: count})`` per counting job.  FPC and DPC
(combined multi-level waves) are not ported yet.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np

from repro_torch.core.itemsets import (
    Itemset,
    apriori_gen_matrix,
    level_to_matrix,
)
from repro_torch.core.runtime.job import CountJob


def _as_matrix(level) -> np.ndarray:
    """Accept a (C, k) matrix or a sequence of itemset tuples."""
    if isinstance(level, np.ndarray):
        return level.astype(np.int32, copy=False)
    return level_to_matrix(level)


def _to_dict(mat: np.ndarray, counts: np.ndarray) -> Dict[Itemset, int]:
    return {
        tuple(int(x) for x in mat[i]): int(counts[i]) for i in range(mat.shape[0])
    }


def spc(runner, level, min_count: int, start_k: int, max_k: int):
    """One job per level (the paper's Algorithm 1), double-buffered."""
    mat = _as_matrix(level)
    if not mat.size or start_k > max_k:
        return
    k = start_k
    tg = time.perf_counter()
    cand = apriori_gen_matrix(mat)
    gen_s = time.perf_counter() - tg
    while cand.size and k <= max_k:
        t0 = time.perf_counter()
        pending = runner.count_async(
            CountJob(k=k, cand=cand, min_count=min_count, level=mat)
        )
        spec = None
        spec_s = 0.0
        if runner.supports_async and k + 1 <= max_k:
            # Overlap: speculative C_{k+1} from C_k while the device counts.
            tg = time.perf_counter()
            spec = apriori_gen_matrix(cand)
            spec_s = time.perf_counter() - tg
        counts, prof = pending.result()
        keep = counts >= min_count
        freq_mat, freq_counts = cand[keep], counts[keep]
        tg = time.perf_counter()
        if k + 1 > max_k:
            next_cand = np.zeros((0, mat.shape[1] + 2), np.int32)
        elif spec is not None:
            # Exact cut back to apriori_gen_matrix(L_k).
            next_cand = runner.filter_candidates(spec, freq_mat)
        else:
            next_cand = apriori_gen_matrix(freq_mat)
        next_gen_s = spec_s + time.perf_counter() - tg
        prof.k = k
        prof.n_candidates = int(cand.shape[0])
        prof.n_frequent = int(freq_mat.shape[0])
        if not prof.mapper_seconds:
            prof.gen_seconds += gen_s
        # Job wall = this level's gen + count window, excluding the next
        # level's generation done inside the window (carried into the next
        # job's gen_s), so summing seconds over jobs matches elapsed wall.
        prof.seconds = gen_s + (time.perf_counter() - t0) - next_gen_s
        yield prof, _to_dict(freq_mat, freq_counts)
        mat, cand, gen_s = freq_mat, next_cand, next_gen_s
        k += 1


def fpc(runner, level, min_count, start_k, max_k, passes: int = 3):
    """Fixed number of combined passes per job (not ported yet)."""
    raise NotImplementedError("not yet ported")


def dpc(runner, level, min_count, start_k, max_k, budget: int = 50_000):
    """Combined waves within a candidate budget (not ported yet)."""
    raise NotImplementedError("not yet ported")


_STRATEGIES = {"spc": spc, "fpc": fpc, "dpc": dpc}


def get(name: str):
    if name not in _STRATEGIES:
        raise ValueError(f"unknown strategy {name!r}; pick from {list(_STRATEGIES)}")
    return _STRATEGIES[name]
