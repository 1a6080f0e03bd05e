"""Pass-combining strategies for the level-wise loop (PyTorch port).

SPC (Single Pass Counting) is the paper's own driver: one counting job per
level k.  FPC (Fixed Passes Combined-counting) counts a fixed number of
consecutive candidate generations in one job; DPC (Dynamic Passes
Combined-counting) extends the combined wave until a candidate budget is
hit.  Combined waves generate C_{k+1} from the *candidates* C_k
(speculative): fewer jobs against more, possibly useless, candidates.

On async runners the next level's SPC candidates are generated
*speculatively* from C_k while the device counts, then cut back exactly to
``apriori_gen_matrix(L_k)`` once counts arrive (``filter_candidates`` keeps a
superset row iff every k-subset is frequent), so results are identical to
the sequential schedule at any ``inflight`` depth.  A combined job's waves
go out as separate ``count_async`` jobs, all outstanding at once in the
engine's FIFO, and are resolved in dispatch order.

Levels travel as (C, k) int32 matrices; each strategy is a generator
yielding ``(JobProfile, {itemset: count})`` per counting job.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np

from repro_torch.core.itemsets import (
    Itemset,
    apriori_gen_matrix,
    level_to_matrix,
)
from repro_torch.core.runtime.job import CountJob, JobProfile


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


def _combined(runner, level, min_count, start_k, max_k, should_extend):
    """Shared FPC/DPC body: one job counts a wave of candidate levels.

    Wave j+1 is generated from wave j's *candidates*, so on async runners
    generation overlaps the device counting of the wave just dispatched.
    """
    mat = _as_matrix(level)
    k = start_k
    while mat.size and k <= max_k:
        t0 = time.perf_counter()
        gen_s = 0.0
        tg = time.perf_counter()
        cand = apriori_gen_matrix(mat)
        gen_s += time.perf_counter() - tg
        waves: List[np.ndarray] = []
        pendings: List = []
        while cand.size:
            waves.append(cand)
            pendings.append(runner.count_async(CountJob(
                k=k + len(waves) - 1, cand=cand, min_count=min_count,
                level=mat if len(waves) == 1 else None,
            )))
            if k + len(waves) - 1 >= max_k or not should_extend(waves):
                break
            tg = time.perf_counter()
            cand = apriori_gen_matrix(cand)  # speculative: join/prune against C_k
            gen_s += time.perf_counter() - tg
        if not waves:
            return
        n_cands = sum(w.shape[0] for w in waves)
        # Mixed k in one job: each wave is its own dispatch (one logical
        # job); resolve in dispatch order and merge.
        frequent: Dict[Itemset, int] = {}
        encode_s = count_s = reduce_s = build_s = runner_gen_s = 0.0
        inflight_depth = inflight_retunes = 0
        retries = spec_launches = spec_wins = 0
        backoff_s = 0.0
        mappers: List[float] = []
        for wave, pending in zip(waves, pendings):
            counts, prof = pending.result()
            keep = counts >= min_count
            frequent.update(_to_dict(wave[keep], counts[keep]))
            encode_s += prof.encode_seconds
            count_s += prof.count_seconds
            reduce_s += prof.reduce_seconds
            build_s += prof.build_seconds
            runner_gen_s += prof.gen_seconds
            retries += prof.retries
            spec_launches += prof.speculative_launches
            spec_wins += prof.speculative_wins
            backoff_s += prof.backoff_seconds
            inflight_depth = max(inflight_depth, prof.inflight_depth)
            # Cumulative engine counter: the latest wave carries the total.
            inflight_retunes = max(inflight_retunes, prof.inflight_retunes)
            if prof.mapper_seconds:  # combined job: mapper slots add up
                mappers = [a + b for a, b in zip(mappers, prof.mapper_seconds)] \
                    if mappers else list(prof.mapper_seconds)
        # Mapper-model runners report their own (max-over-mappers) gen; the
        # miner's host-side gen is only attributed on engine-backed runners.
        gen_s = runner_gen_s if mappers else gen_s + runner_gen_s
        # Downward closure across the combined wave: a (k+1)-itemset counted
        # speculatively is kept only if all its k-subsets survived.
        frequent = _closure_filter(frequent)
        stats = JobProfile(
            k=k + len(waves) - 1, n_candidates=n_cands,
            n_frequent=len(frequent), seconds=time.perf_counter() - t0,
            gen_seconds=gen_s, build_seconds=build_s, encode_seconds=encode_s,
            count_seconds=count_s, reduce_seconds=reduce_s,
            mapper_seconds=mappers, inflight_depth=inflight_depth,
            inflight_retunes=inflight_retunes, retries=retries,
            speculative_launches=spec_launches, speculative_wins=spec_wins,
            backoff_seconds=backoff_s,
        )
        yield stats, frequent
        top_k = max((len(s) for s in frequent), default=0)
        mat = level_to_matrix([s for s in frequent if len(s) == top_k])
        k = top_k + 1 if frequent else k + len(waves)


def _closure_filter(frequent: Dict[Itemset, int]) -> Dict[Itemset, int]:
    if not frequent:
        return frequent
    keep: Dict[Itemset, int] = {}
    ks = sorted({len(s) for s in frequent})
    surviving = {s for s in frequent if len(s) == ks[0]}
    keep.update({s: frequent[s] for s in surviving})
    for k in ks[1:]:
        for s in (x for x in frequent if len(x) == k):
            if all(s[:i] + s[i + 1:] in surviving for i in range(k)):
                keep[s] = frequent[s]
        surviving = {s for s in keep if len(s) == k}
    return keep


def fpc(runner, level, min_count, start_k, max_k, passes: int = 3):
    """Fixed number of combined passes per job."""
    return _combined(
        runner, level, min_count, start_k, max_k,
        should_extend=lambda waves: len(waves) < passes,
    )


def dpc(runner, level, min_count, start_k, max_k, budget: int = 50_000):
    """Extend the wave while the combined candidate count stays in budget."""
    return _combined(
        runner, level, min_count, start_k, max_k,
        should_extend=lambda waves: sum(w.shape[0] for w in waves) < budget,
    )


_STRATEGIES = {"spc": spc, "fpc": fpc, "dpc": dpc}


def get(name: str):
    if name not in _STRATEGIES:
        raise ValueError(f"unknown strategy {name!r}; pick from {list(_STRATEGIES)}")
    return _STRATEGIES[name]
