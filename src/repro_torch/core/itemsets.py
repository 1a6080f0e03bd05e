"""Canonical itemset encoding and Apriori candidate generation (join + prune).

A NumPy copy of the JAX package's ``core/itemsets.py`` (the port imports
nothing of that package).  Items are non-negative integer ids; an itemset is
a strictly increasing tuple; levels are sorted lists of tuples or (C, k)
int32 matrices with rows in lexicographic order.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

from repro_torch.core.stores.base import ITEM_PAD

Itemset = Tuple[int, ...]


def sort_level(itemsets: Iterable[Itemset]) -> List[Itemset]:
    """Canonicalize a level: unique, lexicographically sorted tuples."""
    return sorted(set(tuple(sorted(s)) for s in itemsets))


def apriori_gen(level: Sequence[Itemset]) -> List[Itemset]:
    """Candidate (k+1)-itemsets from frequent k-itemsets: join rows sharing
    their first k-1 items, prune candidates with an infrequent k-subset."""
    if not level:
        return []
    k = len(level[0])
    level = sort_level(level)
    freq = set(level)
    out: List[Itemset] = []
    n = len(level)
    i = 0
    while i < n:
        prefix = level[i][: k - 1]
        j = i
        while j < n and level[j][: k - 1] == prefix:
            j += 1
        group = level[i:j]
        for a in range(len(group)):
            for b in range(a + 1, len(group)):
                cand = group[a] + (group[b][-1],)
                if _all_subsets_frequent(cand, freq):
                    out.append(cand)
        i = j
    return out


def _all_subsets_frequent(cand: Itemset, freq: set) -> bool:
    k1 = len(cand)
    # The two subsets dropping the last two items are the parents; skip them.
    for drop in range(k1 - 2):
        if cand[:drop] + cand[drop + 1 :] not in freq:
            return False
    return True


def brute_force_counts(
    transactions: Sequence[Sequence[int]], candidates: Sequence[Itemset]
) -> Dict[Itemset, int]:
    """Oracle: count each candidate by direct set containment."""
    tsets = [frozenset(t) for t in transactions]
    return {c: sum(1 for t in tsets if frozenset(c) <= t) for c in candidates}


def brute_force_frequent(
    transactions: Sequence[Sequence[int]], min_count: int, max_k: int = 12
) -> Dict[Itemset, int]:
    """Oracle: full level-wise mining with brute-force counting."""
    c1: Counter = Counter()
    for t in transactions:
        for it in set(t):
            c1[(int(it),)] += 1
    result = {s: c for s, c in c1.items() if c >= min_count}
    level = sort_level(result.keys())
    k = 1
    while level and k < max_k:
        counts = brute_force_counts(transactions, apriori_gen(level))
        frequent = {s: c for s, c in counts.items() if c >= min_count}
        result.update(frequent)
        level = sort_level(frequent.keys())
        k += 1
    return result


def _rows_member(sorted_level: np.ndarray, queries: np.ndarray) -> np.ndarray:
    """bool[Q]: is each query row present in the lexicographically sorted,
    duplicate-free ``sorted_level`` matrix?  Rows are reduced column by
    column to one int64 key, re-ranked dense after each column so the
    combine ``rank * ITEM_PAD + col`` never overflows."""
    m = sorted_level.shape[0]
    q = queries.shape[0]
    if m == 0 or q == 0:
        return np.zeros((q,), bool)
    k = sorted_level.shape[1]
    allr = np.concatenate([sorted_level, queries]).astype(np.int64)
    key = allr[:, 0]
    for j in range(1, k):
        key = np.unique(key, return_inverse=True)[1]
        key = key * np.int64(ITEM_PAD) + allr[:, j]
    level_keys = key[:m]
    pos = np.searchsorted(level_keys, key[m:])
    hit = pos < m
    return hit & (level_keys[np.minimum(pos, m - 1)] == key[m:])


def apriori_gen_matrix(level_mat: np.ndarray) -> np.ndarray:
    """Array-native ``apriori_gen``: (C, k) sorted level matrix -> (C', k+1)
    candidate matrix, rows in lexicographic order.  Within-group pairs are
    built by batching groups of equal size through one ``np.triu_indices``
    template; the drop-one prune is ``_rows_member``."""
    mat = np.asarray(level_mat, dtype=np.int32)
    if mat.size == 0:
        return np.zeros((0, (mat.shape[1] + 1) if mat.ndim == 2 else 0), np.int32)
    c, k = mat.shape
    new_group = np.empty((c,), bool)
    new_group[0] = True
    new_group[1:] = ~(mat[1:, : k - 1] == mat[:-1, : k - 1]).all(axis=1)
    starts = np.flatnonzero(new_group)
    sizes = np.diff(np.append(starts, c))

    a_parts, b_parts = [], []
    for g in np.unique(sizes):
        if g < 2:
            continue
        s = starts[sizes == g]
        ta, tb = np.triu_indices(int(g), 1)
        a_parts.append((s[:, None] + ta[None, :]).ravel())
        b_parts.append((s[:, None] + tb[None, :]).ravel())
    if not a_parts:
        return np.zeros((0, k + 1), np.int32)
    a_idx = np.concatenate(a_parts)
    b_idx = np.concatenate(b_parts)
    cand = np.concatenate([mat[a_idx], mat[b_idx, -1:]], axis=1)  # (P, k+1)

    keep = np.ones((cand.shape[0],), bool)
    for drop in range(k - 1):  # dropping position k-1 or k gives a parent
        keep &= _rows_member(mat, np.delete(cand, drop, axis=1))
    cand = cand[keep]
    return cand[np.lexsort(cand.T[::-1])]


def filter_candidates_matrix(cand: np.ndarray, level_mat: np.ndarray) -> np.ndarray:
    """Rows of the (C, k+1) candidate matrix whose *every* k-subset is a row
    of the sorted (L, k) ``level_mat``, in their original order — the exact
    SPC cut-back of a speculative superset to ``apriori_gen_matrix(L_k)``."""
    cand = np.asarray(cand, dtype=np.int32)
    if cand.size == 0 or level_mat.size == 0:
        return np.zeros((0, cand.shape[1] if cand.ndim == 2 else 0), np.int32)
    keep = np.ones((cand.shape[0],), bool)
    for drop in range(cand.shape[1]):
        keep &= _rows_member(level_mat, np.delete(cand, drop, axis=1))
    return cand[keep]


def level_to_matrix(level: Sequence[Itemset], dtype=np.int32) -> np.ndarray:
    """(C, k) matrix of a canonical level; rows in lexicographic order."""
    if not level:
        return np.zeros((0, 0), dtype=dtype)
    return np.asarray(sort_level(level), dtype=dtype)


def matrix_to_level(mat: np.ndarray) -> List[Itemset]:
    return [tuple(int(x) for x in row) for row in np.asarray(mat)]
