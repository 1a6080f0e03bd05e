"""Plain reference of a count job: what the program must answer.

Given the benchmark's own baskets, it works out again, with nothing the
program made: the item histogram (Job1), the frequent items at a support,
the candidate matrix of each level (join and prune, rows in lexicographic
order), and every candidate's support.  Supports are plain PyTorch
products: rows of the dense (N, F) 0/1 basket matrix are multiplied over
a candidate's first k - 1 items, and that product times the matrix gives
the count with every last item at once.  In float32 (TF32 off) every sum is
an integer below 2**24, so it is exact.  ``dtype=torch.bfloat16`` is the
control: the same products kept in bfloat16, as a count run through a
bfloat16 product would be, which rounds supports above 256.

It imports NumPy and PyTorch only: nothing of the program, nor of the JAX
package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np
import torch

ROW_BLOCK = 1 << 16      # basket rows a product reads at once
PREFIX_BLOCK = 4096      # candidate prefixes a product serves at once


@dataclasses.dataclass
class Level:
    """The reference's answer for one job: its candidates and supports."""

    k: int
    cand: np.ndarray      # (C, k) int32 dense item ids, lexicographic rows
    supports: np.ndarray  # int64[C]


@dataclasses.dataclass
class Answer:
    hist: np.ndarray      # int64[n_items]: baskets holding each raw item
    min_count: int
    item_map: np.ndarray  # int64[F]: the frequent raw items, ascending
    levels: List[Level]   # levels 2 .. k, the last is the job's


def min_count(min_support: float, n_baskets: int) -> int:
    """The support threshold as a basket count: ceil(s * N)."""
    return int(math.ceil(min_support * n_baskets))


def histogram(items: np.ndarray, n_items: int) -> np.ndarray:
    """Baskets holding each item (items are distinct within a basket)."""
    return np.bincount(items, minlength=n_items).astype(np.int64)


def _keys(rows: np.ndarray, base: int) -> np.ndarray:
    """Each row of small ids as one int64, ordered as the rows are
    lexicographically (every id < base)."""
    key = np.zeros((rows.shape[0],), np.int64)
    for j in range(rows.shape[1]):
        key = key * base + rows[:, j].astype(np.int64)
    return key


def next_candidates(level: np.ndarray, n_items: int) -> np.ndarray:
    """(L, k) frequent k-itemsets, rows lexicographic -> (C, k + 1)
    candidates: each pair of rows that agree on their first k - 1 items
    joined, kept when every k-subset is frequent, rows lexicographic."""
    level = np.asarray(level, np.int64)
    n, k = level.shape
    if n < 2:
        return np.zeros((0, k + 1), np.int32)
    prefix = _keys(level[:, :k - 1], n_items)
    _, first, sizes = np.unique(prefix, return_index=True, return_counts=True)
    a_idx, b_idx = [], []
    for start, size in zip(first, sizes):
        if size > 1:
            i, j = np.triu_indices(size, 1)
            a_idx.append(start + i)
            b_idx.append(start + j)
    if not a_idx:
        return np.zeros((0, k + 1), np.int32)
    a_idx = np.concatenate(a_idx)
    b_idx = np.concatenate(b_idx)
    cand = np.concatenate([level[a_idx], level[b_idx, -1:]], axis=1)
    frequent = np.sort(_keys(level, n_items))
    keep = np.ones((cand.shape[0],), bool)
    for drop in range(k + 1):
        sub = _keys(np.delete(cand, drop, axis=1), n_items)
        pos = np.minimum(np.searchsorted(frequent, sub), n - 1)
        keep &= frequent[pos] == sub
    cand = cand[keep]
    return cand[np.argsort(_keys(cand, n_items), kind="stable")].astype(
        np.int32)


def dense_rows(items: np.ndarray, offsets: np.ndarray, item_map: np.ndarray,
               n_items: int, lo: int, hi: int, device,
               dtype) -> torch.Tensor:
    """Rows [lo, hi) of the (N, F) 0/1 matrix over the frequent items."""
    dense = np.full((n_items,), -1, np.int64)
    dense[item_map] = np.arange(len(item_map))
    seg = items[offsets[lo]:offsets[hi]]
    rows = np.repeat(np.arange(hi - lo), np.diff(offsets[lo:hi + 1]))
    cols = dense[seg]
    hit = cols >= 0
    out = torch.zeros((hi - lo, len(item_map)), dtype=dtype, device=device)
    out[torch.from_numpy(rows[hit]).to(device),
        torch.from_numpy(cols[hit]).to(device)] = 1
    return out


def supports(items: np.ndarray, offsets: np.ndarray, item_map: np.ndarray,
             n_items: int, cand: np.ndarray, device,
             dtype=torch.float32) -> np.ndarray:
    """int64[C]: baskets holding every item of each (C, k) candidate row
    (dense ids over ``item_map``)."""
    if cand.shape[0] == 0:
        return np.zeros((0,), np.int64)
    n = offsets.shape[0] - 1
    uniq, inverse = np.unique(cand[:, :-1], axis=0, return_inverse=True)
    prefixes = torch.from_numpy(uniq.astype(np.int64)).to(device)
    # table[u, j]: baskets holding prefix u and item j.
    table = torch.zeros((len(uniq), len(item_map)), dtype=dtype,
                        device=device)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 sums stay exact
    try:
        for lo in range(0, n, ROW_BLOCK):
            hi = min(n, lo + ROW_BLOCK)
            rows = dense_rows(items, offsets, item_map, n_items, lo, hi,
                              device, dtype)
            for u0 in range(0, len(uniq), PREFIX_BLOCK):
                pre = prefixes[u0:u0 + PREFIX_BLOCK]
                prod = rows[:, pre[:, 0]]
                for j in range(1, pre.shape[1]):
                    prod = prod * rows[:, pre[:, j]]
                table[u0:u0 + pre.shape[0]] += prod.T @ rows
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    last = torch.from_numpy(cand[:, -1].astype(np.int64)).to(device)
    inv = torch.from_numpy(inverse.reshape(-1).astype(np.int64)).to(device)
    return table[inv, last].to(torch.float64).round().to(
        torch.int64).cpu().numpy()


def column_sums(items: np.ndarray, offsets: np.ndarray, n_items: int,
                device, dtype) -> np.ndarray:
    """The histogram as ones times the (N, n_items) 0/1 matrix, summed in
    ``dtype``: the control's Job1."""
    n = offsets.shape[0] - 1
    every = np.arange(n_items)
    total = torch.zeros((n_items,), dtype=dtype, device=device)
    for lo in range(0, n, ROW_BLOCK):
        hi = min(n, lo + ROW_BLOCK)
        rows = dense_rows(items, offsets, every, n_items, lo, hi, device,
                          dtype)
        total += torch.ones((hi - lo,), dtype=dtype, device=device) @ rows
    return total.to(torch.float64).round().to(torch.int64).cpu().numpy()


def answer(items: np.ndarray, offsets: np.ndarray, n_items: int,
           min_support: float, k: int, device="cpu",
           dtype=torch.float32) -> Answer:
    """Job1, the frequent items and levels 2 .. k, each with its supports;
    level k + 1's candidates come from level k's frequent rows."""
    n = offsets.shape[0] - 1
    mc = min_count(min_support, n)
    if dtype == torch.float32:
        hist = histogram(items, n_items)
    else:
        hist = column_sums(items, offsets, n_items, device, dtype)
    item_map = np.flatnonzero(hist >= mc).astype(np.int64)
    f = len(item_map)
    level = np.arange(f, dtype=np.int64)[:, None]
    levels = []
    for size in range(2, k + 1):
        cand = next_candidates(level, max(f, 1))
        sup = supports(items, offsets, item_map, n_items, cand, device, dtype)
        levels.append(Level(k=size, cand=cand, supports=sup))
        level = cand[sup >= mc]
    return Answer(hist=hist, min_count=mc, item_map=item_map, levels=levels)
