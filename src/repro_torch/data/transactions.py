"""Transaction-database generators and host encodings (copied from the JAX
package's ``data/transactions.py``; the same seed gives the same baskets).

:func:`quest_generator` is a faithful simplification of the IBM Quest
procedure (weighted patterns, corruption, Poisson lengths);
:func:`bms_webview_twin` generates click-stream statistical twins of the
KDD-Cup-2000 BMS_WebView sets (Zipf item popularity, geometric lengths);
:func:`paper_datasets` builds the paper's three workloads at once;
:func:`encode_padded` and :func:`encode_bitmap` are the padded-id and
multi-hot host encodings.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

Transactions = List[List[int]]


def quest_generator(
    n_transactions: int = 100_000,
    avg_transaction_len: int = 10,
    avg_pattern_len: int = 4,
    n_items: int = 1000,
    n_patterns: int = 2000,
    corruption_mean: float = 0.5,
    seed: int = 0,
) -> Transactions:
    """IBM Quest-style generator; defaults produce a T10I4D100K-like database."""
    rng = np.random.default_rng(seed)

    # Potentially-large patterns with exponential weights and chained overlap.
    sizes = np.maximum(1, rng.poisson(avg_pattern_len, n_patterns))
    patterns: List[np.ndarray] = []
    prev = rng.choice(n_items, size=sizes[0], replace=False)
    patterns.append(prev)
    for s in sizes[1:]:
        n_common = min(len(prev), int(rng.exponential(0.5) * s))
        common = rng.choice(prev, size=n_common, replace=False) if n_common else np.empty(0, int)
        fresh = rng.choice(n_items, size=max(1, s - n_common), replace=False)
        pat = np.unique(np.concatenate([common, fresh]))
        patterns.append(pat)
        prev = pat
    weights = rng.exponential(1.0, n_patterns)
    weights /= weights.sum()
    corruption = np.clip(rng.normal(corruption_mean, 0.1, n_patterns), 0.0, 0.95)

    tlens = np.maximum(1, rng.poisson(avg_transaction_len, n_transactions))
    pat_idx = rng.choice(n_patterns, size=n_transactions * 4, p=weights)
    out: Transactions = []
    cursor = 0
    for tlen in tlens:
        items: set = set()
        while len(items) < tlen:
            if cursor >= len(pat_idx):  # refill the pattern stream
                pat_idx = rng.choice(n_patterns, size=n_transactions, p=weights)
                cursor = 0
            p = pat_idx[cursor]
            cursor += 1
            pat = patterns[p]
            keep = rng.random(len(pat)) >= corruption[p]
            chosen = pat[keep]
            if len(items) + len(chosen) > tlen * 1.5 and items:
                break  # Quest: oversized pattern moves to the next transaction
            items.update(int(x) for x in chosen)
        if not items:
            items = {int(rng.integers(n_items))}
        out.append(sorted(items))
    return out


def bms_webview_twin(
    n_transactions: int,
    n_items: int,
    avg_len: float,
    zipf_a: float = 1.6,
    seed: int = 0,
) -> Transactions:
    """Click-stream statistical twin: Zipf item popularity, geometric lengths."""
    rng = np.random.default_rng(seed)
    # Zipf popularity over the item vocabulary.
    ranks = np.arange(1, n_items + 1, dtype=np.float64)
    pop = ranks ** (-zipf_a)
    pop /= pop.sum()
    lens = rng.geometric(1.0 / max(avg_len, 1.01), n_transactions)
    lens = np.maximum(1, lens)
    out: Transactions = []
    for tlen in lens:
        tlen = int(min(tlen, n_items))
        items = rng.choice(n_items, size=tlen, replace=False, p=pop)
        out.append(sorted(int(x) for x in items))
    return out


def paper_datasets(scale: float = 1.0, seed: int = 0) -> dict:
    """The paper's three datasets (twins), optionally scaled down.

    A thin wrapper over the dataset registry (``data/datasets.py``).  The
    per-dataset seed offsets (+0/+1/+2) decorrelate the three workloads
    within one call: ``paper_datasets(seed=s)["T10I4D100K"]`` equals
    ``get_dataset("T10I4D100K", scale, seed=s + 2)``, not ``seed=s``.
    """
    from repro_torch.data.datasets import get_dataset  # deferred: avoids the cycle

    return {
        "BMS_WebView_1": get_dataset("BMS_WebView_1", scale=scale, seed=seed),
        "BMS_WebView_2": get_dataset("BMS_WebView_2", scale=scale, seed=seed + 1),
        "T10I4D100K": get_dataset("T10I4D100K", scale=scale, seed=seed + 2),
    }


# -- host encodings ----------------------------------------------------------

def encode_padded(transactions: Sequence[Sequence[int]], pad: int = -1) -> np.ndarray:
    """(N, Lmax) int32 matrix, rows sorted ascending, padded with ``pad``."""
    n = len(transactions)
    lmax = max((len(t) for t in transactions), default=1)
    out = np.full((n, lmax), pad, dtype=np.int32)
    for i, t in enumerate(transactions):
        s = sorted(set(int(x) for x in t))
        out[i, : len(s)] = s
    return out


def encode_bitmap(
    transactions: Sequence[Sequence[int]],
    item_ids: Sequence[int],
    pad_items_to: int = 128,
) -> Tuple[np.ndarray, np.ndarray]:
    """Multi-hot (N, F) uint8 bitmap over ``item_ids`` (the frequent items).

    Returns (bitmap, item_ids_padded).  F is padded to a multiple of
    ``pad_items_to`` so the kernels' tiles stay aligned; pad columns are
    all-zero and their ids -1.
    """
    item_ids = np.asarray(sorted(int(x) for x in item_ids), dtype=np.int64)
    f = len(item_ids)
    f_pad = max(pad_items_to, ((f + pad_items_to - 1) // pad_items_to) * pad_items_to)
    col = {int(it): i for i, it in enumerate(item_ids)}
    out = np.zeros((len(transactions), f_pad), dtype=np.uint8)
    for i, t in enumerate(transactions):
        for x in t:
            j = col.get(int(x))
            if j is not None:
                out[i, j] = 1
    ids_padded = np.full(f_pad, -1, dtype=np.int64)
    ids_padded[:f] = item_ids
    return out, ids_padded
