"""Shared encoding for the array-layout candidate stores (PyTorch port).

The host-side encoders are NumPy, carried over from the JAX package so the
port never imports it.  Every store builds its transaction tensors on the
device from an encoding's padded ids and bitmap
(``device_transaction_inputs``).  PyTorch has no usable ``uint32`` on the
CPU (no ``arange``, no popcount), so packed words travel as **int32 with
the identical bit pattern** — the CUDA kernels reinterpret them as
``unsigned``.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.trace import span

# Sentinel larger than any item id; keeps padded rows sorted for searchsorted.
ITEM_PAD = np.int32(2**30)


WORD_BITS = 32  # items per packed 32-bit word


def _wrap_uint32(words: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> the int32 carrying the same 32 bits."""
    return torch.where(words > 0x7FFFFFFF, words - (1 << 32),
                       words).to(torch.int32)


def pack_bitmap(bitmap: torch.Tensor) -> torch.Tensor:
    """(N, F_pad) uint8 multi-hot -> (N, F_pad/32) int32 on its device, bit
    b of word w is column ``32*w + b``: lane b of every 32-column group is
    shifted to bit b in int64 (one (N, W) plane per lane), then wrapped to
    the int32 carrier (bit for bit the uint32 packing).  F_pad is a
    multiple of 128, so 32 divides it."""
    n, f = bitmap.shape
    if f % WORD_BITS:
        raise ValueError(f"F_pad={f} must be a multiple of {WORD_BITS}")
    lanes = bitmap.reshape(n, f // WORD_BITS, WORD_BITS)
    packed = torch.zeros((n, f // WORD_BITS), dtype=torch.int64,
                         device=bitmap.device)
    for b in range(WORD_BITS):
        packed |= lanes[:, :, b].to(torch.int64) << b
    return _wrap_uint32(packed)


@dataclasses.dataclass
class EncodedDB:
    """Host encoding of a transaction database over F (frequent) items.

    Items are *remapped* to dense ids [0, F): the dense remap is the
    "perfect hash" of the paper's hash-table trie.

    padded:   (N, L) int32, each row sorted ascending, padded with ITEM_PAD.
    bitmap:   (N, F_pad) uint8 multi-hot; F_pad a multiple of 128 and > F, so
              column F_pad - 1 is guaranteed all-zero (used by candidate pads).
    n_items:  F, the number of real (frequent) item columns.
    """

    padded: np.ndarray
    bitmap: np.ndarray
    n_items: int

    @property
    def n_transactions(self) -> int:
        return self.padded.shape[0]

    @property
    def f_pad(self) -> int:
        return self.bitmap.shape[1]

    @property
    def n_words(self) -> int:
        return self.f_pad // WORD_BITS

    def row_block(self, lo: int, hi: int) -> "EncodedDB":
        """Rows ``[lo, hi)`` (a rank's transaction shard), views of the same
        arrays."""
        return EncodedDB(padded=self.padded[lo:hi], bitmap=self.bitmap[lo:hi],
                         n_items=self.n_items)

    def pad_transactions_to(self, n: int) -> "EncodedDB":
        """Pad N up to ``n`` with empty transactions (match nothing)."""
        if n == self.n_transactions:
            return self
        extra = n - self.n_transactions
        pad_rows = np.full((extra, self.padded.shape[1]), ITEM_PAD, np.int32)
        pad_bits = np.zeros((extra, self.f_pad), np.uint8)
        return EncodedDB(
            padded=np.concatenate([self.padded, pad_rows]),
            bitmap=np.concatenate([self.bitmap, pad_bits]),
            n_items=self.n_items,
        )


def encoded_db_from_numpy(padded: np.ndarray, bitmap: np.ndarray,
                          n_items: int) -> EncodedDB:
    """The port's ``EncodedDB`` from another encoder's arrays (e.g. the JAX
    package's ``EncodedDB.padded`` / ``.bitmap``), so two engines can be fed
    the identical encoded database."""
    padded = np.ascontiguousarray(padded, dtype=np.int32)
    bitmap = np.ascontiguousarray(bitmap, dtype=np.uint8)
    if padded.ndim != 2 or bitmap.ndim != 2 \
            or padded.shape[0] != bitmap.shape[0]:
        raise ValueError(f"padded {padded.shape} and bitmap {bitmap.shape} "
                         "must be 2-D with the same row count")
    if bitmap.shape[1] % WORD_BITS or bitmap.shape[1] <= n_items:
        raise ValueError(f"bitmap width {bitmap.shape[1]} must be a multiple "
                         f"of {WORD_BITS} and exceed n_items={n_items}")
    return EncodedDB(padded=padded, bitmap=bitmap, n_items=int(n_items))


def padded_from_transactions(
    transactions: Sequence[Sequence[int]], min_len: int = 8
) -> tuple:
    """One host pass over raw transaction lists -> ((N, L) int32 padded
    matrix of unique sorted ids, ITEM_PAD-padded; max item id + 1)."""
    n = len(transactions)
    with span("repro_torch.ingest.rows"):
        rows = [sorted(set(int(x) for x in t)) for t in transactions]
    with span("repro_torch.ingest.fill"):
        lmax = max(min_len, max((len(r) for r in rows), default=1))
        padded = np.full((n, lmax), ITEM_PAD, dtype=np.int32)
        for i, r in enumerate(rows):
            padded[i, : len(r)] = r
        n_raw = max((r[-1] for r in rows if r), default=-1) + 1
    return padded, n_raw


def encode_db_from_padded(
    padded: np.ndarray, n_items: int, align: int = 128
) -> EncodedDB:
    """Vectorized encode from an (N, L) padded matrix of dense ids in
    [0, n_items)."""
    n = padded.shape[0]
    f_pad = ((n_items // align) + 1) * align  # strictly greater than n_items
    bitmap = np.zeros((n, f_pad), dtype=np.uint8)
    rows, cols = np.nonzero(padded < ITEM_PAD)
    bitmap[rows, padded[rows, cols]] = 1
    return EncodedDB(padded=np.asarray(padded, dtype=np.int32),
                     bitmap=bitmap, n_items=n_items)


def encode_db(
    transactions: Sequence[Sequence[int]],
    n_items: int,
    min_len: int = 8,
    align: int = 128,
) -> EncodedDB:
    """Encode transactions whose items are already dense ids in [0, n_items)."""
    padded, _ = padded_from_transactions(transactions, min_len=min_len)
    return encode_db_from_padded(padded, n_items=n_items, align=align)


def dense_remap_padded(padded: np.ndarray, item_map: np.ndarray,
                       n_raw: int = None, min_width: int = 8) -> np.ndarray:
    """Remap an (N, L) raw-id padded matrix onto the dense ids of
    ``item_map`` (sorted original ids -> [0, F)); items outside the map —
    infrequent items, pads — become ITEM_PAD and collect at the row ends.
    The returned width is clamped to a minimum but never past the source's
    column count."""
    item_map = np.asarray(item_map, np.int64)
    f = len(item_map)
    if n_raw is None:
        top = int(item_map[-1]) + 1 if f else 0
        real = padded[padded < ITEM_PAD]
        n_raw = max(top, int(real.max()) + 1 if real.size else 0)
    lookup = np.full((n_raw + 1,), ITEM_PAD, np.int32)
    if f:
        lookup[item_map] = np.arange(f, dtype=np.int32)
    dense = lookup[np.minimum(padded, n_raw)]  # unmapped/pad -> ITEM_PAD
    dense = np.sort(dense, axis=1)  # unique-sorted; ITEM_PAD collects at end
    width = int((dense < ITEM_PAD).sum(axis=1).max()) if dense.size else 0
    width = min(dense.shape[1], max(min_width, width))
    return np.ascontiguousarray(dense[:, :max(1, width)])


class KernelSwitchMixin:
    """The counting-path switch of a store with a hand-written kernel.

    ``use_kernel = None`` (the default) counts through the kernel when the
    tensors lie on a CUDA device and through the plain PyTorch path when
    they lie on the CPU; ``True`` / ``False`` force one path (on CPU tensors
    the kernel's wrapper computes with its plain version).  The encode and
    the count both decide from their tensors' device, so they always agree
    on the layout."""

    use_kernel = None

    @classmethod
    def kernel_on(cls, device) -> bool:
        if cls.use_kernel is None:
            return torch.device(device).type == "cuda"
        return bool(cls.use_kernel)


class DeltaCountMixin:
    """Incremental counting over transaction *blocks*: support counts are
    additive over disjoint transaction sets, so ``count(window') =
    count(window) + count(added) - count(removed)``, each term through the
    store's own ``count_block``."""

    @classmethod
    def counts_whole_rows(cls, device) -> bool:
        """Whether ``count_block`` on tensors of ``device`` keeps no (Nb, C)
        intermediate, so the engine may hand it every row in one call; a
        store whose count does not says False and gets ``block_n``-row
        blocks."""
        return False

    @staticmethod
    def row_inputs(trans: dict) -> dict:
        """The tensors of ``trans`` that hold one row a transaction, which
        the engine slices into ``block_n``-row blocks: all of them, unless
        a store keeps a tensor of another layout beside its rows."""
        return trans

    @classmethod
    def apply_delta(cls, counts: torch.Tensor, trans_block: dict,
                    cands: dict, sign: int) -> torch.Tensor:
        """counts + sign * the block's contribution (int64, pure):
        ``sign=+1`` folds an ingested block in, ``sign=-1`` is its exact
        inverse."""
        return counts + sign * cls.count_block(trans_block, cands).to(
            torch.int64)

    @classmethod
    def count_delta(cls, counts: torch.Tensor, trans_block: dict,
                    cands: dict) -> torch.Tensor:
        """counts + the block's contribution."""
        return cls.apply_delta(counts, trans_block, cands, +1)

    @classmethod
    def uncount_delta(cls, counts: torch.Tensor, trans_block: dict,
                      cands: dict) -> torch.Tensor:
        """counts - the block's contribution (exact inverse of
        ``count_delta``, down to a one-row block)."""
        return cls.apply_delta(counts, trans_block, cands, -1)


def tracked_keep_mask(cand: np.ndarray, prev_freq: np.ndarray) -> np.ndarray:
    """bool[C]: which rows of a tracked (C, k) candidate level survive a
    lattice compaction given the *currently* frequent rows of level k-1.

    A row is kept exactly when the serving walk could still generate it:
    every (k-1)-subset is a row of ``prev_freq`` (the level below, filtered
    at the tracked threshold on current counts).  Currently frequent rows
    always survive (their subsets are frequent by the Apriori property).
    Both inputs are lexicographically sorted dense-id matrices, the tracked
    lattice's layout.
    """
    from repro_torch.core.itemsets import _rows_member  # lazy: itemsets imports us

    cand = np.asarray(cand)
    if cand.size == 0:
        return np.zeros((cand.shape[0] if cand.ndim == 2 else 0,), bool)
    if prev_freq.size == 0:
        return np.zeros((cand.shape[0],), bool)
    keep = np.ones((cand.shape[0],), bool)
    for drop in range(cand.shape[1]):
        keep &= _rows_member(np.asarray(prev_freq, cand.dtype),
                             np.delete(cand, drop, axis=1))
    return keep


def pad_candidates(cand: np.ndarray, f_pad: int, align: int = 128,
                   shards: int = 1) -> np.ndarray:
    """Pad the candidate count C up to ``align``; pad rows point at the
    always-zero bitmap column so they can never be matched.  ``shards`` > 1
    additionally rounds C up to a multiple of the shard count.  An empty
    (0, k) matrix keeps its k."""
    if cand.ndim == 2 and cand.shape[1]:
        c, k = cand.shape
    else:
        c, k = 0, 1
    c_pad = max(align, ((c + align - 1) // align) * align)
    if shards > 1:
        c_pad = ((c_pad + shards - 1) // shards) * shards
    out = np.full((c_pad, k), f_pad - 1, dtype=np.int32)
    if cand.size:
        out[:c] = cand
    return out
