"""Out-of-core dataset streaming: fixed-size transaction chunks of ``.dat``
(copied from the JAX package's ``data/chunked.py``: the same chunks, bit for
bit, and the same ``.chunkmeta.json`` sidecar keys).

The paper's cluster never loads the database: HDFS hands each mapper a
*split* and the job streams splits through the mappers.  This module is the
reproduction's split axis — ``ChunkedDatasetReader`` iterates a ``.dat``
(``.gz``-aware) basket file in fixed-size transaction blocks so a dataset
much larger than host memory can stream through the engine-backed runners
chunk by chunk (arXiv:1701.05982's split-size lesson: block size is a
first-order performance knob, so it is explicit here, either directly or
derived from a byte budget).

Chunks come out exactly in the runtime's ingestion layout: ``(n, width)``
int32 matrices of unique-sorted ids padded with ``ITEM_PAD``, where
``width`` is the *global* padded width — concatenating every chunk
reproduces ``padded_from_transactions(read_dat(path))`` bit for bit, which
is what makes chunked mining provably identical to the in-memory path
(int64 support counts are additive over disjoint transaction blocks).

Peak host memory is bounded by one chunk regardless of file size: the
global (N, width, max item id) metadata comes from a streaming scan pass
that never materializes rows, and the scan itself is cached in a
``<path>.chunkmeta.json`` sidecar keyed on the source's (size, mtime) — the
same invalidation discipline as ``load_dense``'s ``.dense.npz`` sidecar,
but holding only three integers, so the cache never violates the memory
budget the reader exists to respect.
"""

from __future__ import annotations

import json
import math
import os
from typing import Iterator, List, Optional

import numpy as np

from repro_torch.core.stores.base import ITEM_PAD
from repro_torch.data.datasets import _opener

# Matches padded_from_transactions(min_len=8): the lane-friendly minimum
# padded width, so chunked and whole-file matrices agree even on narrow DBs.
MIN_WIDTH = 8

DEFAULT_CHUNK_TRANSACTIONS = 65_536

_META_SUFFIX = ".chunkmeta.json"


def _meta_sidecar(path: str) -> str:
    return path + _META_SUFFIX


def _source_key(path: str) -> List[int]:
    st = os.stat(path)
    return [int(st.st_size), int(st.st_mtime_ns)]


class ChunkedDatasetReader:
    """Iterate a ``.dat``(.gz) basket file in bounded transaction chunks.

    ``chunk_transactions``
        Transactions per chunk (the split size).  Mutually exclusive with
        ``memory_budget_bytes``, which derives it as the largest chunk whose
        int32 padded matrix fits the budget (always at least 1 row).
    ``cache``
        Read/write the ``.chunkmeta.json`` scan sidecar (auto-invalidated
        when the source file changes, like ``load_dense``'s sidecar).

    The reader deliberately implements ``__len__`` but *not* iteration over
    individual transactions: every consumer must go through :meth:`chunks`
    so nothing accidentally materializes the whole database.
    """

    def __init__(self, path: str, chunk_transactions: Optional[int] = None,
                 memory_budget_bytes: Optional[int] = None,
                 cache: bool = True) -> None:
        if chunk_transactions is not None and memory_budget_bytes is not None:
            raise ValueError(
                "pass chunk_transactions or memory_budget_bytes, not both")
        if chunk_transactions is not None and chunk_transactions < 1:
            raise ValueError("chunk_transactions must be >= 1")
        self.path = str(path)
        self.cache = cache
        self.scanned_from_cache = False
        n, max_len, n_raw = self._scan()
        self.n_transactions = n
        self.width = max(MIN_WIDTH, max_len)
        self.n_raw_items = n_raw
        if chunk_transactions is not None:
            self.chunk_transactions = int(chunk_transactions)
        elif memory_budget_bytes is not None:
            row_bytes = self.width * np.dtype(np.int32).itemsize
            self.chunk_transactions = max(1, int(memory_budget_bytes) // row_bytes)
        else:
            self.chunk_transactions = DEFAULT_CHUNK_TRANSACTIONS

    # -- scan pass (streaming; cached in the .chunkmeta.json sidecar) -------
    def _scan(self):
        key = _source_key(self.path)
        side = _meta_sidecar(self.path)
        if self.cache and os.path.exists(side):
            try:
                with open(side) as f:
                    meta = json.load(f)
            except (OSError, ValueError):
                meta = None
            if meta is not None and meta.get("key") == key:
                self.scanned_from_cache = True
                return (int(meta["n"]), int(meta["max_len"]),
                        int(meta["n_raw_items"]))
        n = 0
        max_len = 1  # padded_from_transactions: lmax >= 1 even for all-empty
        max_id = -1
        with _opener(self.path)(self.path, "rt") as f:
            for line in f:
                row = {int(x) for x in line.split()}
                n += 1
                if row:
                    max_len = max(max_len, len(row))
                    max_id = max(max_id, max(row))
        if self.cache:
            tmp = side + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"key": key, "n": n, "max_len": max_len,
                           "n_raw_items": max_id + 1}, f)
            os.replace(tmp, side)
        return n, max_len, max_id + 1

    # -- iteration -----------------------------------------------------------
    def __len__(self) -> int:
        return self.n_transactions

    @property
    def n_chunks(self) -> int:
        if self.n_transactions == 0:
            return 0
        return math.ceil(self.n_transactions / self.chunk_transactions)

    def _pack(self, rows: List[List[int]]) -> np.ndarray:
        chunk = np.full((len(rows), self.width), ITEM_PAD, dtype=np.int32)
        for i, r in enumerate(rows):
            chunk[i, : len(r)] = r
        return chunk

    def chunks(self) -> Iterator[np.ndarray]:
        """Stream the file as ``(n, width)`` int32 ITEM_PAD-padded matrices.

        Every chunk holds ``chunk_transactions`` rows except a ragged final
        one; ``np.concatenate(list(chunks()))`` equals the whole-file
        ``padded_from_transactions`` matrix exactly.
        """
        rows: List[List[int]] = []
        with _opener(self.path)(self.path, "rt") as f:
            for line in f:
                rows.append(sorted({int(x) for x in line.split()}))
                if len(rows) >= self.chunk_transactions:
                    yield self._pack(rows)
                    rows = []
        if rows:
            yield self._pack(rows)

    def describe(self) -> str:
        return (f"chunked({os.path.basename(self.path)}: "
                f"{self.n_transactions} txns x w{self.width}, "
                f"{self.n_chunks} chunks of {self.chunk_transactions})")
