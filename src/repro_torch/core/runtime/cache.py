"""First-class encoded-dataset cache — RDD ``.cache()`` for the runtime.

The Spark follow-up to the source paper ("A Data Structure Perspective to the
RDD-based Apriori on Spark", arXiv:1908.01338) shows that *persisting the
encoded transaction tensors* across levels and sweep cells is the second
biggest win after trimming.  The per-level half is owned by the engine (the
placed DB is device-resident across waves) and the ladder (state never leaves
the device); this module owns the cross-run half: the host-side dense
re-encode (``EncodedDB`` construction) is memoized under a content key, so a
sweep that mines the same (dataset, support) cell through several backends —
or a benchmark that re-mines the same workload round after round — encodes
once.

Keys are pure content digests ``(raw digest, store, f_pad, item_map
digest)``: two runners over the same ingested matrix and frequent-item map
share an entry regardless of backend, mesh, or construction order, and any
change to the data or the support threshold (which changes the item map)
misses.  Entries are immutable by convention — the engine's
``pad_transactions_to`` copies instead of mutating, so sharing is safe.
"""

from __future__ import annotations

import collections
import hashlib
import threading
from typing import Callable, Hashable

import numpy as np


def dataset_digest(arr: np.ndarray) -> str:
    """Content digest of an array: dtype + shape + bytes (sha1)."""
    a = np.ascontiguousarray(np.asarray(arr))
    h = hashlib.sha1()
    h.update(str(a.dtype).encode())
    h.update(np.asarray(a.shape, np.int64).tobytes())
    h.update(a.tobytes())
    return h.hexdigest()


class EncodedDatasetCache:
    """Bounded LRU of encoded datasets, shared across runners (thread-safe).

    ``get_or_build(key, builder)`` returns the cached value or builds,
    inserts, and evicts least-recently-used entries past ``max_entries``.
    The builder runs outside the lock (encodes are slow; concurrent misses
    on the same key may race, last insert wins — both values are equal).
    """

    def __init__(self, max_entries: int = 8) -> None:
        self.max_entries = int(max_entries)
        self._entries: "collections.OrderedDict[Hashable, object]" = \
            collections.OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get_or_build(self, key: Hashable, builder: Callable[[], object]):
        # Hit/miss accounting happens entirely at lookup, inside one lock
        # section: every call is classified exactly once, at the moment it
        # observes the cache, so ``hits + misses == calls`` holds under any
        # thread interleaving (a miss counted at insert time instead would
        # let a call that races with its own builder be observed mid-flight
        # with neither counter bumped).
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                self.hits += 1
                return self._entries[key]
            self.misses += 1
        value = builder()
        with self._lock:
            self._entries[key] = value
            self._entries.move_to_end(key)
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)
        return value

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self.hits = 0
            self.misses = 0

    def stats(self) -> dict:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "entries": len(self._entries)}


# The runtime-owned shared instance the engine-backed runners (and
# bench_paper's sweep) encode through.
DATASET_CACHE = EncodedDatasetCache()
