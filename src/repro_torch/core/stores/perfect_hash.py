"""Perfect-hash store — the hash-table trie as gathers.

The dense item remap *is* the perfect hash: descending one trie level for
candidate item ``i`` is a single gather ``bitmap[:, i]``.  A candidate
matches a transaction iff all k gathers hit.  The level loop is unrolled
(k is fixed per wave), so peak memory is one (Nb, C) mask, never (Nb, C, k).
It needs no hand-written kernel, and on the card it is the independent
cross-check of the two kernel stores.
"""

from __future__ import annotations

import torch

from repro_torch.core.stores.base import DeltaCountMixin, EncodedDB


class PerfectHashStore(DeltaCountMixin):
    name = "perfect_hash"

    @staticmethod
    def transaction_inputs(enc: EncodedDB) -> dict:
        return {"bitmap": enc.bitmap}

    @staticmethod
    def device_transaction_inputs(padded: torch.Tensor,
                                  bitmap: torch.Tensor) -> dict:
        """``transaction_inputs`` from the device-resident (N, L) padded ids
        and (N, F_pad) bitmap: the level ladder rebuilds the store tensors on
        the device after every trim."""
        return {"bitmap": bitmap}

    @staticmethod
    def encode_candidates(cand: torch.Tensor, *, f_pad: int) -> dict:
        return {"cand": cand}

    @staticmethod
    def candidate_shard_axes() -> dict:
        """Tensor name -> axis carrying C, for every tensor
        ``encode_candidates`` returns."""
        return {"cand": 0}

    @staticmethod
    def count_block(trans: dict, cands: dict) -> torch.Tensor:
        """trans["bitmap"]: (Nb, F_pad) uint8; cands["cand"]: (C, k) -> int32[C]."""
        bitmap, cand = trans["bitmap"], cands["cand"]
        matched = bitmap.index_select(1, cand[:, 0])  # level-1 gather: (Nb, C)
        for level in range(1, cand.shape[1]):
            matched &= bitmap.index_select(1, cand[:, level])
        return matched.sum(dim=0, dtype=torch.int32)
