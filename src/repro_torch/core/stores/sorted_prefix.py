"""Sorted-prefix store — the trie as ordered searches.

A trie resolves each level by scanning the node's ordered children; the
array-layout dual is an ordered search of the candidate's next item inside
the *sorted transaction row*: one ``searchsorted`` per level (log L
comparisons, the ordered-scan cost model) instead of the perfect-hash
store's one gather.
"""

from __future__ import annotations

import torch

from repro_torch.core.stores.base import DeltaCountMixin, EncodedDB


class SortedPrefixStore(DeltaCountMixin):
    name = "sorted_prefix"

    @staticmethod
    def transaction_inputs(enc: EncodedDB) -> dict:
        return {"padded": enc.padded}

    @staticmethod
    def device_transaction_inputs(padded: torch.Tensor,
                                  bitmap: torch.Tensor) -> dict:
        """``transaction_inputs`` from the device-resident (N, L) padded ids
        and (N, F_pad) bitmap: the level ladder rebuilds the store tensors on
        the device after every trim."""
        return {"padded": padded}

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
        """trans["padded"]: (Nb, L) int32 rows sorted ascending with an
        ITEM_PAD tail; cands["cand"]: (C, k) int32 -> int32[C].  Pad
        candidates (item f_pad - 1, never in a row) are never found."""
        padded, cand = trans["padded"], cands["cand"].to(torch.int32)
        nb, width = padded.shape
        padded = padded.contiguous()

        def level_found(items: torch.Tensor) -> torch.Tensor:  # (Nb, C) bool
            queries = items.expand(nb, -1).contiguous()
            pos = torch.searchsorted(padded, queries, out_int32=True)
            pos = pos.clamp_(0, width - 1).to(torch.int64)
            return torch.gather(padded, 1, pos) == queries

        matched = level_found(cand[:, 0])
        for level in range(1, cand.shape[1]):
            matched &= level_found(cand[:, level])
        return matched.sum(dim=0, dtype=torch.int32)
