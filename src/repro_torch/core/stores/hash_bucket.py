"""Hash-bucket store — the hash tree, in two phases.

The hash tree routes a transaction by hashing items (h(i) = i %
child_max_size) and then *linearly scans* the candidate list at each reached
leaf: the paper's "two phases of operation" that make it slow.  The array
layout keeps both phases: (1) a bucket probe compares the hash of every
transaction item against every candidate's routing hash (the leaf scan,
paid even for candidates that cannot match), then (2) the containment check
by bitmap gathers for the probed candidates.
"""

from __future__ import annotations

import torch

from repro_torch.core.stores.base import DeltaCountMixin, ITEM_PAD


class HashBucketStore(DeltaCountMixin):
    name = "hash_bucket"
    child_max_size = 20  # paper §5.2

    @classmethod
    def device_transaction_inputs(cls, padded: torch.Tensor,
                                  bitmap: torch.Tensor) -> dict:
        """The store's transaction tensors from the (N, L) padded ids and
        the (N, F_pad) bitmap, on their device: each row item's routing
        hash, -1 at the ITEM_PAD tail."""
        t_hash = torch.where(padded == int(ITEM_PAD), -1,
                             padded % cls.child_max_size).to(torch.int32)
        return {"bitmap": bitmap, "t_hash": t_hash}

    @classmethod
    def encode_candidates(cls, cand: torch.Tensor, *, f_pad: int) -> dict:
        bucket = (cand[:, 0] % cls.child_max_size).to(torch.int32)
        return {"cand": cand, "cand_bucket": bucket}

    @staticmethod
    def count_block(trans: dict, cands: dict) -> torch.Tensor:
        bitmap, t_hash = trans["bitmap"], trans["t_hash"]
        cand, bucket = cands["cand"], cands["cand_bucket"]
        # Phase 1, the bucket probe: every transaction item's hash against
        # every candidate's routing hash (the leaf scan, full cost).  One
        # item column at a time keeps the peak at one (Nb, C) mask.
        probed = t_hash[:, 0, None] == bucket[None, :]
        for j in range(1, t_hash.shape[1]):
            probed |= t_hash[:, j, None] == bucket[None, :]
        # Phase 2, containment by per-level gathers for the probed lanes.
        matched = probed & bitmap.index_select(1, cand[:, 0]).to(torch.bool)
        for level in range(1, cand.shape[1]):
            matched &= bitmap.index_select(1, cand[:, level]).to(torch.bool)
        return matched.sum(dim=0, dtype=torch.int32)
