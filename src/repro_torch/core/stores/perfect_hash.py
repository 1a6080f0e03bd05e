"""Perfect-hash store — the hash-table trie as gathers.

The dense item remap *is* the perfect hash: descending one trie level for
candidate item ``i`` is a single gather ``bitmap[:, i]``.  A candidate
matches a transaction iff all k gathers hit.

On CUDA tensors ``count_block`` goes through the hand-written CUDA kernel
(``repro_torch.kernels.support_count``): ``device_transaction_inputs``
packs the rows' columns into bits once, beside the bitmap
(``gather_and_count_pack``, under ``trans["bits"]``), and every count
ANDs and popcounts each candidate's k columns of those resident words
(``gather_and_count_bits``), so no (Nb, C) mask reaches device memory and
no count packs the same rows again.  On CPU tensors the plain path
gathers: the level loop is unrolled (k is fixed per wave), so peak memory
is one (Nb, C) mask, never (Nb, C, k).  ``use_kernel``
(``KernelSwitchMixin``) can force either path; on the card the plain path
(``use_kernel=False``) is the kernel's cross-check, and a build with the
kernel off packs nothing.  The kernel keeps no (Nb, C) intermediate and
takes any number of rows, so where it runs (``counts_whole_rows``) the
engine counts a chunk over all of its rows in one call instead of looping
over ``block_n``-row blocks; the words are no row tensor, so that loop
slices only ``row_inputs``.
"""

from __future__ import annotations

import torch

from repro_torch.core.stores.base import DeltaCountMixin, KernelSwitchMixin
from repro_torch.kernels.support_count.ref import gather_and_count_ref


class PerfectHashStore(KernelSwitchMixin, DeltaCountMixin):
    name = "perfect_hash"

    @classmethod
    def device_transaction_inputs(cls, padded: torch.Tensor,
                                  bitmap: torch.Tensor) -> dict:
        """The store's transaction tensors from the (N, L) padded ids and
        the (N, F_pad) bitmap, on their device: the bitmap and, where the
        kernel counts them on a CUDA device, its packed words."""
        if not (bitmap.is_cuda and cls.kernel_on(bitmap.device)):
            return {"bitmap": bitmap}
        from repro_torch.kernels.support_count import gather_and_count_pack

        return {"bitmap": bitmap, "bits": gather_and_count_pack(bitmap)}

    @staticmethod
    def row_inputs(trans: dict) -> dict:
        """The bitmap alone: the packed words hold a column a row."""
        return {"bitmap": trans["bitmap"]}

    @staticmethod
    def encode_candidates(cand: torch.Tensor, *, f_pad: int) -> dict:
        return {"cand": cand}

    @classmethod
    def counts_whole_rows(cls, device) -> bool:
        """True where ``count_block`` on tensors of ``device`` runs the
        kernel: its only intermediate is a bit-packed copy of the rows, an
        eighth of the bitmap, so one call may cover every resident row."""
        return torch.device(device).type == "cuda" and cls.kernel_on(device)

    @classmethod
    def count_block(cls, trans: dict, cands: dict) -> torch.Tensor:
        """trans["bitmap"]: (Nb, F_pad) uint8, and on the card its packed
        trans["bits"]; cands["cand"]: (C, k) -> int32[C]."""
        bitmap, cand = trans["bitmap"], cands["cand"]
        if not cls.kernel_on(bitmap.device):
            return gather_and_count_ref(bitmap, cand)
        from repro_torch.kernels.support_count import (
            gather_and_count, gather_and_count_bits)

        if "bits" in trans:
            return gather_and_count_bits(trans["bits"], bitmap.shape[0], cand)
        return gather_and_count(bitmap, cand)
