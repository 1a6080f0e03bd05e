"""Packed-bitmap popcount store.

Transactions and candidates are packed 32 item columns per word: T (N, W)
and C (Cc, W) with W = F_pad/32, carried as int32 tensors holding the
uint32 bit pattern.  Containment is bitwise: ``popcount(t & c) == k``.

On CUDA tensors ``count_block`` goes through the hand-written CUDA kernel
(``repro_torch.kernels.support_count.packed_support_count``); on CPU tensors
a plain word-wise PyTorch path counts.  ``use_kernel``
(``KernelSwitchMixin``) can force either path.
"""

from __future__ import annotations

import torch

from repro_torch.core.stores.base import (
    DeltaCountMixin, KernelSwitchMixin, WORD_BITS, _wrap_uint32, pack_bitmap,
)


def pack_candidates_device(cand: torch.Tensor, n_words: int) -> torch.Tensor:
    """(C, k) int32 item matrix -> (C, W) int32 packed rows, on the
    matrix's device.  Bits are OR-ed in, so pad rows (item f_pad - 1
    repeated k times) set exactly one bit, in the always-zero column."""
    c, k = cand.shape
    cand = cand.to(torch.int64)
    words = cand // WORD_BITS                                    # (C, k)
    bitval = torch.ones_like(cand) << (cand % WORD_BITS)         # (C, k)
    word_ids = torch.arange(n_words, dtype=torch.int64, device=cand.device)
    packed = torch.zeros((c, n_words), dtype=torch.int64, device=cand.device)
    for j in range(k):
        hit = word_ids[None, :] == words[:, j : j + 1]           # (C, W)
        packed |= torch.where(hit, bitval[:, j : j + 1], 0)
    return _wrap_uint32(packed)


class PackedBitmapStore(KernelSwitchMixin, DeltaCountMixin):
    name = "packed_bitmap"

    @staticmethod
    def device_transaction_inputs(padded: torch.Tensor,
                                  bitmap: torch.Tensor) -> dict:
        """The store's transaction tensors from the (N, L) padded ids and
        the (N, F_pad) bitmap, on their device: the bitmap's packed words."""
        return {"packed": pack_bitmap(bitmap)}

    @classmethod
    def encode_candidates(cls, cand: torch.Tensor, *, f_pad: int) -> dict:
        """Emit only the layout the active counting path reads: the kernel
        wants row-major (C, W); the plain path wants the word-major (W, C)
        transpose, materialized so its word loop reads contiguous rows."""
        c, _ = cand.shape
        packed = pack_candidates_device(cand, f_pad // WORD_BITS)
        body = ({"packed": packed} if cls.kernel_on(cand.device)
                else {"packedT": packed.T.contiguous()})
        kvec = torch.full((c,), cand.shape[1], dtype=torch.int32,
                          device=cand.device)
        return {**body, "kvec": kvec}

    @classmethod
    def count_block(cls, trans: dict, cands: dict) -> torch.Tensor:
        if cls.kernel_on(trans["packed"].device):
            from repro_torch.kernels.support_count import packed_support_count

            return packed_support_count(
                trans["packed"], cands["packed"], cands["kvec"])
        # Word-wise containment: t contains c iff (t_w & c_w) == c_w for
        # every word — the same test as popcount(t & c) == k.
        t, cT = trans["packed"], cands["packedT"]            # (Nb, W), (W, C)
        matched = torch.ones((t.shape[0], cT.shape[1]), dtype=torch.bool,
                             device=t.device)
        for w in range(cT.shape[0]):
            cw = cT[w][None, :]
            matched &= (t[:, w, None] & cw) == cw
        return matched.sum(dim=0, dtype=torch.int32)
