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
    DeltaCountMixin, EncodedDB, KernelSwitchMixin, WORD_BITS,
)


def _wrap_uint32(words: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> the int32 carrying the same 32 bits."""
    return torch.where(words > 0x7FFFFFFF, words - (1 << 32),
                       words).to(torch.int32)


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
    def transaction_inputs(enc: EncodedDB) -> dict:
        return {"packed": enc.packed}

    @staticmethod
    def device_transaction_inputs(padded: torch.Tensor,
                                  bitmap: torch.Tensor) -> dict:
        """``transaction_inputs`` from the device-resident (N, L) padded ids
        and (N, F_pad) bitmap, bit for bit ``base.pack_bitmap``: lane b of
        every 32-column group is shifted to bit b in int64 (one (N, W)
        plane per lane), then wrapped to the int32 carrier."""
        n, f = bitmap.shape
        lanes = bitmap.reshape(n, f // WORD_BITS, WORD_BITS)
        packed = torch.zeros((n, f // WORD_BITS), dtype=torch.int64,
                             device=bitmap.device)
        for b in range(WORD_BITS):
            packed |= lanes[:, :, b].to(torch.int64) << b
        return {"packed": _wrap_uint32(packed)}

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
    def candidate_shard_axes(cls, device="cpu") -> dict:
        """Tensor name -> axis carrying C, for every tensor
        ``encode_candidates`` returns on ``device``."""
        body = {"packed": 0} if cls.kernel_on(device) else {"packedT": 1}
        return {**body, "kvec": 0}

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
