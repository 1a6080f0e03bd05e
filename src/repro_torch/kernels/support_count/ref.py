"""Plain PyTorch versions of the two support-count kernels.

They define what the CUDA kernels compute: the CPU path of every wrapper,
the CPU tests and the on-card comparison in ``chip_smoke.py`` all go through
them.  Neither is used on the card's main path.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF


def support_count_ref(
    bitmap: torch.Tensor,  # (N, F) {0,1}, any float/int dtype
    khot: torch.Tensor,    # (C, F) k-hot rows
    kvec: torch.Tensor,    # (C,) number of items per candidate
) -> torch.Tensor:
    """int32[C]: for each candidate, #transactions containing all its items.

    float32 throughout (a bf16 product on the CPU returns bf16); every dot is
    an integer <= F, so the float32 sums and the compare are exact."""
    dots = bitmap.to(torch.float32) @ khot.to(torch.float32).T
    matched = dots == kvec.to(torch.float32)[None, :]
    return matched.sum(dim=0, dtype=torch.int32)


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of int64 tensors holding values in [0, 2**32)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _M32) >> 24


def packed_support_count_ref(
    packed: torch.Tensor,   # (N, W) int32 words (uint32 bit pattern)
    cpacked: torch.Tensor,  # (C, W) int32 packed k-hot candidate rows
    kvec: torch.Tensor,     # (C,) number of items per candidate
) -> torch.Tensor:
    """int32[C]: for each packed candidate, #rows n with
    ``sum_w popcount(packed[n, w] & cpacked[c, w]) == kvec[c]``.

    Word-unrolled AND + popcount, the kernel's own arithmetic; the words are
    widened to int64 and masked to 32 bits so the sign bit of the int32
    carrier never leaks into the count."""
    t = packed.to(torch.int64) & _M32
    c = cpacked.to(torch.int64) & _M32
    acc = torch.zeros((t.shape[0], c.shape[0]), dtype=torch.int64,
                      device=packed.device)
    for w in range(t.shape[1]):
        acc += _popcount32(t[:, w, None] & c[None, :, w])
    matched = acc == kvec.to(torch.int64)[None, :]
    return matched.sum(dim=0, dtype=torch.int32)
