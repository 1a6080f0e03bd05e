"""Peaks of the card and the least time a count job's kernel could take.

The peaks are NVIDIA's data sheet for the H100 SXM (dense, no sparsity, at
its 700 W limit).  Both hand-written count kernels compute the same dense
int8 product: a (N, F) 0/1 row matrix against (C, F) k-hot candidates over
the job's F frequent items, 2 N C F operations, with the compare to k and
the sum over rows fused into it.  Their bytes differ: kernel 1 reads rows
and candidates packed 32 items to a 4-byte word, kernel 2 reads them a
byte an item.  Each input byte is counted once and each output byte once
(``kvec`` in, counts out, 4 bytes a candidate each).  The count is what
the inputs need: the F items (in whole words where packed), never the
padded width a program encodes them to.  The arithmetic is
``chip_smoke.py``'s ``count_share``, whose F is a multiple of 128.
"""

from __future__ import annotations

INT8_OPS_PER_S = 1.979e15   # dense int8 tensor-core operations a second
HBM_BYTES_PER_S = 3.35e12   # device-memory bandwidth
WORD_BITS = 32


def int8_ops(n: int, c: int, f: int) -> float:
    return 2.0 * n * c * f


def packed_bytes(n: int, c: int, f: int) -> float:
    """Kernel 1: packed rows and candidates, kvec and counts."""
    w = -(-f // WORD_BITS)  # F items in whole 32-bit words
    return n * w * 4.0 + c * w * 4.0 + 2 * c * 4.0


def bitmap_bytes(n: int, c: int, f: int) -> float:
    """Kernel 2: byte rows and k-hot candidates, kvec and counts."""
    return n * float(f) + c * float(f) + 2 * c * 4.0


def bound_s(ops: float, nbytes: float, ops_per_s: float = INT8_OPS_PER_S,
            bytes_per_s: float = HBM_BYTES_PER_S) -> float:
    """The larger of the operations' and the bytes' least times."""
    return max(ops / ops_per_s, nbytes / bytes_per_s)


def packed_count_bound_s(n: int, c: int, f: int, **rates) -> float:
    return bound_s(int8_ops(n, c, f), packed_bytes(n, c, f), **rates)


def bitmap_count_bound_s(n: int, c: int, f: int, **rates) -> float:
    return bound_s(int8_ops(n, c, f), bitmap_bytes(n, c, f), **rates)
