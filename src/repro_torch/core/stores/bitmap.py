"""Bitmap store: containment as a matrix product.

Transactions are multi-hot rows T (N, F); candidates are k-hot rows C (Cc, F).
Containment is arithmetic: ``(T @ C^T)[n, c] == k_c``.  On CUDA tensors
``count_block`` goes through the hand-written int8 tensor-core kernel
(``repro_torch.kernels.support_count.support_count``), which fuses the
compare and the column sum; on CPU tensors a plain float32 PyTorch product
counts.  ``use_kernel`` (``KernelSwitchMixin``) can force either path.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.stores.base import (
    DeltaCountMixin, EncodedDB, KernelSwitchMixin,
)


def candidates_to_khot(cand: np.ndarray, f_pad: int) -> tuple:
    """(C, k) item matrix -> (C, F_pad) k-hot float32 rows + int32 k vector
    (host reference encoder)."""
    c, k = cand.shape
    khot = np.zeros((c, f_pad), dtype=np.float32)
    rows = np.repeat(np.arange(c), k)
    np.add.at(khot, (rows, cand.reshape(-1)), 1.0)
    # Pad rows stack k hits on the always-zero column; their dot is 0 != k.
    kvec = np.full((c,), k, dtype=np.int32)
    return khot, kvec


class BitmapMXUStore(KernelSwitchMixin, DeltaCountMixin):
    name = "bitmap"

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

    @classmethod
    def encode_candidates(cls, cand: torch.Tensor, *, f_pad: int) -> dict:
        """k-hot scatter from the (C, k) item matrix on its device, in the
        dtype the active path reads: int8 for the kernel, float32 for the
        plain product."""
        c, k = cand.shape
        khot = torch.zeros((c, f_pad), dtype=torch.int32, device=cand.device)
        khot.scatter_add_(1, cand.to(torch.int64),
                          torch.ones((c, k), dtype=torch.int32,
                                     device=cand.device))
        khot = khot.to(torch.int8 if cls.kernel_on(cand.device)
                       else torch.float32)
        kvec = torch.full((c,), k, dtype=torch.int32, device=cand.device)
        return {"khot": khot, "kvec": kvec}

    @staticmethod
    def candidate_shard_axes() -> dict:
        """Tensor name -> axis carrying C, for every tensor
        ``encode_candidates`` returns."""
        return {"khot": 0, "kvec": 0}

    @classmethod
    def count_block(cls, trans: dict, cands: dict) -> torch.Tensor:
        if cls.kernel_on(trans["bitmap"].device):
            from repro_torch.kernels.support_count import support_count

            return support_count(trans["bitmap"], cands["khot"], cands["kvec"])
        dots = trans["bitmap"].to(torch.float32) @ cands["khot"].T  # (Nb, C)
        matched = dots == cands["kvec"].to(torch.float32)[None, :]
        return matched.sum(dim=0, dtype=torch.int32)
