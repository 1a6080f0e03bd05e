"""Device-side candidate membership filter (the SPC cut-back).

Only the standalone filter of the JAX package's ``core/runtime/device_loop.py``
is ported so far: ``filter_candidates_device`` keeps a speculative
candidate row iff every one of its k-subsets is a row of the frequent level,
order preserved — the same rows as ``itemsets.filter_candidates_matrix``.
The fused ``LevelLadder`` is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

# Bound on the (Q, L) boolean membership intermediate per query chunk.
_MAX_EQ_ELEMENTS = 1 << 26


def _rows_member_device(lvl: torch.Tensor,
                        queries: torch.Tensor) -> torch.Tensor:
    """bool[Q]: is each query row a row of ``lvl``?"""
    eq = queries[:, 0][:, None] == lvl[:, 0][None, :]
    for j in range(1, queries.shape[1]):
        eq &= queries[:, j][:, None] == lvl[:, j][None, :]
    return torch.any(eq, dim=1)


def _filter_keep(cand: torch.Tensor, lvl: torch.Tensor) -> torch.Tensor:
    """bool[C]: rows whose every (k1-1)-subset is a row of ``lvl``."""
    keep = torch.ones((cand.shape[0],), dtype=torch.bool, device=cand.device)
    for drop in range(cand.shape[1]):
        subset = torch.cat([cand[:, :drop], cand[:, drop + 1:]], dim=1)
        keep &= _rows_member_device(lvl, subset)
    return keep


def filter_candidates_device(cand: np.ndarray, level_mat: np.ndarray,
                             device="cpu") -> np.ndarray:
    """Device twin of ``itemsets.filter_candidates_matrix`` (order-preserving
    SPC cut-back).  Queries go through in chunks so the (Q, L) boolean
    intermediate stays bounded whatever the speculative wave's size."""
    cand = np.asarray(cand, dtype=np.int32)
    if cand.size == 0 or level_mat.size == 0:
        return np.zeros((0, cand.shape[1] if cand.ndim == 2 else 0), np.int32)
    lvl = torch.from_numpy(
        np.ascontiguousarray(level_mat, dtype=np.int32)).to(device)
    step = max(1, _MAX_EQ_ELEMENTS // lvl.shape[0])
    keep = []
    for i in range(0, cand.shape[0], step):
        q = torch.from_numpy(np.ascontiguousarray(cand[i:i + step])).to(device)
        keep.append(_filter_keep(q, lvl).cpu().numpy())
    return cand[np.concatenate(keep)]
