"""Support-count kernels: hand-written CUDA for Hopper plus their plain
PyTorch versions (``ref.py``)."""

from repro_torch.kernels.support_count.ops import (
    launches,
    packed_support_count,
    pad_copies,
    reset_launches,
    support_count,
    tma_operands,
)
from repro_torch.kernels.support_count.ref import (
    packed_support_count_ref,
    support_count_ref,
)

__all__ = [
    "launches",
    "pad_copies",
    "reset_launches",
    "tma_operands",
    "support_count",
    "support_count_ref",
    "packed_support_count",
    "packed_support_count_ref",
]
