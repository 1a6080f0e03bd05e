"""Public wrappers of the support-count kernels.

On CPU tensors a wrapper computes with its kernel's plain version
(``ref.py``); on CUDA tensors it launches the hand-written kernel
(``csrc/``) on PyTorch's current stream, or raises — there is no fallback.
The wrapper checks device, dtype, shape and contiguity, allocates the
output, and adds one to ``launches[name]`` for every kernel launch (and
nowhere else), so a run can show that its main path went through the
kernels.  ``pad_copies["support_count"]`` counts the calls whose operands had
to be copied into the layout TMA reads (``tma_operands``); the main path's
F_pad is a multiple of 128 and never takes that route.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels.support_count import build
from repro_torch.kernels.support_count.ref import (
    packed_support_count_ref,
    support_count_ref,
)

launches: Dict[str, int] = {name: 0 for name in build.KERNELS}
pad_copies: Dict[str, int] = {"support_count": 0}
TMA_ALIGN = 16  # bytes: TMA's row pitch and base-address granule


def reset_launches() -> None:
    """Zero every launch count and the pad-copy count."""
    for counts in (launches, pad_copies):
        for name in counts:
            counts[name] = 0


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every input lies on the CPU; False when every input lies on
    one CUDA device; raises otherwise."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on different devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    return False


def _check(name: str, t: torch.Tensor, dtypes, ndim: int) -> None:
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype}, expected one of {dtypes}")
    if t.ndim != ndim:
        raise ValueError(f"{name}: expected {ndim}-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _launch(name: str, *args) -> None:
    err = build.kernel(name)(*args)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    launches[name] += 1


def packed_support_count(packed: torch.Tensor, cpacked: torch.Tensor,
                         kvec: torch.Tensor) -> torch.Tensor:
    """int32[C]: for every packed candidate row of ``cpacked`` (C, W), the
    number of ``packed`` (N, W) transaction rows whose AND-popcount with it
    equals ``kvec[c]``.  Words are int32 carrying the uint32 bit pattern."""
    if _on_cpu(packed, cpacked, kvec):
        return packed_support_count_ref(packed, cpacked, kvec)
    _check("packed", packed, (torch.int32,), 2)
    _check("cpacked", cpacked, (torch.int32,), 2)
    _check("kvec", kvec, (torch.int32,), 1)
    n, w = packed.shape
    c = cpacked.shape[0]
    if cpacked.shape[1] != w or kvec.shape[0] != c:
        raise ValueError(f"shapes packed {tuple(packed.shape)}, cpacked "
                         f"{tuple(cpacked.shape)}, kvec {tuple(kvec.shape)}")
    out = torch.zeros((c,), dtype=torch.int32, device=packed.device)
    if n == 0 or c == 0:
        return out
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream().cuda_stream
        _launch("packed_support_count", packed.data_ptr(), cpacked.data_ptr(),
                kvec.data_ptr(), out.data_ptr(), n, c, w, stream)
    return out


def tma_operands(bitmap: torch.Tensor, khot: torch.Tensor):
    """(bitmap, khot, copied): the two row-major operands as the kernel's
    TMA descriptors take them, rows of a multiple of 16 bytes at 16-byte
    aligned addresses.  When they are not, both are copied into fresh
    zero-filled (rows, F16) tensors, F16 the next multiple of 16 (at least
    16): zero columns add nothing to any dot, so every count is unchanged."""
    f = bitmap.shape[1]
    if (f and f % TMA_ALIGN == 0 and bitmap.data_ptr() % TMA_ALIGN == 0
            and khot.data_ptr() % TMA_ALIGN == 0):
        return bitmap, khot, False
    f16 = max(TMA_ALIGN, -(-f // TMA_ALIGN) * TMA_ALIGN)

    def pad(t: torch.Tensor) -> torch.Tensor:
        wide = t.new_zeros((t.shape[0], f16))
        wide[:, :f] = t
        return wide

    return pad(bitmap), pad(khot), True


def support_count(bitmap: torch.Tensor, khot: torch.Tensor,
                  kvec: torch.Tensor) -> torch.Tensor:
    """int32[C]: for every k-hot candidate row of ``khot`` (C, F), the
    number of ``bitmap`` (N, F) rows whose dot with it equals ``kvec[c]``.

    The kernel reads int8 operands (uint8 is taken as the same bytes): the
    bitmap is {0,1} and k-hot entries are counts in [0, 127]."""
    if _on_cpu(bitmap, khot, kvec):
        return support_count_ref(bitmap, khot, kvec)
    int8s = (torch.int8, torch.uint8)
    _check("bitmap", bitmap, int8s, 2)
    _check("khot", khot, int8s, 2)
    _check("kvec", kvec, (torch.int32,), 1)
    n, f = bitmap.shape
    c = khot.shape[0]
    if khot.shape[1] != f or kvec.shape[0] != c:
        raise ValueError(f"shapes bitmap {tuple(bitmap.shape)}, khot "
                         f"{tuple(khot.shape)}, kvec {tuple(kvec.shape)}")
    if n == 0 or c == 0:
        return torch.zeros((c,), dtype=torch.int32, device=bitmap.device)
    out = torch.empty((c,), dtype=torch.int32, device=bitmap.device)
    with torch.cuda.device(bitmap.device):
        bitmap, khot, copied = tma_operands(bitmap, khot)
        pad_copies["support_count"] += copied
        stream = torch.cuda.current_stream().cuda_stream
        _launch("support_count", bitmap.data_ptr(), khot.data_ptr(),
                kvec.data_ptr(), out.data_ptr(), n, c, bitmap.shape[1], stream)
    return out
