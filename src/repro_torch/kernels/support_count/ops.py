"""Public wrappers of the support-count kernels.

On CPU tensors a wrapper computes with its kernel's plain version
(``ref.py``); on CUDA tensors it launches the hand-written kernel
(``csrc/``) on PyTorch's current stream, or raises — there is no fallback.
Kernel 3's two halves (``gather_and_count_pack``, ``gather_and_count_bits``)
work on a word layout that only the card makes, and raise on CPU tensors.
The wrapper checks device, dtype, shape and contiguity, allocates the
output, makes the tensors' device current (``torch.cuda.device`` on its
index) and launches on that device's current stream (``_stream``), and adds one to ``launches[name]`` for every kernel launch (and
nowhere else), so a run can show that its main path went through the
kernels.  ``pad_copies[name]`` counts the calls whose operands had to be
copied into the layout TMA reads (``tma_operands``); the main path's F_pad
is a multiple of 128 (W a multiple of 4 words) and never takes that route.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels.support_count import build
from repro_torch.kernels.support_count.ref import (
    gather_and_count_ref,
    packed_support_count_ref,
    support_count_ref,
)

launches: Dict[str, int] = {name: 0 for name in build.KERNELS}
pad_copies: Dict[str, int] = {name: 0 for name in build.KERNELS}
TMA_ALIGN = 16  # bytes: TMA's row pitch and base-address granule
# The packed kernel keeps a block's candidates unpacked in shared memory up
# to this many words a row (F = 640); wider rows stream a slab at a time.
# Mirrors MAX_RESIDENT_SLABS x SLAB_WORDS in csrc/packed_support_count.cu.
PACKED_RESIDENT_WORDS = 20


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


def _stream(device: torch.device) -> int:
    """The raw handle of ``device``'s current stream.  Unlike
    ``torch.cuda.current_stream().cuda_stream`` it builds no Stream object:
    kernels 1 and 2 launch once a row block, where a host step costs about
    as much as the kernel."""
    return torch._C._cuda_getCurrentRawStream(device.index)


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
    if n == 0 or c == 0:
        return torch.zeros((c,), dtype=torch.int32, device=packed.device)
    out = torch.empty((c,), dtype=torch.int32, device=packed.device)
    with torch.cuda.device(packed.device.index):
        packed, cpacked, copied = tma_operands(packed, cpacked)
        pad_copies["packed_support_count"] += copied
        _launch("packed_support_count", packed.data_ptr(), cpacked.data_ptr(),
                kvec.data_ptr(), out.data_ptr(), n, c, packed.shape[1],
                _stream(packed.device))
    return out


def packed_variant(w: int) -> str:
    """Which path of the packed kernel a W-word call takes: "resident"
    (candidates unpacked once a block) or "streamed" (a slab at a time)."""
    w4 = max(1, -(-w // 4)) * 4  # the width after ``tma_operands``
    return "resident" if w4 <= PACKED_RESIDENT_WORDS else "streamed"


def tma_operands(a: torch.Tensor, b: torch.Tensor):
    """(a, b, copied): two row-major operands of one width as a kernel's TMA
    descriptors take them, rows of a multiple of 16 bytes at 16-byte
    aligned addresses.  When they are not, both are copied into fresh
    zero-filled tensors as wide as the next multiple of 16 bytes (at least
    16): zero columns or words add nothing to any dot or popcount, so every
    count is unchanged."""
    f = a.shape[1]
    unit = TMA_ALIGN // a.element_size()  # elements in 16 bytes
    if (f and f % unit == 0 and a.data_ptr() % TMA_ALIGN == 0
            and b.data_ptr() % TMA_ALIGN == 0):
        return a, b, False
    wide_f = max(unit, -(-f // unit) * unit)

    def pad(t: torch.Tensor) -> torch.Tensor:
        wide = t.new_zeros((t.shape[0], wide_f))
        wide[:, :f] = t
        return wide

    return pad(a), pad(b), True


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
    with torch.cuda.device(bitmap.device.index):
        bitmap, khot, copied = tma_operands(bitmap, khot)
        pad_copies["support_count"] += copied
        _launch("support_count", bitmap.data_ptr(), khot.data_ptr(),
                kvec.data_ptr(), out.data_ptr(), n, c, bitmap.shape[1],
                _stream(bitmap.device))
    return out


def gather_and_count_words(n: int) -> int:
    """32-bit words a column of ``gather_and_count_pack`` holds for n rows:
    a whole number of 16-byte vectors."""
    return 4 * -(-n // 128)


def gather_and_count_pack(bitmap: torch.Tensor) -> torch.Tensor:
    """(F, ``gather_and_count_words(N)``) int32 carrying uint32 words: the
    columns of ``bitmap`` (N, F) {0,1} rows as bits, word w of column f
    holding rows 32 w .. 32 w + 31 (bit r for row 32 w + r), and zero bits
    past row N.  Any row view is read as is (an offset, F not a multiple
    of 16).  Only the kernel makes this layout: on CPU tensors it raises,
    since the plain count reads the bitmap itself."""
    if _on_cpu(bitmap):
        raise ValueError("gather_and_count_pack: the words are made only "
                         "on a CUDA device")
    _check("bitmap", bitmap, (torch.int8, torch.uint8), 2)
    n, f = bitmap.shape
    bits = bitmap.new_empty((f, gather_and_count_words(n)),
                            dtype=torch.int32)
    if n == 0 or f == 0:
        return bits
    with torch.cuda.device(bitmap.device.index):
        _launch("gather_and_count_pack", bitmap.data_ptr(), bits.data_ptr(),
                n, f, _stream(bitmap.device))
    return bits


def gather_and_count_bits(bits: torch.Tensor, n: int,
                          cand: torch.Tensor) -> torch.Tensor:
    """int32[C]: for every candidate row of ``cand`` (C, k) int32 item ids,
    the number of the n rows packed in ``bits`` (``gather_and_count_pack``
    of an (n, F) bitmap) in which all k columns are set.

    The kernel ANDs and popcounts each candidate's columns tile by tile of
    rows, so one call takes any n (the engine's whole chunk); it reads only
    the words, so words packed once serve every count over the same rows.
    The counts are an allocation of their own and keep nothing else
    alive."""
    if _on_cpu(bits, cand):
        raise ValueError("gather_and_count_bits: the words are read only "
                         "on a CUDA device")
    _check("bits", bits, (torch.int32,), 2)
    _check("cand", cand, (torch.int32,), 2)
    f = bits.shape[0]
    c, k = cand.shape
    if k == 0:
        raise ValueError("cand: a candidate needs at least one item")
    if bits.shape[1] != gather_and_count_words(n):
        raise ValueError(f"bits: shape {tuple(bits.shape)} does not pack "
                         f"{n} rows")
    if n == 0 or c == 0:
        return torch.zeros((c,), dtype=torch.int32, device=bits.device)
    out = torch.empty((c,), dtype=torch.int32, device=bits.device)
    with torch.cuda.device(bits.device.index):
        _launch("gather_and_count", bits.data_ptr(), cand.data_ptr(),
                out.data_ptr(), n, f, c, k, _stream(bits.device))
    return out


def gather_and_count(bitmap: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """int32[C]: for every candidate row of ``cand`` (C, k) int32 item ids,
    the number of ``bitmap`` (N, F) {0,1} rows in which all k columns are
    set: ``gather_and_count_pack`` then ``gather_and_count_bits``, for a
    caller that counts a bitmap once.  The words are freed on return (the
    allocator reuses them in stream order)."""
    if _on_cpu(bitmap, cand):
        return gather_and_count_ref(bitmap, cand)
    _check("bitmap", bitmap, (torch.int8, torch.uint8), 2)
    _check("cand", cand, (torch.int32,), 2)
    if cand.shape[1] == 0:
        raise ValueError("cand: a candidate needs at least one item")
    if bitmap.shape[0] == 0 or cand.shape[0] == 0:
        return torch.zeros((cand.shape[0],), dtype=torch.int32,
                           device=bitmap.device)
    return gather_and_count_bits(gather_and_count_pack(bitmap),
                                 bitmap.shape[0], cand)
