"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, loaded with ``ctypes`` — seconds per
build, against minutes for an extension that includes PyTorch's headers.
Libraries go to ``build/repro_torch_kernels/`` at the repository root (git
ignores it), named by a digest of the source and the flags, so an edited
source rebuilds and an unchanged one loads at once.  Nothing builds at
import: the first launch builds what it needs, and ``build_all`` builds
every kernel at once, one ``nvcc`` per source, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry point of each kernel: (name, argtypes).  Every entry returns the
# launch's cudaError_t as an int (0 = cudaSuccess).
KERNELS = {
    "packed_support_count": ("packed_support_count_launch",
                             [_P, _P, _P, _P, _I, _I, _I, _P]),
    "support_count": ("support_count_launch",
                      [_P, _P, _P, _P, _I, _I, _I, _P]),
}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME): the CUDA "
                           "kernels are built from source at first use")
    return str(path)


def _lib_path(name: str) -> Path:
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def _start(name: str):
    """Start the nvcc of one kernel into a temporary name; None if built."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> str:
    """Wait for one nvcc, publish its library atomically, return its log."""
    if started is None:
        return ""
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    (BUILD_DIR / f"{out.stem}.log").write_text(log)
    return log


def _load(name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_lib_path(name)))
    symbol, argtypes = KERNELS[name]
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return lib


def build_all() -> Dict[str, str]:
    """Build (if needed) and load every kernel, one nvcc per source started
    together; returns each kernel's ptxas log ("" when already built)."""
    with _lock:
        names = [n for n in KERNELS if n not in _loaded]
        started = {n: _start(n) for n in names}
        logs, errors = {}, []
        for n in names:  # wait for every nvcc before reporting a failure
            try:
                logs[n] = _finish(n, started[n])
            except RuntimeError as err:
                errors.append(str(err))
        if errors:
            raise RuntimeError("\n".join(errors))
        for n in names:
            _loaded[n] = _load(n)
        return logs


def kernel(name: str):
    """The C entry point of kernel ``name``, built and loaded on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            _finish(name, _start(name))
            lib = _loaded[name] = _load(name)
    return getattr(lib, KERNELS[name][0])
