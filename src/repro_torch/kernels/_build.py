"""Build and bind the CUDA kernel library (plain C interface over ctypes).

``csrc/*.cu`` compile at first use, in ONE ``nvcc`` call, into a shared
library under ``build/kernels/`` at the repository root (git-ignored). The
file name carries a hash of the sources and flags, so an edited source
rebuilds and an unchanged one is reused. Nothing here runs at import: the
CPU tests import every module on a machine without ``nvcc``.

Each C entry point returns ``cudaGetLastError()`` after its launch; a
``Kernel`` raises when that is not 0 (a refused launch never runs, and a
later synchronize would not report it) and counts the launches that went
through, so a run can show which kernels its main path used.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("wsum.cu", "quant.cu", "q8agg.cu")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
# no --use_fast_math: it turns x / scale into an approximate division, and
# quantize must stay bit-exact against the reference
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit (PATH or "
                       "/usr/local/cuda/bin)")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libreprokernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library if this source hash has not been built yet."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(CSRC / name) for name in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)   # atomic: concurrent builders never see half a file
    return out


def library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.repro_error_string.argtypes = [ctypes.c_int]
            lib.repro_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


class Kernel:
    """One C entry point of the library and its launch count."""

    def __init__(self, symbol: str, argtypes: Sequence):
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None

    def __call__(self, *args) -> None:
        if self._fn is None:
            fn = getattr(library(), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args)
        if err != 0:
            msg = library().repro_error_string(err).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {err} ({msg})")
        self.launches += 1


KERNELS: Dict[str, Kernel] = {}


def register(name: str, symbol: str, argtypes: Sequence) -> Kernel:
    k = KERNELS[name] = Kernel(symbol, argtypes)
    return k


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def stream_of(t) -> ctypes.c_void_p:
    """The current CUDA stream of ``t``'s device, as a C pointer."""
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    """Device pointer of a tensor the kernels read as 16-byte vectors."""
    p = t.data_ptr()
    if p % 16:
        raise ValueError(f"kernel operand at {p:#x} is not 16-byte aligned "
                         "(pass a fresh or padded tensor, not an offset view)")
    return ctypes.c_void_p(p)
