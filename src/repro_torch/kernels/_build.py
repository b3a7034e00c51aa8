"""Build and bind the CUDA kernel library (plain C interface over ctypes).

``csrc/*.cu`` compile at first use, one ``nvcc`` process per source, all
started together, and link into one shared library under
``build/kernels/`` at the repository root (git-ignored). The
file name carries a hash of the sources and flags, so an edited source
rebuilds and an unchanged one is reused. Nothing here runs at import: the
CPU tests import every module on a machine without ``nvcc``.

Each C entry point returns ``cudaGetLastError()`` after its launch; a
``Kernel`` raises when that is not 0 (a refused launch never runs, and a
later synchronize would not report it) and counts the launches that went
through, so a run can show which kernels its main path used.

A ``FakeTensor`` has no memory to hand a kernel. The wrappers on the dry
run's paths send fake operands through a ``torch.library`` op of their own
instead: its fake implementation gives the outputs' shapes, and
``FAKE_COSTS`` the FLOPs and bytes the launch would take, by the formulas
of ``chip_smoke.bound``, for ``launch/opstats.py`` to count.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("wsum.cu", "quant.cu", "q8agg.cu", "multikrum.cu", "wkv6.cu",
           "wkv6_bwd.cu")
HEADERS = ("gram.cuh", "stream.cuh", "wkv6.cuh")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
# no --use_fast_math: it turns x / scale into an approximate division, and
# quantize must stay bit-exact against the reference
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

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
    for name in SOURCES + HEADERS:
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libreprokernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library if this source hash has not been built yet."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    nvcc = _nvcc()
    objs = [tmp.with_name(f"{tmp.name}.{Path(name).stem}.o")
            for name in SOURCES]
    compiles = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC / name)]
                for name, obj in zip(SOURCES, objs)]
    link = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]

    def check(cmd, rc, log):
        if rc != 0:
            raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{log}")

    try:
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in compiles]
        logs = [p.communicate()[0] for p in procs]
        for cmd, p, log in zip(compiles, procs, logs):
            check(cmd, p.returncode, log)
        proc = subprocess.run(link, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        check(link, proc.returncode, proc.stdout)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
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
    """One C entry point of the library and its launch count.

    ``packed``: the library also exports ``<symbol>_packed(const int64_t*)``
    taking the same arguments as one array of int64 (pointers included);
    the call writes them into a buffer of its thread's and passes one
    pointer, instead of ``ctypes`` converting each typed argument."""

    def __init__(self, symbol: str, argtypes: Sequence, packed: bool = False):
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.packed = packed
        self.launches = 0
        self._fn = None
        self._args = threading.local()

    def _bind(self):
        lib = library()
        if self.packed:
            fn = getattr(lib, self.symbol + "_packed")
            fn.argtypes = [ctypes.c_void_p]           # the int64 array
        else:
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        self._fn = fn

    def __call__(self, *args) -> None:
        if self._fn is None:
            self._bind()
        if self.packed:
            buf = getattr(self._args, "buf", None)
            if buf is None:
                buf = self._args.buf = (ctypes.c_int64 * len(self.argtypes))()
            buf[:] = args
            err = self._fn(buf)
        else:
            err = self._fn(*args)
        if err != 0:
            msg = library().repro_error_string(err).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {err} ({msg})")
        self.launches += 1


KERNELS: Dict[str, Kernel] = {}

# "repro_torch::<op>" -> fn(args, outputs) -> (flops, bytes) of a launch
FAKE_COSTS: Dict[str, object] = {}


def register(name: str, symbol: str, argtypes: Sequence,
             packed: bool = False) -> Kernel:
    k = KERNELS[name] = Kernel(symbol, argtypes, packed)
    return k


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def stream_of(t) -> int:
    """The current CUDA stream of ``t``'s device, as a raw pointer."""
    return raw_stream(t.get_device())


def raw_stream(device: int) -> int:
    """The current CUDA stream of device index ``device``, as a raw pointer.

    Reads the raw handle (``torch._C._cuda_getCurrentRawStream``, private)
    instead of building a ``torch.cuda.Stream`` object each call."""
    import torch
    return torch._C._cuda_getCurrentRawStream(device)


GRAM_PART_BLOCKS = 1024   # partials a Gram scratch holds: above any grid

# (device index, raw stream) -> (ticket int32 [1], zeroed once; partials)
_GRAM_SCRATCH: Dict[Tuple[int, int], tuple] = {}


def gram_scratch(t, pairs: int, stream: int) -> tuple:
    """The integer ticket and the partials scratch that ``gram::finish``
    (``csrc/gram.cuh``) takes, for ``t``'s device and the raw ``stream``
    the launch goes on: ``gram_q8`` and ``gram_and_norms`` share one pair
    on a stream, whose launches run in order, and another stream gets its
    own, so no two launches in flight race on a ticket. The partials grow
    to ``GRAM_PART_BLOCKS * pairs`` floats and are not allocated a call."""
    import torch
    key = (t.get_device(), stream)
    held = _GRAM_SCRATCH.get(key)
    if held is None or held[1].numel() < GRAM_PART_BLOCKS * pairs:
        ticket = held[0] if held is not None else \
            torch.zeros(1, dtype=torch.int32, device=t.device)
        held = _GRAM_SCRATCH[key] = (ticket, torch.empty(
            GRAM_PART_BLOCKS * pairs, dtype=torch.float32, device=t.device))
    return held
