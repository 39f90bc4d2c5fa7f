"""Build hand-written CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``.cu`` source exposes a plain C interface (pointers and the stream as
``void*``, returning ``cudaGetLastError()``), is compiled for ``sm_90a``
into a shared library on first use, and is cached in ``kernels/_build/``
(ignored by git) under the hash of its source, of every header in
``kernels/csrc/`` (the shared Hopper primitives, ``hopper.cuh``, on the
include path) and of the flags, so editing a header rebuilds every kernel.
This cache, and the per-thread launch recorder of ``record_launches``, are
the package's only global state. Nothing here runs at import time: the CPU
test machine has no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, Iterable, Iterator, Optional, Sequence

BUILD_DIR = Path(__file__).resolve().parent / "_build"
INCLUDE_DIR = Path(__file__).resolve().parent / "csrc"     # shared headers
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and Path(CUDA_HOME, "bin", "nvcc").exists():
        return str(Path(CUDA_HOME, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


_RECORDER = threading.local()     # .counts: {CudaKernel: n} while recording


@contextmanager
def record_launches() -> Iterator[Dict["CudaKernel", int]]:
    """Divert this thread's launch counts into the yielded dict instead of
    each kernel's ``launches``: a launch recorded into a CUDA graph has not
    run. Whoever replays the graph adds the dict with ``add_launches`` at
    each replay. Other threads keep counting as before."""
    counts: Dict[CudaKernel, int] = {}
    _RECORDER.counts = counts
    try:
        yield counts
    finally:
        _RECORDER.counts = None


class CudaKernel:
    """One ``.cu`` source, its shared library and one C entry point.

    ``launches`` counts the launches of this kernel that ran: the wrapper
    adds one at each launch (``count_launch``), a graph's replay the ones it
    recorded. Callers set it to 0 before a run and read it after.
    """

    def __init__(self, name: str, source: Path, symbol: str,
                 argtypes: Sequence[type]):
        self.name = name
        self.source = Path(source)
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self.build_log = ""         # nvcc's output, ptxas register report
        self._fn = None
        self._lib = None
        self._errstr = None
        self._lock = threading.Lock()
        self._count_lock = threading.Lock()

    @property
    def library(self) -> Path:
        """The library's path, named by the hash of the source, every
        header under ``INCLUDE_DIR`` and the flags."""
        h = hashlib.sha256(self.source.read_bytes())
        for header in sorted(INCLUDE_DIR.glob("*.cuh")):
            h.update(header.name.encode() + b"\0" + header.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"lib{self.name}-{h.hexdigest()[:16]}.so"

    def _start_build(self) -> Optional[subprocess.Popen]:
        """Start nvcc unless the library is already built."""
        if self.library.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = self.library.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(INCLUDE_DIR), "-o", str(tmp),
               str(self.source)]
        return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)

    def _finish_build(self, proc: subprocess.Popen) -> None:
        out, _ = proc.communicate()
        self.build_log = out
        tmp = self.library.with_suffix(f".{os.getpid()}.tmp")
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed for {self.source}:\n{out}")
        os.replace(tmp, self.library)

    def fn(self):
        """The loaded C entry point (building the library on first use)."""
        if self._fn is None:
            with self._lock:
                if self._fn is None:
                    build_all([self])
                    lib = ctypes.CDLL(str(self.library))
                    fn = getattr(lib, self.symbol)
                    fn.argtypes = self.argtypes
                    fn.restype = ctypes.c_int
                    err = getattr(lib, f"{self.name}_error_string")
                    err.argtypes = [ctypes.c_int]
                    err.restype = ctypes.c_char_p
                    self._errstr = err
                    self._lib = lib
                    self._fn = fn
        return self._fn

    def entry(self, symbol: str, argtypes: Sequence[type]):
        """Another C function of the same library, returning an int."""
        self.fn()
        f = getattr(self._lib, symbol)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
        return f

    def count_launch(self) -> None:
        """One launch by the wrapper, counted where ``record_launches``
        records in this thread, else in ``launches``."""
        counts = getattr(_RECORDER, "counts", None)
        if counts is not None:
            counts[self] = counts.get(self, 0) + 1
        else:
            self.add_launches(1)

    def add_launches(self, n: int) -> None:
        with self._count_lock:      # drive threads of several engines
            self.launches += n

    def check(self, rc: int) -> None:
        if rc != 0:
            msg = self._errstr(rc).decode() if self._errstr else "?"
            raise RuntimeError(f"{self.name}: CUDA error {rc} ({msg})")


def build_all(kernels: Iterable[CudaKernel]) -> None:
    """Build every kernel not yet built, one nvcc per source, all started
    together; raise with every failing compiler's output."""
    procs = [(k, k._start_build()) for k in kernels]
    errors = []
    for k, proc in procs:
        if proc is None:
            continue
        try:
            k._finish_build(proc)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The number of SMs of CUDA device ``index``."""
    import torch
    return torch.cuda.get_device_properties(index).multi_processor_count


def refuse_autograd(name: str, *tensors) -> None:
    """Raise when grad mode is on and an input needs a gradient. A kernel
    called through ctypes fills an output from ``torch.empty``, which has no
    ``grad_fn``: without this the gradient would silently stop there. (An
    ``autograd.Function`` calls its kernel in its forward, where grad mode
    is off.)"""
    import torch
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward; call it under "
            "torch.no_grad() or on inputs that need no gradient")


def stream_ptr(t) -> ctypes.c_void_p:
    """The current CUDA stream of ``t``'s device, as a ctypes pointer."""
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
