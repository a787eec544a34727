"""Build and load the port's native code: the hand-written CUDA kernels
and the host C++ libraries.

Counterpart of ``utils/native.py`` of the JAX package. Each ``csrc/*.cu``
source is compiled with ``nvcc`` for ``sm_90a`` (:func:`build`), each
``csrc/*.cc`` host source with ``g++`` (:func:`load_host_library`, the
JAX package's flags), into a shared library with a plain C interface,
one ``.so`` per hash of the source and flags, under the git-ignored
``csrc/build/``, and loaded with ``ctypes``. Nothing here runs at import:
the first call that needs a library builds it.

Builds of different sources may run at the same time (one ``nvcc`` each,
e.g. from a thread pool); a per-source lock makes a second caller of the
same source wait for the first.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")


@dataclasses.dataclass
class Library:
    """A loaded kernel library and how it was built."""

    lib: ctypes.CDLL
    path: str
    build_seconds: float  # the compiler (0 when the .so was already built) plus loading
    build_log: str  # the compiler's stderr (nvcc: the ptxas register/spill report)


_LOADED: dict = {}
_LOCKS: dict = {}
_LOCKS_GUARD = threading.Lock()


def nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built with nvcc "
                       "(set CUDA_HOME or put nvcc on PATH)")


def _compile(source: str, compiler: list, flags: tuple, symbols: dict) -> Library:
    """Compile ``csrc/<source>`` once per hash of source and flags, load
    it, and declare ``symbols`` (name -> (argtypes, restype))."""
    with _LOCKS_GUARD:
        lock = _LOCKS.setdefault(source, threading.Lock())
    with lock:
        if source in _LOADED:
            return _LOADED[source]
        src = os.path.join(CSRC, source)
        with open(src, "rb") as f:
            digest = hashlib.sha256(f.read() + " ".join(flags).encode()).hexdigest()[:16]
        os.makedirs(BUILD_DIR, exist_ok=True)
        stem = os.path.splitext(source)[0]
        path = os.path.join(BUILD_DIR, f"lib{stem}_{digest}.so")
        t0 = time.perf_counter()
        log = ""
        if not os.path.exists(path):
            tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
            proc = subprocess.run([*compiler, *flags, "-o", tmp, src],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"{compiler[0]} failed building {src}:\n{proc.stderr}")
            os.replace(tmp, path)
            log = proc.stderr
        lib = ctypes.CDLL(path)
        for name, (argtypes, restype) in symbols.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, restype
        out = Library(lib, path, time.perf_counter() - t0, log)
        _LOADED[source] = out
        return out


def build(source: str, symbols: dict) -> Library:
    """Compile the CUDA source ``csrc/<source>`` once per source hash and
    load it.

    ``symbols`` maps each exported C function to ``(argtypes, restype)``;
    pointers and streams must be ``ctypes.c_void_p`` (a plain int would be
    cut to 32 bits). Every kernel library also exports ``oicc_error_string``.
    """
    return _compile(source, [nvcc()], NVCC_FLAGS, dict(
        symbols, oicc_error_string=([ctypes.c_int], ctypes.c_char_p)))


def load_host_library(source: str, symbols: dict) -> Library:
    """Compile the host C++ source ``csrc/<source>`` with ``g++`` once per
    source hash and load it (the GPMF reader, ``core/gpmf.py``)."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found: csrc/{source} is built with g++ (put it on PATH)")
    return _compile(source, [gxx], GXX_FLAGS, symbols)


def check(lib: Library, err: int, what: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + lib.lib.oicc_error_string(err).decode())
