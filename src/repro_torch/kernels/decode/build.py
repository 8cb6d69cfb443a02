"""Build and load the CUDA decode kernel.

The kernel is compiled at first use, from ``csrc/`` in this package, with
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface, and
bound with ``ctypes``.  The library's name carries a digest of its source,
so an edited kernel is rebuilt and a stale one never loads.  The build
directory (``build/`` beside this file) is git-ignored.

A process-wide lock makes the first use safe from the scheduler's decode
worker threads; the compiled file is renamed into place atomically, so
processes that build together never load a half-written library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "build"
SOURCE = CSRC / "decode_gop_blocks.cu"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    # PyTorch's own search: $CUDA_HOME / $CUDA_PATH, nvcc on PATH, the
    # toolkit's default prefix
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = pathlib.Path(CUDA_HOME or "", "bin", "nvcc")
    if not CUDA_HOME or not nvcc.exists():
        raise RuntimeError("nvcc not found: the CUDA decode kernel is built "
                           "with the CUDA toolkit's nvcc at first use")
    return str(nvcc)


def library_path() -> pathlib.Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libdecode_gop_blocks_{digest}.so"


def build() -> pathlib.Path:
    """Compile the kernel unless the library for this source exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.name}.{os.getpid()}.{threading.get_ident()}")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The bound library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            fn = lib.decode_gop_blocks
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _lib = lib
        return _lib
