"""Build and load the port's hand-written CUDA kernels, and count their
launches.

Every kernel directory keeps its source under ``csrc/``.  A source is
compiled at first use with ``nvcc`` for ``sm_90a`` (no ``--use_fast_math``:
the kernels must round like IEEE fp32) into a shared library with a plain
C interface, and bound with ``ctypes``.  The library's name carries a
digest of its source, so an edited kernel is rebuilt and a stale one never
loads.  The build directory (``build/`` beside ``csrc/``) is git-ignored.

A per-library lock makes the first use safe from the scheduler's decode
workers and the tuner thread; the compiled file is renamed into place
atomically, so processes that build together never load a half-written
library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading
from typing import Callable, Optional

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]


def nvcc() -> str:
    """Path of the CUDA toolkit's ``nvcc``; raises if there is none."""
    # PyTorch's own search: $CUDA_HOME / $CUDA_PATH, nvcc on PATH, the
    # toolkit's default prefix
    from torch.utils.cpp_extension import CUDA_HOME

    path = pathlib.Path(CUDA_HOME or "", "bin", "nvcc")
    if not CUDA_HOME or not path.exists():
        raise RuntimeError("nvcc not found: the port's CUDA kernels are "
                           "built with the CUDA toolkit's nvcc at first use")
    return str(path)


class CudaLibrary:
    """One ``csrc/<name>.cu`` compiled into ``build/lib<name>_<digest>.so``.

    ``bind`` declares ``argtypes``/``restype`` on the loaded library."""

    def __init__(self, source: pathlib.Path,
                 bind: Callable[[ctypes.CDLL], None]):
        self.source = pathlib.Path(source).resolve()
        self.build_dir = self.source.parent.parent / "build"
        self._bind = bind
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None

    def library_path(self) -> pathlib.Path:
        digest = hashlib.sha256(self.source.read_bytes()).hexdigest()[:12]
        return self.build_dir / f"lib{self.source.stem}_{digest}.so"

    def build(self) -> pathlib.Path:
        """Compile the kernel unless the library for this source exists."""
        out = self.library_path()
        if out.exists():
            return out
        self.build_dir.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(
            f".{out.name}.{os.getpid()}.{threading.get_ident()}")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed on {self.source.name} "
                               f"({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
        return out

    def load(self) -> ctypes.CDLL:
        """The bound library, built on first call."""
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                self._bind(lib)
                self._lib = lib
            return self._lib


class LaunchCounter:
    """Launch count of one kernel, safe to bump from worker threads.  A
    wrapper adds one where it launches its kernel and nowhere else, so a
    run can show that its work went through the kernel."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._n = 0

    def add(self) -> None:
        with self._lock:
            self._n += 1

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def count(self) -> int:
        return self._n
