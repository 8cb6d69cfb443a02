"""Build and load the CUDA decode kernel ``csrc/decode_gop_blocks.cu``
(see ``repro_torch.kernels.build``): compiled with ``nvcc`` for ``sm_90a``
at first use into the git-ignored ``build/`` beside this file, keyed by a
digest of the source, and bound with ``ctypes``."""
from __future__ import annotations

import ctypes
import pathlib

from repro_torch.kernels.build import NVCC_FLAGS, CudaLibrary  # noqa: F401

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "build"
SOURCE = CSRC / "decode_gop_blocks.cu"


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.decode_gop_blocks
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int


LIBRARY = CudaLibrary(SOURCE, _bind)


def library_path() -> pathlib.Path:
    return LIBRARY.library_path()


def build() -> pathlib.Path:
    """Compile the kernel unless the library for this source exists."""
    return LIBRARY.build()


def load() -> ctypes.CDLL:
    """The bound library, built on first call."""
    return LIBRARY.load()
