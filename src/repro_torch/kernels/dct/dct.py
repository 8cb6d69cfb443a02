"""Wrapper of the CUDA kernel ``csrc/dct_quant.cu``: blockwise 8x8 DCT and
quantization, ``[N, 8, 8] f32 -> [N, 8, 8] int16``.

The wrapper checks what the kernel takes (a contiguous, 16-byte aligned
f32 CUDA tensor, as each lane's two 16-byte row loads need), allocates the
output (a fresh allocation, so aligned too), launches on PyTorch's current
stream without synchronising, and raises if the launch was refused.
``LAUNCHES`` counts launches, so a run can show that its encodes went
through the kernel.  The library is built at first use (see
``repro_torch.kernels.build``).
"""
from __future__ import annotations

import ctypes
import functools
import pathlib

import numpy as np
import torch

from repro_torch.codec.quant import quant_matrix
from repro_torch.codec.transform import dct_matrix
from repro_torch.kernels.build import CudaLibrary, LaunchCounter

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "dct_quant.cu"


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.dct_quant
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int


LIBRARY = CudaLibrary(SOURCE, _bind)
LAUNCHES = LaunchCounter()


@functools.lru_cache(maxsize=None)
def tables(qp: int, intra: bool) -> np.ndarray:
    """D and the quant matrix of ``(qp, intra)`` as 128 floats, the table
    argument of this kernel and of ``idct_dequant``; built once per key
    (read-only: every launch of that key shares it)."""
    t = np.ascontiguousarray(np.concatenate(
        [dct_matrix().ravel(), quant_matrix(qp, intra).ravel()]),
        dtype=np.float32)
    t.flags.writeable = False
    return t


def dct_quant(blocks: torch.Tensor, qp: int, intra: bool) -> torch.Tensor:
    """blocks: [N, 8, 8] f32 on a CUDA device -> [N, 8, 8] int16 there."""
    if blocks.device.type != "cuda":
        raise ValueError(f"dct_quant needs a CUDA tensor, got "
                         f"{blocks.device}")
    if blocks.dtype != torch.float32:
        raise TypeError(f"dct_quant needs float32, got {blocks.dtype}")
    if blocks.dim() != 3 or tuple(blocks.shape[1:]) != (8, 8) \
            or blocks.shape[0] < 1:
        raise ValueError(f"dct_quant needs [N>=1, 8, 8], got "
                         f"{tuple(blocks.shape)}")
    if not blocks.is_contiguous() or blocks.data_ptr() % 16:
        raise ValueError("dct_quant needs a contiguous, 16-byte aligned "
                         "tensor")
    lib = LIBRARY.load()
    out = torch.empty(blocks.shape, dtype=torch.int16, device=blocks.device)
    tab = tables(int(qp), bool(intra))
    with torch.cuda.device(blocks.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dct_quant(blocks.data_ptr(), out.data_ptr(),
                            tab.ctypes.data, int(blocks.shape[0]), stream)
    if err != 0:
        raise RuntimeError(f"dct_quant launch failed: CUDA error {err}")
    LAUNCHES.add()
    return out
