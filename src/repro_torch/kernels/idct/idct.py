"""Wrapper of the CUDA kernel ``csrc/idct_dequant.cu``: blockwise
dequantization and 8x8 IDCT, ``[N, 8, 8] int16 -> [N, 8, 8] f32``.

The wrapper checks what the kernel takes (a contiguous, 16-byte aligned
int16 CUDA tensor, as each lane's 16-byte row load needs), allocates the
output (a fresh allocation, so aligned too), launches on PyTorch's current
stream without synchronising, and raises if the launch was refused.
``LAUNCHES`` counts launches, so a run can show that its encodes went
through the kernel.  The library is built at first use (see
``repro_torch.kernels.build``).
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from repro_torch.kernels.build import CudaLibrary, LaunchCounter
from repro_torch.kernels.dct.dct import tables

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "idct_dequant.cu"


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.idct_dequant
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int


LIBRARY = CudaLibrary(SOURCE, _bind)
LAUNCHES = LaunchCounter()


def idct_dequant(q: torch.Tensor, qp: int, intra: bool) -> torch.Tensor:
    """q: [N, 8, 8] int16 on a CUDA device -> [N, 8, 8] f32 there."""
    if q.device.type != "cuda":
        raise ValueError(f"idct_dequant needs a CUDA tensor, got {q.device}")
    if q.dtype != torch.int16:
        raise TypeError(f"idct_dequant needs int16, got {q.dtype}")
    if q.dim() != 3 or tuple(q.shape[1:]) != (8, 8) or q.shape[0] < 1:
        raise ValueError(f"idct_dequant needs [N>=1, 8, 8], got "
                         f"{tuple(q.shape)}")
    if not q.is_contiguous() or q.data_ptr() % 16:
        raise ValueError("idct_dequant needs a contiguous, 16-byte aligned "
                         "tensor")
    lib = LIBRARY.load()
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    tab = tables(int(qp), bool(intra))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.idct_dequant(q.data_ptr(), out.data_ptr(),
                               tab.ctypes.data, int(q.shape[0]), stream)
    if err != 0:
        raise RuntimeError(f"idct_dequant launch failed: CUDA error {err}")
    LAUNCHES.add()
    return out
