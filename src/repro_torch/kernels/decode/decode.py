"""Wrapper of the CUDA decode kernel ``csrc/decode_gop_blocks.cu``.

One launch decodes a whole ``[F, M, 8, 8]`` block stream (see the source
for the contract and the design).  The wrapper checks what the kernel
takes, allocates the output, launches on PyTorch's current stream without
synchronising, and raises if the launch was refused.  ``LAUNCHES`` counts
launches, so a run can show that its decodes went through the kernel.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from repro_torch.codec.quant import quant_matrix
from repro_torch.codec.transform import dct_matrix
from repro_torch.kernels.decode import build


class LaunchCounter:
    """Launch count of one kernel, safe to bump from worker threads."""

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


LAUNCHES = LaunchCounter()


def _tables(qp: int) -> np.ndarray:
    return np.ascontiguousarray(np.concatenate(
        [dct_matrix().ravel(), quant_matrix(qp, True).ravel(),
         quant_matrix(qp, False).ravel()]), dtype=np.float32)


def decode_gop_blocks(q: torch.Tensor, qp: int) -> torch.Tensor:
    """q: [F, M, 8, 8] int16 on a CUDA device -> [F, M, 8, 8] f32 there."""
    if q.device.type != "cuda":
        raise ValueError(f"decode_gop_blocks needs a CUDA tensor, got "
                         f"{q.device}")
    if q.dtype != torch.int16:
        raise TypeError(f"decode_gop_blocks needs int16, got {q.dtype}")
    if q.dim() != 4 or tuple(q.shape[2:]) != (8, 8) or q.shape[0] < 1 \
            or q.shape[1] < 1:
        raise ValueError(f"decode_gop_blocks needs [F>=1, M>=1, 8, 8], got "
                         f"{tuple(q.shape)}")
    if not q.is_contiguous():
        raise ValueError("decode_gop_blocks needs a contiguous tensor")
    lib = build.load()
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    tables = _tables(qp)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.decode_gop_blocks(q.data_ptr(), out.data_ptr(),
                                    tables.ctypes.data, int(q.shape[0]),
                                    int(q.shape[1]), stream)
    if err != 0:
        raise RuntimeError(f"decode_gop_blocks launch failed: CUDA error "
                           f"{err}")
    LAUNCHES.add()
    return out
