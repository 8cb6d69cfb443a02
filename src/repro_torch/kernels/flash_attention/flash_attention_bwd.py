"""Wrapper of the CUDA kernel ``csrc/flash_attention_bwd.cu``: the gradient
of GQA attention from the forward's output and row logsumexp.

Given q ``[B, H, S, D]``, k and v ``[B, KV, S, D]``, the forward's output
o and the gradient dO (both ``[B, H, S, D]``), and its f32 row logsumexp
``lse`` ``[B, H, S]`` (natural log, as ``flash.flash_attention(...,
return_lse=True)`` writes it), it returns dq ``[B, H, S, D]`` and dk, dv
``[B, KV, S, D]`` in q's dtype; the sum over the G query heads of a KV
head happens in the kernel, in f32.  The three kernels (delta, dk/dv, dq)
take no atomics, so two calls give the same bits.  The bound is the five
causal-halved ``S^2 D`` products over the tensor-core rate (see the
source); this first version runs on the CUDA cores.

The wrapper checks what the kernel takes (as the forward's wrapper, and
``lse`` f32 of ``[B, H, S]``), allocates the gradients and the f32 delta
scratch, launches on PyTorch's current stream without synchronising, and
raises if a launch was refused.  ``LAUNCHES`` counts calls (one call
launches the three kernels), so a run can show that its training steps
went through the kernel.  The library is built at first use (see
``repro_torch.kernels.build``).
"""
from __future__ import annotations

import ctypes
import math
import pathlib

import torch

from repro_torch.kernels.build import CudaLibrary, LaunchCounter
from repro_torch.kernels.flash_attention.flash import DTYPES, _check

SOURCE = (pathlib.Path(__file__).resolve().parent / "csrc" /
          "flash_attention_bwd.cu")


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.flash_attention_bwd
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 +
                   [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int


LIBRARY = CudaLibrary(SOURCE, _bind)
LAUNCHES = LaunchCounter()


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, dout: torch.Tensor,
                        lse: torch.Tensor, *, causal: bool = True):
    """Returns ``(dq, dk, dv)`` for the attention ``o`` of q, k, v, all on
    one CUDA device."""
    _check(q, k, v)
    for name, x in (("o", o), ("dout", dout)):
        if (x.shape != q.shape or x.dtype != q.dtype or x.device != q.device
                or not x.is_contiguous()):
            raise ValueError(f"flash_attention_bwd needs {name} contiguous, "
                             f"of q's shape {tuple(q.shape)} and dtype "
                             f"{q.dtype} on {q.device}, got "
                             f"{tuple(x.shape)} {x.dtype} on {x.device}")
    b, h, s, d = q.shape
    if (lse.shape != (b, h, s) or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"flash_attention_bwd needs lse f32 [B, H, S] = "
                         f"{(b, h, s)} on {q.device}, got "
                         f"{tuple(lse.shape)} {lse.dtype} on {lse.device}")
    lib = LIBRARY.load()
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, h, k.shape[1], s, d,
            DTYPES[q.dtype], int(bool(causal)), 1.0 / math.sqrt(d), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd launch failed: CUDA error "
                           f"{err}")
    LAUNCHES.add()
    return dq, dk, dv
