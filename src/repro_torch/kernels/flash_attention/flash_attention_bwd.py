"""Wrapper of the CUDA kernel ``csrc/flash_attention_bwd.cu``: the gradient
of GQA attention from the forward's output and row logsumexp.

Given q ``[B, H, S, Dqk]``, k ``[B, KV, Skv, Dqk]`` and v ``[B, KV, Skv,
Dv]`` at one of the forward's (q.k, v) width pairs (``flash.PAIRS``: (32,
32), (64, 64), (128, 128) and MLA's (192, 128)), keys of another length
Skv than the queries' S only when not causal (cross-attention), the
forward's output o and the gradient dO (both ``[B, H, S, Dv]``), and its
f32 row logsumexp ``lse`` ``[B, H, S]`` (natural log, as
``flash.flash_attention(..., return_lse=True)`` writes it), it returns dq
``[B, H, S, Dqk]``, dk ``[B, KV, Skv, Dqk]`` and dv ``[B, KV, Skv, Dv]``
in q's dtype; the sum over the G query heads of a KV head happens in the
kernel, in f32.  The kernels (delta, dk/dv, dq; dk/dv as a dv and a dk
pass at (192, 128)) take no atomics, so two calls give the same bits.
The bound is the five ``S Skv`` products (causal-halved) over the
tensor-core rate at training lengths, the bytes at prefill lengths (see
the source).  bf16 runs every product on the tensor cores (``mma.sync``
m16n8k16 with f32 accumulators, tiles staged through a 2-stage
``cp.async`` ring, P and dS split into two bf16 parts for the second
products: ``ref.attention_bwd_bf16_mma_ref`` emulates that rounding); f32
keeps the CUDA-core kernels, so it holds 2e-4 against the plain version.

The wrapper checks what the kernel takes (q, k and v as the forward's
wrapper checks them, causal with two lengths refused; o and dO of
``[B, H, S, Dv]`` in q's dtype, contiguous and 16-byte aligned; ``lse`` f32
of ``[B, H, S]``), allocates the gradients and the f32 delta scratch,
launches on PyTorch's current stream without synchronising, and raises if
a launch was refused.  ``LAUNCHES`` counts calls (one call launches every
kernel of the gradient), so a run can show that its training steps went
through the kernel.  The library is built at first use (see
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
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 +
                   [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int


LIBRARY = CudaLibrary(SOURCE, _bind)
LAUNCHES = LaunchCounter()


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, dout: torch.Tensor,
                        lse: torch.Tensor, *, causal: bool = True):
    """Returns ``(dq, dk, dv)`` for the attention ``o`` of q, k, v, all on
    one CUDA device: q [B, H, S, Dqk], k [B, KV, Skv, Dqk], v [B, KV, Skv,
    Dv], o and dout [B, H, S, Dv] (Skv == S when ``causal``)."""
    _check(q, k, v, causal=causal)
    b, h, s, d = q.shape
    kvh, skv, d_v = k.shape[1], k.shape[2], v.shape[3]
    for name, x in (("o", o), ("dout", dout)):
        if (x.shape != (b, h, s, d_v) or x.dtype != q.dtype
                or x.device != q.device or not x.is_contiguous()
                or x.data_ptr() % 16):
            raise ValueError(f"flash_attention_bwd needs {name} contiguous, "
                             f"16-byte aligned, of [B, H, S, Dv] = "
                             f"{(b, h, s, d_v)} and q's dtype {q.dtype} on "
                             f"{q.device}, got {tuple(x.shape)} {x.dtype} on "
                             f"{x.device}")
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
            dk.data_ptr(), dv.data_ptr(), b, h, kvh, s, skv, d, d_v,
            DTYPES[q.dtype], int(bool(causal)), 1.0 / math.sqrt(d), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd launch failed: CUDA error "
                           f"{err}")
    LAUNCHES.add()
    return dq, dk, dv
