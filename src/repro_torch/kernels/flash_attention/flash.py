"""Wrapper of the CUDA kernel ``csrc/flash_attention.cu``: forward GQA
attention with an online softmax, q ``[B, H, S, Dqk]``, k ``[B, KV, Skv,
Dqk]`` and v ``[B, KV, Skv, Dv]``, f32 or bf16, out ``[B, H, S, Dv]`` in
q's dtype, scaled by ``1/sqrt(Dqk)``.  v's width may differ from q's as
in MLA (q.k over 128 + 64 dims, v over 128), and the keys' length Skv
from the queries' S when not causal, as in an encoder-decoder's
cross-attention (a decoder's queries over the encoder's output); causal
attention takes one length, and two raise ``ValueError``.

bf16 runs on the tensor cores (``mma.sync`` m16n8k16 with f32
accumulators, K and V staged as bf16 through a 2-stage ``cp.async`` ring,
P split into two bf16 parts for the PV product); f32 keeps the CUDA-core
kernel, so it holds 2e-5 against the plain version.  The bound is the bytes of q, k,
v and o at serving lengths and the causal ``S^2 D`` products over the bf16
tensor-core rate for long prompts (see the source).

With ``return_lse`` the kernel also writes each query row's f32
logsumexp of its scaled, masked scores (natural log), ``[B, H, S]``: the
statistic the backward kernel (``flash_attention_bwd.py``) recomputes the
probabilities from.  Without it the kernel gets a null pointer and ``o``
is the same, bit for bit.

The wrapper checks what the kernel takes ((Dqk, Dv) one of ``PAIRS``: (32,
32), (64, 64), (128, 128), (192, 128); one dtype for all three; matching
shapes; ``Skv == S`` when causal; ``H % KV == 0``; contiguous, 16-byte
aligned CUDA tensors on one device), allocates the output, launches on PyTorch's
current stream without synchronising, and raises if the launch was
refused.  ``LAUNCHES`` counts launches, so a run can show that its
prefills went through the kernel.  The library is built at first use (see
``repro_torch.kernels.build``).
"""
from __future__ import annotations

import ctypes
import math
import pathlib

import torch

from repro_torch.kernels.build import CudaLibrary, LaunchCounter

SOURCE = (pathlib.Path(__file__).resolve().parent / "csrc" /
          "flash_attention.cu")
#: the (q.k, v) head widths the kernel is built for
PAIRS = ((32, 32), (64, 64), (128, 128), (192, 128))
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.flash_attention
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 +
                   [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int


LIBRARY = CudaLibrary(SOURCE, _bind)
LAUNCHES = LaunchCounter()


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool = True) -> None:
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device.type != "cuda" or x.device != q.device:
            raise ValueError(f"flash_attention needs q, k and v on one CUDA "
                             f"device, got {name} on {x.device}")
        if x.dtype not in DTYPES or x.dtype != q.dtype:
            raise TypeError(f"flash_attention needs one dtype of float32 or "
                            f"bfloat16 for q, k and v, got {name} {x.dtype}")
        if x.dim() != 4:
            raise ValueError(f"flash_attention needs 4-d tensors, got {name} "
                             f"{tuple(x.shape)}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"flash_attention needs contiguous, 16-byte "
                             f"aligned tensors; {name} is not")
    b, h, s, d = q.shape
    if (k.shape[0] != b or k.shape[3] != d
            or v.shape[:3] != k.shape[:3]):
        raise ValueError(f"flash_attention needs q [B, H, S, Dqk], k "
                         f"[B, KV, Skv, Dqk] and v [B, KV, Skv, Dv], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if causal and k.shape[2] != s:
        raise ValueError(f"causal flash_attention needs keys of the "
                         f"queries' length, got S={s} and Skv={k.shape[2]}"
                         f" (keys of another length are taken when not "
                         f"causal)")
    if (d, v.shape[3]) not in PAIRS:
        raise ValueError(f"flash_attention takes (q.k, v) head dims "
                         f"{PAIRS}, got {(d, v.shape[3])}")
    if min(b, h, s, k.shape[2]) < 1 or k.shape[1] < 1 or h % k.shape[1]:
        raise ValueError(f"flash_attention needs B, S, Skv >= 1 and H a "
                         f"multiple of KV, got {tuple(q.shape)} and "
                         f"{tuple(k.shape)}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, return_lse: bool = False):
    """q: [B, H, S, Dqk]; k: [B, KV, Skv, Dqk]; v: [B, KV, Skv, Dv] on a
    CUDA device (Skv == S when ``causal``).  Returns [B, H, S, Dv] in q's
    dtype there, and with ``return_lse`` also the f32 row logsumexp
    [B, H, S]."""
    _check(q, k, v, causal=causal)
    b, h, s, d = q.shape
    dv = v.shape[3]
    lib = LIBRARY.load()
    out = torch.empty((b, h, s, dv), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
           if return_lse else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), b, h, k.shape[1], s,
            k.shape[2], d, dv, DTYPES[q.dtype], int(bool(causal)),
            1.0 / math.sqrt(d), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    LAUNCHES.add()
    return (out, lse) if return_lse else out
