"""Plain PyTorch fused decode: the CUDA kernel's reference and the CPU path.

Same function as ``csrc/decode_gop_blocks.cu``: dequant (row 0 intra, rows
1+ inter), the two 8x8 products ``D^T C D``, then a *sequential* prefix sum
over F.  The products are :func:`repro_torch.codec.transform.idct2_blocks`,
elementwise multiply-adds in the kernel's order (j, then k, ascending)
rather than ``matmul``: a CPU GEMM may round a row differently depending on
how many rows it is given, and a column's result must not depend on the
batch it is decoded in (serial, merged and served scans stay bit-identical
inside the port).
"""
from __future__ import annotations

import torch

from repro_torch.codec.quant import dequantize
from repro_torch.codec.transform import idct2_blocks


def decode_fused_ref(q: torch.Tensor, qp: int) -> torch.Tensor:
    """q: [F, M, 8, 8] int16 (row 0 intra, rows 1+ inter) -> [F, M, 8, 8]
    f32 reconstructed frames (cumulative over F)."""
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    acc = None
    for f in range(q.shape[0]):
        x = idct2_blocks(dequantize(q[f], qp, f == 0))   # [M, 8, 8]
        acc = x if acc is None else acc + x
        out[f] = acc
    return out
