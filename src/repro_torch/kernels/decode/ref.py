"""Plain PyTorch fused decode: the CUDA kernel's reference and the CPU path.

Same function as ``csrc/decode_gop_blocks.cu``: dequant (row 0 intra, rows
1+ inter), the two 8x8 products ``D^T C D``, then a *sequential* prefix sum
over F.  The products are written as elementwise multiply-adds in the
kernel's order (j, then k, ascending) rather than as ``matmul``: a CPU GEMM
may round a row differently depending on how many rows it is given, and a
column's result must not depend on the batch it is decoded in (serial,
merged and served scans stay bit-identical inside the port).
"""
from __future__ import annotations

import torch

from repro_torch.codec.quant import quant_matrix
from repro_torch.codec.transform import dct_matrix


def decode_fused_ref(q: torch.Tensor, qp: int) -> torch.Tensor:
    """q: [F, M, 8, 8] int16 (row 0 intra, rows 1+ inter) -> [F, M, 8, 8]
    f32 reconstructed frames (cumulative over F)."""
    dev = q.device
    d = torch.from_numpy(dct_matrix()).to(dev)
    mk = torch.from_numpy(quant_matrix(qp, True)).to(dev)
    mp = torch.from_numpy(quant_matrix(qp, False)).to(dev)
    out = torch.empty(q.shape, dtype=torch.float32, device=dev)
    acc = None
    for f in range(q.shape[0]):
        c = q[f].to(torch.float32) * (mk if f == 0 else mp)   # [M, 8, 8]
        # t[:, i, l] = sum_j D[j, i] * C[:, j, l]
        t = d[0, :, None] * c[:, 0:1, :]
        for j in range(1, 8):
            t = t + d[j, :, None] * c[:, j:j + 1, :]
        # x[:, i, l] = sum_k t[:, i, k] * D[k, l]
        x = t[:, :, 0:1] * d[0]
        for k in range(1, 8):
            x = x + t[:, :, k:k + 1] * d[k]
        acc = x if acc is None else acc + x
        out[f] = acc
    return out
