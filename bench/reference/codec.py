"""Plain NumPy reference of the store's codec, from the raw frames to the
pixels of the scanned boxes.

The codec the configuration states (paper §3; ``gop`` and ``qp`` in the
configuration file): 8x8 blocks on the frame's grid, each coded on its own;
a GOP's first frame intra-coded (orthonormal DCT-II, divided by the JPEG
luminance matrix scaled by ``qp / 16``, rounded half to even), every later
frame the residual against the previous reconstruction (closed loop) with a
flatter matrix (``max(0.75 M, 1)``); decoding is the dequantised inverse DCT
of the keyframe plus the running sum of the residuals'.  A tile never
references pixels outside itself, and a block never references another
block, so the pixels of a box do not depend on the tile layout that holds
them: the reference codes only the blocks under the scanned boxes, from the
raw frames.  It imports nothing of the program.

``control=True`` decodes in bfloat16 (each inverse transform and each
running sum rounded to it), the precision below the f32 the program states.
"""
from __future__ import annotations

import numpy as np
import torch

B = 8
_JPEG = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61],
    [12, 12, 14, 19, 26, 58, 60, 55],
    [14, 13, 16, 24, 40, 57, 69, 56],
    [14, 17, 22, 29, 51, 87, 80, 62],
    [18, 22, 37, 56, 68, 109, 103, 77],
    [24, 35, 55, 64, 81, 104, 113, 92],
    [49, 64, 78, 87, 103, 121, 120, 101],
    [72, 92, 95, 98, 112, 100, 103, 99],
], dtype=np.float64)


def _dct_basis() -> np.ndarray:
    k = np.arange(B)[:, None]
    i = np.arange(B)[None, :]
    m = np.sqrt(2.0 / B) * np.cos(np.pi * (2 * i + 1) * k / (2 * B))
    m[0] = np.sqrt(1.0 / B)
    return m.astype(np.float32)


def _quant(qp: int, intra: bool) -> np.ndarray:
    m = _JPEG * (max(qp, 1) / 16.0)
    if not intra:
        m = np.maximum(m * 0.75, 1.0)
    return np.maximum(m, 1.0).astype(np.float32)


def _bf16(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(x)).to(
        torch.bfloat16).float().numpy()


def code_blocks(x: np.ndarray, *, qp: int, control: bool = False
                ) -> np.ndarray:
    """One GOP of blocks ``x`` [T, N, 8, 8] (raw pixels, f32) encoded and
    decoded: the reconstruction [T, N, 8, 8]."""
    d = _dct_basis()

    def fwd(b):
        return np.einsum("ij,njk,lk->nil", d, b, d).astype(np.float32)

    def inv(c):
        y = np.einsum("ji,njk,kl->nil", d, c, d).astype(np.float32)
        return _bf16(y) if control else y

    out = np.empty_like(x, dtype=np.float32)
    m_i, m_p = _quant(qp, True), _quant(qp, False)
    q = np.round(fwd(x[0]) / m_i)
    enc = dec = inv(q.astype(np.float32) * m_i)
    out[0] = dec
    for t in range(1, x.shape[0]):
        q = np.round(fwd(x[t] - enc) / m_p).astype(np.float32)
        r = (q * m_p).astype(np.float32)
        enc = (enc + np.einsum("ji,njk,kl->nil", d, r, d)).astype(np.float32)
        dec = _bf16(dec + inv(r)) if control else enc
        out[t] = dec
    return out


def decode_boxes(frames: np.ndarray, boxes, *, gop: int, qp: int,
                 control: bool = False) -> list:
    """The reference pixels [y2-y1, x2-x1] (f32) of each ``(frame, (y1, x1,
    y2, x2))`` in ``boxes``, coded from the raw ``frames`` [T, H, W]."""
    by_gop: dict = {}
    for f, (y1, x1, y2, x2) in boxes:
        cells = by_gop.setdefault(f // gop, set())
        for by in range(y1 // B, (y2 + B - 1) // B):
            for bx in range(x1 // B, (x2 + B - 1) // B):
                cells.add((by, bx))
    decoded = {}
    for g, cells in by_gop.items():
        cells = sorted(cells)
        ys = np.array([c[0] for c in cells]) * B
        xs = np.array([c[1] for c in cells]) * B
        clip = frames[g * gop:(g + 1) * gop].astype(np.float32)
        rows = ys[:, None] + np.arange(B)[None, :]           # [N, 8]
        cols = xs[:, None] + np.arange(B)[None, :]
        x = clip[:, rows[:, :, None], cols[:, None, :]]       # [T, N, 8, 8]
        rec = code_blocks(x, qp=qp, control=control)
        decoded[g] = ({c: i for i, c in enumerate(cells)}, rec)
    out = []
    for f, (y1, x1, y2, x2) in boxes:
        where, rec = decoded[f // gop]
        t = f % gop
        by0, bx0 = y1 // B, x1 // B
        by1, bx1 = (y2 + B - 1) // B, (x2 + B - 1) // B
        canvas = np.empty(((by1 - by0) * B, (bx1 - bx0) * B), np.float32)
        for by in range(by0, by1):
            for bx in range(bx0, bx1):
                canvas[(by - by0) * B:(by - by0 + 1) * B,
                       (bx - bx0) * B:(bx - bx0 + 1) * B] = \
                    rec[t, where[(by, bx)]]
        oy, ox = y1 - by0 * B, x1 - bx0 * B
        out.append(canvas[oy:oy + y2 - y1, ox:ox + x2 - x1])
    return out
