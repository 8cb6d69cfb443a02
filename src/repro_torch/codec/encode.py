"""Tile encode/decode: GOP-structured transform coding.

Keyframes (first frame of each GOP) are intra-coded (DCT + quant of pixels);
the rest are P-frames coding the residual against the previous *reconstructed*
frame (closed-loop, like a real encoder, so decode drift is zero).  A tile is
an independently decodable unit: encoding never references pixels outside the
tile — exactly the HEVC tile property TASM exploits.

``encode_tile`` / ``decode_tile`` are numpy and are the oracles: the
batched CUDA decode (``codec/batch.py`` over ``kernels/decode``) and the
device encoder ``encode_tiles`` (over ``kernels/dct`` and ``kernels/idct``)
are validated against them; decode cost remains proportional to (pixels,
tiles) on both, which is what the calibrated cost model captures.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.codec import bitstream
from repro_torch.codec.quant import quant_matrix
from repro_torch.codec.transform import dct_matrix, to_blocks


@dataclass(frozen=True)
class EncoderConfig:
    gop: int = 16          # frames per GOP (keyframe interval)
    qp: int = 8            # quantization level (~42dB on the synthetic corpus)
    block: int = 8


# --------------------------------------------------------------------------
# numpy blockwise DCT helpers
# --------------------------------------------------------------------------
def _to_blocks(frame: np.ndarray, b: int = 8) -> np.ndarray:
    h, w = frame.shape
    x = frame.reshape(h // b, b, w // b, b).swapaxes(1, 2)
    return x.reshape(-1, b, b)


def _from_blocks(blocks: np.ndarray, h: int, w: int, b: int = 8) -> np.ndarray:
    x = blocks.reshape(h // b, w // b, b, b).swapaxes(1, 2)
    return x.reshape(h, w)


def _dct2(blocks: np.ndarray) -> np.ndarray:
    d = dct_matrix()
    return np.einsum("ij,njk,lk->nil", d, blocks, d, optimize=True)


def _idct2(coeffs: np.ndarray) -> np.ndarray:
    d = dct_matrix()
    return np.einsum("ji,njk,kl->nil", d, coeffs, d, optimize=True)


def _q(coeffs: np.ndarray, qp: int, intra: bool) -> np.ndarray:
    m = quant_matrix(qp, intra)
    return np.round(coeffs / m).astype(np.int16)


def _dq(q: np.ndarray, qp: int, intra: bool) -> np.ndarray:
    return q.astype(np.float32) * quant_matrix(qp, intra)


# --------------------------------------------------------------------------
# Tile encode / decode
# --------------------------------------------------------------------------
def encode_tile(frames: np.ndarray, cfg: EncoderConfig) -> dict:
    """frames: [T, h, w] float32 in [0, 255]; T must be a multiple of gop."""
    t, h, w = frames.shape
    assert t % cfg.gop == 0, (t, cfg.gop)
    assert h % cfg.block == 0 and w % cfg.block == 0, (h, w)
    n_gops = t // cfg.gop
    nb = (h // cfg.block) * (w // cfg.block)
    kq = np.empty((n_gops, nb, 8, 8), dtype=np.int16)
    pq = np.empty((n_gops, cfg.gop - 1, nb, 8, 8), dtype=np.int16)
    for g in range(n_gops):
        f0 = g * cfg.gop
        kq[g] = _q(_dct2(_to_blocks(frames[f0].astype(np.float32))), cfg.qp, True)
        recon = _from_blocks(_idct2(_dq(kq[g], cfg.qp, True)), h, w)
        for i in range(1, cfg.gop):
            resid = frames[f0 + i].astype(np.float32) - recon
            q = _q(_dct2(_to_blocks(resid)), cfg.qp, False)
            pq[g, i - 1] = q
            recon = recon + _from_blocks(_idct2(_dq(q, cfg.qp, False)), h, w)
    size = bitstream.stream_bytes_np(kq) + bitstream.stream_bytes_np(pq)
    return {"kq": kq, "pq": pq, "h": h, "w": w, "gop": cfg.gop, "qp": cfg.qp,
            "size_bytes": float(size), "n_frames": t}


def _stream_index(rects, h: int, w: int, b: int):
    """Frame-block indices of every tile's blocks, tile after tile, each
    tile's row-major (the order ``encode_tile`` gives its blocks), and each
    tile's ``(offset, n_blocks, height, width)`` in that stream."""
    idx, spans, off = [], [], 0
    for rect in rects:
        y1, x1, y2, x2 = (int(v) for v in rect)
        if (any(v % b for v in (y1, x1, y2, x2)) or not 0 <= y1 < y2 <= h
                or not 0 <= x1 < x2 <= w):
            raise ValueError(f"tile {rect} must lie on the {b}-pixel grid "
                             f"inside the {h}x{w} frame")
        rows = np.arange(y1 // b, y2 // b)[:, None] * (w // b)
        blocks = (rows + np.arange(x1 // b, x2 // b)[None, :]).ravel()
        idx.append(blocks)
        spans.append((off, blocks.size, y2 - y1, x2 - x1))
        off += blocks.size
    return np.concatenate(idx).astype(np.int64), spans


def encode_tiles(frames: np.ndarray, rects, cfg: EncoderConfig, *,
                 device) -> list[dict]:
    """Encode every tile ``rect`` of one SOT at once on ``device``.

    ``frames``: [T, H, W] in [0, 255], T a multiple of ``cfg.gop``;
    ``rects``: ``(y1, x1, y2, x2)`` tiles on the 8-pixel grid.  Returns one
    dict per rect, as ``encode_tile(frames[:, y1:y2, x1:x2], cfg)`` does.

    The closed loop of ``encode_tile``, run for all tiles together: the
    codec has no intra or motion prediction, so a tile's blocks are a
    gather of the frame's blocks, and every frame of the SOT is one stream
    of all tiles' blocks.  Per GOP, one ``dct_quant_op`` over the
    keyframe's stream and ``recon = idct_dequant_op(kq)``; per P-frame
    ``q = dct_quant_op(frame - recon)`` and ``recon += idct_dequant_op(q)``
    (skipped after the GOP's last frame, whose reconstruction is unused).
    On a CUDA device the frames go over once through pinned memory, the
    kernels launch on the current stream, the coefficients come back once
    as int16, and the stream is synchronised before any host read.  A
    block's arithmetic depends only on that block, so a tile encodes the
    same bits in any batch of tiles.  ``size_bytes`` is the host size
    model ``stream_bytes_np``, exactly the reference's formula.
    """
    # late import: the kernels import this package's quant and transform
    from repro_torch.kernels.dct.ops import dct_quant_op
    from repro_torch.kernels.idct.ops import idct_dequant_op

    frames = np.ascontiguousarray(frames, dtype=np.float32)
    t, h, w = frames.shape
    b, gop, qp = cfg.block, cfg.gop, cfg.qp
    if t % gop or h % b or w % b:
        raise ValueError(f"frames {frames.shape} must hold whole GOPs of "
                         f"{gop} frames of {b}-pixel blocks")
    idx, spans = _stream_index(rects, h, w, b)
    device = torch.device(device)
    on_cuda = device.type == "cuda"
    guard = torch.cuda.device(device) if on_cuda else contextlib.nullcontext()
    with guard:
        host = torch.from_numpy(frames)
        if on_cuda:
            staged = torch.empty(host.shape, dtype=host.dtype,
                                 pin_memory=True)
            staged.copy_(host)
            host = staged.to(device, non_blocking=True)
        # [T, N, 8, 8]: each frame's stream of all tiles' blocks
        x = to_blocks(host)[:, torch.from_numpy(idx).to(device)]
        del host
        coeffs = []
        for g in range(t // gop):
            f0 = g * gop
            q = dct_quant_op(x[f0], qp=qp, intra=True)
            coeffs.append(q)
            if gop > 1:
                recon = idct_dequant_op(q, qp=qp, intra=True)
            for i in range(1, gop):
                q = dct_quant_op(x[f0 + i] - recon, qp=qp, intra=False)
                coeffs.append(q)
                if i < gop - 1:
                    recon = recon + idct_dequant_op(q, qp=qp, intra=False)
        q = torch.stack(coeffs)
        if on_cuda:
            out = torch.empty(q.shape, dtype=q.dtype, pin_memory=True)
            out.copy_(q, non_blocking=True)
            torch.cuda.current_stream().synchronize()
            q = out
    arr = q.numpy().reshape(t // gop, gop, len(idx), b, b)
    encs = []
    for off, nb, th, tw in spans:
        # copies: ``arr`` may be pinned memory the allocator reuses
        kq = arr[:, 0, off:off + nb].copy()
        pq = arr[:, 1:, off:off + nb].copy()
        size = bitstream.stream_bytes_np(kq) + bitstream.stream_bytes_np(pq)
        encs.append({"kq": kq, "pq": pq, "h": th, "w": tw, "gop": gop,
                     "qp": qp, "size_bytes": float(size), "n_frames": t})
    return encs


def decode_tile(enc: dict, gop_indices=None,
                frames_within: int | None = None,
                blocks=None) -> np.ndarray:
    """Decode (a subset of GOPs of) an encoded tile -> [T', h, w] float32.

    P-frame residuals are independent given the keyframe, so the whole GOP's
    dequant+IDCT runs as ONE batched einsum followed by a cumulative sum over
    frames — this collapses per-frame call overhead (the gamma term of the
    cost model) by ~8x vs a sequential loop and mirrors how the CUDA decode
    kernel batches blocks.

    ``frames_within``: decode only the first n frames of each selected GOP
    (temporal random access stops at the last requested frame — a decoder
    never needs the rest of the GOP).  Fixes long-SOT overdecode in Fig. 9.

    ``blocks``: ROI-restricted decode — only the given (tile-local,
    row-major) 8x8-block indices are dequantized, transformed and summed;
    the rest of the output stays zero.  The codec has no intra-block
    prediction, so each selected block's pixels are bit-identical to the
    same block of a full decode (dequant+IDCT+cumsum all operate per
    block).  Work becomes proportional to ``len(blocks)``, not tile area.
    ``blocks=None`` is the full-tile path, unchanged.
    """
    h, w, gop, qp = enc["h"], enc["w"], enc["gop"], enc["qp"]
    n_gops = len(enc["kq"])
    idx = list(range(n_gops)) if gop_indices is None else list(gop_indices)
    n = gop if frames_within is None else max(1, min(frames_within, gop))
    d = dct_matrix()
    m_k = quant_matrix(qp, True)
    m_p = quant_matrix(qp, False)
    if blocks is not None:
        bsel = np.asarray(sorted(set(blocks)), dtype=np.intp)
        out = np.zeros((len(idx) * n, h, w), dtype=np.float32)
        if bsel.size == 0:
            return out
        rs, cs = np.divmod(bsel, w // 8)
        # writable block view of the output canvas: [T', h/8, 8, w/8, 8]
        view = out.reshape(len(idx) * n, h // 8, 8, w // 8, 8)
        for j, g in enumerate(idx):
            key = _idct2(enc["kq"][g][bsel].astype(np.float32) * m_k)
            pq = enc["pq"][g][: n - 1][:, bsel]  # [n-1, nb_sel, 8, 8]
            coeffs = pq.astype(np.float32) * m_p
            resid = np.einsum("ji,fnjk,kl->fnil", d, coeffs, d, optimize=True)
            frames = np.concatenate([key[None], resid], axis=0)
            np.cumsum(frames, axis=0, out=frames)  # [n, nb_sel, 8, 8]
            # advanced indices on axes 1 and 3 land first: [nb_sel, n, 8, 8]
            view[j * n:(j + 1) * n][:, rs, :, cs] = \
                frames.transpose(1, 0, 2, 3)
        return out
    out = np.empty((len(idx) * n, h, w), dtype=np.float32)
    for j, g in enumerate(idx):
        key = _from_blocks(_idct2(enc["kq"][g].astype(np.float32) * m_k), h, w)
        pq = enc["pq"][g][: n - 1]  # [n-1, nb, 8, 8]
        coeffs = pq.astype(np.float32) * m_p
        resid = np.einsum("ji,fnjk,kl->fnil", d, coeffs, d, optimize=True)
        resid = resid.reshape(n - 1, h // 8, w // 8, 8, 8)
        resid = resid.swapaxes(2, 3).reshape(n - 1, h, w)
        frames = np.concatenate([key[None], resid], axis=0)
        np.cumsum(frames, axis=0, out=frames)
        out[j * n:(j + 1) * n] = frames
    return out


def encoded_size_bytes(enc: dict) -> float:
    return enc["size_bytes"]
