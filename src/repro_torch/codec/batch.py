"""Batched tile decode: many ``(tile, GOP-range, block-mask)`` selections in
one (or a few) fused accelerator dispatches.

``decode_tile_batch`` is the batched counterpart of
:func:`repro_torch.codec.encode.decode_tile` — the numpy path stays the
oracle, and this path matches it item by item (to float32 rounding: the
kernel sums in another order than numpy's einsum).  Instead of one
einsum call per tile per GOP inside a Python loop, the whole batch is
flattened into a padded block stream:

1. **Gather** — for every item, the selected GOPs' coefficient blocks are
   gathered (ROI block masks applied *here*, on the host, so masked-out
   blocks never reach the accelerator) into columns of a ``[F, M, 8, 8]``
   int16 stream: row 0 the intra keyframe, rows 1..n-1 the inter residuals.
2. **Bucket** — items are grouped by ``(qp, F bucket)``; each group's
   stream is allocated at power-of-two column counts
   (:func:`repro_torch.kernels.decode.ops.pad_bucket`) so stream shapes stay
   bounded across arbitrary tile layouts.  Frame-depth padding appends zero
   coefficient rows, which decode to zero pixels *after* every real frame
   and are sliced off.
3. **Dispatch** — one fused dequant+IDCT+cumsum call per group.  On a
   CUDA device the stream is filled in pinned host memory, copied to the
   device in one non-blocking copy, decoded by one launch of the CUDA
   kernel, and copied back in one copy; on the CPU the plain PyTorch
   version decodes it (see ``kernels/decode``).  A column decodes the same
   whatever batch it sits in, so serial and merged scans agree bitwise.
4. **Scatter** — each item's columns are scattered back into its output
   canvas exactly like the oracle (full tiles via the block-grid reshape,
   ROI masks via the same advanced-index write, unselected blocks zero).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.decode.ops import (MIN_COLUMNS, decode_fused_op,
                                            pad_bucket)

#: one decode request: (enc dict, gop_indices, frames_within, blocks) with
#: the exact semantics of ``decode_tile``'s parameters of the same names
DecodeItem = tuple


def _gather_gops(seq, idx: list[int]) -> np.ndarray:
    """Select GOP members from the ``kq``/``pq`` field, which is a stacked
    ndarray for in-memory tiles or a per-GOP list for lazy npz reads."""
    if isinstance(seq, np.ndarray):
        return seq[idx]
    return np.stack([seq[g] for g in idx])


def _dispatch(host: torch.Tensor, qp: int, device: torch.device) -> np.ndarray:
    """One group's decode: ``host`` (pinned when ``device`` is CUDA) ->
    ``[F, M, 8, 8]`` f32 numpy, ready to read."""
    if device.type != "cuda":
        return decode_fused_op(host, qp=qp).numpy()
    with torch.cuda.device(device):
        q = host.to(device, non_blocking=True)
        res = decode_fused_op(q, qp=qp)
        out = torch.empty(res.shape, dtype=res.dtype, pin_memory=True)
        out.copy_(res, non_blocking=True)
        torch.cuda.current_stream().synchronize()
    return out.numpy()


class _Slot:
    """Where one item's columns live inside its group's block stream."""

    __slots__ = ("item", "n", "n_gops", "bsel", "offset", "span")

    def __init__(self, item, n, n_gops, bsel, offset, span):
        self.item = item
        self.n = n                  # frames decoded per selected GOP
        self.n_gops = n_gops
        self.bsel = bsel            # None = full tile
        self.offset = offset
        self.span = span


def decode_tile_batch(items, *, device) -> list[np.ndarray]:
    """Decode many tile selections with fused batched dispatches.

    ``items``: sequence of ``(enc, gop_indices, frames_within, blocks)``
    tuples.  Returns one ``[T', h, w] float32`` array per item, equal to
    ``decode_tile(enc, gop_indices, frames_within, blocks)`` to float32
    rounding.  ``device``: where the kernel runs (``"cuda"`` or ``"cpu"``).
    """
    device = torch.device(device)
    results: list = [None] * len(items)
    # (qp, F_bucket) -> next free column / that group's slots
    columns: dict[tuple[int, int], int] = {}
    slots_by_group: dict[tuple[int, int], list[_Slot]] = {}

    for i, (enc, gop_indices, frames_within, blocks) in enumerate(items):
        h, w, gop, qp = enc["h"], enc["w"], enc["gop"], enc["qp"]
        n_gops_total = len(enc["kq"])
        idx = (list(range(n_gops_total)) if gop_indices is None
               else list(gop_indices))
        n = gop if frames_within is None else max(1, min(frames_within, gop))
        if blocks is not None:
            bsel = np.asarray(sorted(set(blocks)), dtype=np.intp)
            nb_sel = int(bsel.size)
        else:
            bsel = None
            nb_sel = (h // 8) * (w // 8)
        if not idx or nb_sel == 0:
            # nothing to dispatch: the oracle returns an all-zero canvas
            results[i] = np.zeros((len(idx) * n, h, w), dtype=np.float32)
            continue
        key = (qp, pad_bucket(n, lo=1))
        off = columns.get(key, 0)
        span = len(idx) * nb_sel
        columns[key] = off + span
        slots_by_group.setdefault(key, []).append(
            _Slot((i, enc, idx), n, len(idx), bsel, off, span))

    for (qp, f_bucket), slots in slots_by_group.items():
        total = columns[(qp, f_bucket)]
        m_pad = pad_bucket(total, lo=MIN_COLUMNS)
        host = torch.zeros((f_bucket, m_pad, 8, 8), dtype=torch.int16,
                           pin_memory=device.type == "cuda")
        q = host.numpy()
        for s in slots:
            _, enc, idx = s.item
            kq = _gather_gops(enc["kq"], idx)          # [G, nb, 8, 8]
            if s.bsel is not None:
                kq = kq[:, s.bsel]
            q[0, s.offset:s.offset + s.span] = kq.reshape(-1, 8, 8)
            if s.n > 1:
                pq = _gather_gops(enc["pq"], idx)[:, :s.n - 1]
                if s.bsel is not None:
                    pq = pq[:, :, s.bsel]
                # [G, n-1, nb, 8, 8] -> [n-1, G*nb, 8, 8] gop-major columns
                q[1:s.n, s.offset:s.offset + s.span] = \
                    pq.transpose(1, 0, 2, 3, 4).reshape(s.n - 1, s.span, 8, 8)
        out = _dispatch(host, qp, device)
        for s in slots:
            i, enc, _ = s.item
            h, w = enc["h"], enc["w"]
            seg = out[:s.n, s.offset:s.offset + s.span]
            if s.bsel is None:
                # [n, G, h/8, w/8, 8, 8] -> gop-major frames [G*n, h, w]
                arr = seg.reshape(s.n, s.n_gops, h // 8, w // 8, 8, 8)
                arr = arr.transpose(1, 0, 2, 4, 3, 5)
                # a copy: ``out`` may be pinned memory the allocator reuses
                results[i] = arr.reshape(s.n_gops * s.n, h, w).copy()
            else:
                canvas = np.zeros((s.n_gops * s.n, h, w), dtype=np.float32)
                view = canvas.reshape(-1, h // 8, 8, w // 8, 8)
                rs, cs = np.divmod(s.bsel, w // 8)
                frames = seg.reshape(s.n, s.n_gops, -1, 8, 8)
                frames = frames.transpose(1, 0, 2, 3, 4).reshape(
                    s.n_gops * s.n, -1, 8, 8)
                # same advanced-index write as the oracle's ROI scatter
                view[:, rs, :, cs] = frames.transpose(1, 0, 2, 3)
                results[i] = canvas
    return results
