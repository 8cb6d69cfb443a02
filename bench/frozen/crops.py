"""Frozen copies of the analytics pipeline's crop stream and frontend stub.

``crop_regions`` is the crop loop of
``src/repro_torch/train/data.py::tasm_region_batches`` and ``patch_embeds``
is ``examples/video_analytics_torch.py::patch_embeds``, both at commit
d863ae1.  The benchmark scans through the program itself and turns what the
scan returns into the backbone's input here, so a later change to the
program's example cannot change what a cell feeds its model.
"""
from __future__ import annotations

import numpy as np
import torch


def crop_regions(regions, *, count: int, crop: int, min_side: int = 8):
    """The first ``count`` scanned regions at least ``min_side`` pixels a
    side, each cut or zero-padded to ``crop`` x ``crop`` (f32), in the scan's
    order: ([count, crop, crop] array, the regions used).  Fewer than
    ``count`` such regions gives fewer crops."""
    pixels, used = [], []
    for region in regions:
        px = region[2]
        if min(px.shape) < min_side:
            continue
        out = np.zeros((crop, crop), np.float32)
        h, w = min(crop, px.shape[0]), min(crop, px.shape[1])
        out[:h, :w] = px[:h, :w]
        pixels.append(out)
        used.append(region)
        if len(pixels) >= count:
            break
    if not pixels:
        return np.zeros((0, crop, crop), np.float32), used
    return np.stack(pixels), used


def patch_embeds(pixels: torch.Tensor, frontend_tokens: int,
                 frontend_dim: int) -> torch.Tensor:
    """The frontend stub: crops [B, crop, crop] -> patch embeddings
    [B, frontend_tokens, frontend_dim], the crop's pixels in order,
    zero-padded, over 255."""
    b = pixels.shape[0]
    need = frontend_tokens * frontend_dim
    pe = pixels.reshape(b, -1)[:, :need]
    pe = torch.nn.functional.pad(pe, (0, max(0, need - pe.shape[1])))
    return pe.reshape(b, frontend_tokens, frontend_dim) / 255.0
