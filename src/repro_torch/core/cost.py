"""Cost model (paper §4.1).

    C(s, q, L) = beta * P(s, q, L) + gamma * T(s, q, L)

P = pixels decoded, T = tiles opened.  Decoding a tile in a non-keyframe
requires decoding that tile in every frame from the preceding keyframe, so a
tile touched by the query on *any* frame of a GOP is decoded for the whole
GOP (paper §2).  ``calibrate`` re-fits (beta, gamma) from measured decode
times of *our* codec — the paper prescribes exactly this per-system re-fit
(they report R^2 = 0.996 on NVDEC; ours is reported in EXPERIMENTS.md).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Mapping, Optional, Sequence

import numpy as np

from repro_torch.core.layout import BBox, TileLayout, block_coverage


@dataclass
class CostModel:
    beta: float = 1.0e-8   # seconds per pixel decoded (calibrated)
    gamma: float = 1.0e-4  # seconds per tile opened (calibrated)
    r_squared: float = 0.0
    # -- third term: per-tile-open IO (calibrated by ``calibrate_io``) ------
    # Opening a tile decompresses its WHOLE coefficient stream for every
    # touched GOP, regardless of how few 8x8 blocks the ROI decode then
    # gathers.  beta/gamma are fit on full-tile decodes, where that
    # decompression is folded into beta — fine at tile granularity, but a
    # block-granular estimate that only charges beta on masked pixels
    # silently drops it.  ``io_per_pixel`` is the decompression seconds per
    # coefficient pixel *opened but not decoded*; 0.0 (the default) keeps
    # the legacy two-term behaviour.
    io_per_pixel: float = 0.0
    io_r_squared: float = 0.0   # fit quality of the io term (diagnostic)

    def cost(self, pixels: float, tiles: float,
             io_pixels: Optional[float] = None) -> float:
        """Estimated decode seconds.  ``io_pixels`` (block granularity
        only) is the full-tile pixel count the decode must decompress —
        the third term charges ``io_per_pixel`` for each pixel opened but
        not decoded, so a full-tile mask (``io_pixels == pixels``) costs
        exactly the two-term estimate and the granularities agree at the
        boundary."""
        c = self.beta * pixels + self.gamma * tiles
        if io_pixels is not None:
            c += self.io_per_pixel * max(io_pixels - pixels, 0.0)
        return c

    # -- encoding-cost model (R(s, L) in §4.4): linear in pixels encoded ----
    encode_per_pixel: float = 4.0e-8
    encode_per_tile: float = 2.0e-4

    def encode_cost(self, pixels: float, tiles: float) -> float:
        return self.encode_per_pixel * pixels + self.encode_per_tile * tiles


def pixels_and_tiles(layout: TileLayout, boxes_by_frame: Mapping[int, Sequence[BBox]],
                     *, gop: int, sot_frames: tuple[int, int]) -> tuple[float, float]:
    """P and T for a query hitting ``boxes_by_frame`` within one SOT.

    boxes_by_frame: frame -> requested boxes (only frames inside the SOT and
    the query's temporal range).  GOP semantics: within each GOP of the SOT,
    a tile intersecting any requested box is decoded for all frames of that
    GOP up to the last requested frame.
    """
    f_start, f_end = sot_frames
    if not boxes_by_frame:
        return 0.0, 0.0
    pixels = 0.0
    tiles = 0.0
    # group requested frames by GOP
    by_gop: dict[int, list[int]] = {}
    for f in boxes_by_frame:
        if f_start <= f < f_end:
            by_gop.setdefault((f - f_start) // gop, []).append(f)
    for g, frames in by_gop.items():
        needed: set[int] = set()
        for f in frames:
            for box in boxes_by_frame[f]:
                needed.update(layout.tiles_intersecting(box))
        if not needed:
            continue
        last = max(frames)
        gop_first = f_start + g * gop
        n_decoded_frames = last - gop_first + 1
        pixels += sum(layout.tile_pixels(t) for t in needed) * n_decoded_frames
        tiles += len(needed)
    return pixels, tiles


def roi_pixels_and_tiles(layout: TileLayout,
                         boxes_by_frame: Mapping[int, Sequence[BBox]],
                         *, gop: int, sot_frames: tuple[int, int]
                         ) -> tuple[float, float, float, dict]:
    """Block-granular P and T for ROI-restricted decode, the full-tile
    pixel count the decode must *open* (``io_pixels`` — decompressed per
    tile-open whether or not its blocks are gathered; the third cost-model
    term charges ``io_per_pixel`` on the opened-but-not-decoded gap), plus
    the per-tile block-coverage masks (``tile -> sorted block tuple |
    None`` for full).

    This is what the engine *actually* pays under ``decode_tile(blocks=...)``:
    each touched tile decodes only the blocks the query's boxes intersect,
    for the prefix of frames up to the last requested frame (matching
    ``TileStore.decode_tiles``'s depth semantics exactly, so a cold solo
    scan's estimate equals its measured ``pixels_decoded``).  T keeps the
    tile-granular tile-open count — the stream/container cost of touching a
    tile is unchanged by how few of its blocks decode.

    Note the deliberate asymmetry with :func:`pixels_and_tiles`: that
    function models a *standard full-tile decoder* and remains the input to
    layout decisions (policies' alpha/regret gates, tuner admission) — at
    block granularity the pixel term is layout-invariant (tile boundaries
    are 8-aligned), so it cannot rank layouts.
    """
    f_start, _ = sot_frames
    in_sot = {f: b for f, b in boxes_by_frame.items()
              if sot_frames[0] <= f < sot_frames[1]}
    if not in_sot:
        return 0.0, 0.0, 0.0, {}
    masks = block_coverage(layout, in_sot)
    n_frames = max(in_sot) - f_start + 1
    pixels = float(sum(
        (layout.tile_blocks(t) if m is None else len(m)) * 64
        for t, m in masks.items()) * n_frames)
    io_pixels, tiles = pixels_and_tiles(layout, in_sot, gop=gop,
                                        sot_frames=sot_frames)
    return pixels, tiles, io_pixels, masks


def query_cost(layout: TileLayout, boxes_by_frame, model: CostModel, *,
               gop: int, sot_frames: tuple[int, int]) -> float:
    p, t = pixels_and_tiles(layout, boxes_by_frame, gop=gop, sot_frames=sot_frames)
    return model.cost(p, t)


def calibrate(measurements: Iterable[tuple[float, float, float]]) -> CostModel:
    """Fit beta, gamma from (pixels, tiles, seconds) measurements (paper's
    1,400-combination linear fit, on our codec)."""
    rows = list(measurements)
    A = np.array([[p, t] for p, t, _ in rows], dtype=np.float64)
    y = np.array([s for _, _, s in rows], dtype=np.float64)
    coef, *_ = np.linalg.lstsq(A, y, rcond=None)
    pred = A @ coef
    ss_res = float(np.sum((y - pred) ** 2))
    ss_tot = float(np.sum((y - y.mean()) ** 2)) or 1e-12
    r2 = 1.0 - ss_res / ss_tot
    beta = float(max(coef[0], 1e-12))
    gamma = float(max(coef[1], 0.0))
    return CostModel(beta=beta, gamma=gamma, r_squared=r2)


def calibrate_io(measurements: Iterable[tuple[float, float, float, float]],
                 base: CostModel) -> CostModel:
    """Fit the per-tile-open IO term from ROI-restricted decode timings.

    ``measurements``: ``(masked_pixels, tiles, io_pixels, seconds)`` rows
    from block-masked decodes (tiny masks over tiles of varying size, so
    ``io_pixels - masked_pixels`` spans a wide range).  beta/gamma stay
    exactly as :func:`calibrate` fit them — tile-granularity costs (the
    basis for layout decisions) are untouched; only the residual
    ``seconds - beta*P - gamma*T`` is regressed against the
    opened-but-not-decoded pixel gap.  Sets ``io_per_pixel`` (clamped
    non-negative) and ``io_r_squared`` (fit quality of the full
    three-term prediction over these samples)."""
    rows = list(measurements)
    x = np.array([max(iop - p, 0.0) for p, _, iop, _ in rows],
                 dtype=np.float64)
    resid = np.array([s - base.cost(p, t) for p, t, _, s in rows],
                     dtype=np.float64)
    denom = float(x @ x)
    base.io_per_pixel = float(max(x @ resid / denom, 0.0)) if denom \
        else 0.0
    y = np.array([s for *_, s in rows], dtype=np.float64)
    pred = np.array([base.cost(p, t, iop) for p, t, iop, _ in rows],
                    dtype=np.float64)
    ss_res = float(np.sum((y - pred) ** 2))
    ss_tot = float(np.sum((y - y.mean()) ** 2)) or 1e-12
    base.io_r_squared = 1.0 - ss_res / ss_tot
    return base


def calibrate_encode(measurements: Iterable[tuple[float, float, float]],
                     base: CostModel) -> CostModel:
    rows = list(measurements)
    A = np.array([[p, t] for p, t, _ in rows], dtype=np.float64)
    y = np.array([s for _, _, s in rows], dtype=np.float64)
    coef, *_ = np.linalg.lstsq(A, y, rcond=None)
    base.encode_per_pixel = float(max(coef[0], 1e-12))
    base.encode_per_tile = float(max(coef[1], 0.0))
    return base
