"""Tile layouts (paper §2, §3.4).

A layout L = (n_r, n_c, heights, widths) partitions every frame of a SOT
along a *regular grid* (rows/columns span the whole frame — irregular layouts
are not in the HEVC spec).  The untiled video is the 1x1 layout ω.

Three constructors:
- ``uniform_layout``       (§3.4.1)
- ``fine_grained_layout``  (§3.4.2, Fig. 4a): boundaries bracket merged object
  intervals on each axis so no boundary crosses a box and non-intersecting
  boxes land in separate tiles.
- ``coarse_grained_layout``(§3.4.2, Fig. 4b): one large tile spanning the
  union of all boxes.

All boundaries are snapped to the codec block grid and respect a minimum tile
dimension (our scaled-down analogue of HEVC's minimum tile size).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Sequence

import numpy as np

BBox = tuple[int, int, int, int]  # (y1, x1, y2, x2) half-open

ALIGN = 8          # codec block size: boundaries must be multiples
MIN_TILE = 32      # minimum tile height/width (scaled-down HEVC constraint)


@dataclass(frozen=True)
class TileLayout:
    heights: tuple[int, ...]
    widths: tuple[int, ...]

    @property
    def n_rows(self) -> int:
        return len(self.heights)

    @property
    def n_cols(self) -> int:
        return len(self.widths)

    @property
    def n_tiles(self) -> int:
        return self.n_rows * self.n_cols

    @property
    def frame_height(self) -> int:
        return sum(self.heights)

    @property
    def frame_width(self) -> int:
        return sum(self.widths)

    def row_offsets(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(self.heights)])

    def col_offsets(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(self.widths)])

    def tile_rect(self, idx: int) -> BBox:
        r, c = divmod(idx, self.n_cols)
        ro, co = self.row_offsets(), self.col_offsets()
        return (int(ro[r]), int(co[c]), int(ro[r + 1]), int(co[c + 1]))

    def tile_rects(self) -> list[BBox]:
        return [self.tile_rect(i) for i in range(self.n_tiles)]

    def tile_pixels(self, idx: int) -> int:
        y1, x1, y2, x2 = self.tile_rect(idx)
        return (y2 - y1) * (x2 - x1)

    def total_pixels(self) -> int:
        return self.frame_height * self.frame_width

    def tiles_intersecting(self, box: BBox) -> list[int]:
        """Indices of tiles overlapping the (half-open) box."""
        y1, x1, y2, x2 = box
        ro, co = self.row_offsets(), self.col_offsets()
        r0 = int(np.searchsorted(ro, y1, side="right") - 1)
        r1 = int(np.searchsorted(ro, max(y2 - 1, y1), side="right") - 1)
        c0 = int(np.searchsorted(co, x1, side="right") - 1)
        c1 = int(np.searchsorted(co, max(x2 - 1, x1), side="right") - 1)
        r0, r1 = max(r0, 0), min(r1, self.n_rows - 1)
        c0, c1 = max(c0, 0), min(c1, self.n_cols - 1)
        return [r * self.n_cols + c
                for r in range(r0, r1 + 1) for c in range(c0, c1 + 1)]

    # -- 8x8 block granularity (ROI-restricted decode) ---------------------
    # Tile boundaries are ALIGN(=8)-aligned, so every tile decomposes into
    # whole codec blocks; block indices are tile-local, row-major over the
    # tile's (h/8, w/8) block grid — exactly the order the codec's
    # ``_to_blocks`` flattens them.
    def tile_blocks(self, idx: int, block: int = ALIGN) -> int:
        """Number of codec blocks in tile ``idx``."""
        y1, x1, y2, x2 = self.tile_rect(idx)
        return ((y2 - y1) // block) * ((x2 - x1) // block)

    def blocks_intersecting(self, idx: int, box: BBox,
                            block: int = ALIGN) -> list[int]:
        """Tile-local indices of the 8x8 blocks of tile ``idx`` that the
        (half-open, frame-coordinate) box overlaps."""
        ty1, tx1, ty2, tx2 = self.tile_rect(idx)
        y1, x1 = max(box[0], ty1), max(box[1], tx1)
        y2, x2 = min(box[2], ty2), min(box[3], tx2)
        if y1 >= y2 or x1 >= x2:
            return []
        nbx = (tx2 - tx1) // block
        r0, r1 = (y1 - ty1) // block, (y2 - 1 - ty1) // block
        c0, c1 = (x1 - tx1) // block, (x2 - 1 - tx1) // block
        return [r * nbx + c
                for r in range(r0, r1 + 1) for c in range(c0, c1 + 1)]

    def boundary_crosses(self, box: BBox) -> bool:
        """True if any internal tile boundary cuts through the box."""
        y1, x1, y2, x2 = box
        for b in self.row_offsets()[1:-1]:
            if y1 < b < y2:
                return True
        for b in self.col_offsets()[1:-1]:
            if x1 < b < x2:
                return True
        return False

    def describe(self) -> str:
        return f"{self.n_rows}x{self.n_cols}"


def block_coverage(layout: TileLayout, boxes_by_frame,
                   block: int = ALIGN) -> dict[int, tuple[int, ...] | None]:
    """Per-tile block-coverage mask of a set of requested boxes.

    Returns ``tile_idx -> mask`` for every tile any box intersects, where a
    mask is a sorted tuple of tile-local block indices — or ``None`` when
    the boxes cover every block of the tile (the full-tile decode fast
    path).  This is the unit the ROI-restricted decode contract threads
    from plan lowering through the scheduler and tile cache down to
    ``decode_tile(blocks=...)``.
    """
    # per-tile block bitmap + numpy slice marking: a box covers a
    # rectangular block range, so marking it is O(1) slices instead of a
    # per-block python loop (full-frame boxes would otherwise enumerate
    # every block of every tile on every frame of the plan)
    grids: dict[int, np.ndarray] = {}
    rects: dict[int, BBox] = {}
    for boxes in boxes_by_frame.values():
        for box in boxes:
            for t in layout.tiles_intersecting(box):
                rect = rects.get(t)
                if rect is None:
                    rect = rects[t] = layout.tile_rect(t)
                ty1, tx1, ty2, tx2 = rect
                y1, x1 = max(box[0], ty1), max(box[1], tx1)
                y2, x2 = min(box[2], ty2), min(box[3], tx2)
                if y1 >= y2 or x1 >= x2:
                    continue
                g = grids.get(t)
                if g is None:
                    g = grids[t] = np.zeros(((ty2 - ty1) // block,
                                             (tx2 - tx1) // block), bool)
                g[(y1 - ty1) // block:(y2 - 1 - ty1) // block + 1,
                  (x1 - tx1) // block:(x2 - 1 - tx1) // block + 1] = True
    return {t: None if g.all() else tuple(np.flatnonzero(g.ravel()).tolist())
            for t, g in grids.items()}


def single_tile_layout(height: int, width: int) -> TileLayout:
    """ω — the untiled video."""
    return TileLayout((height,), (width,))


def uniform_layout(height: int, width: int, rows: int, cols: int,
                   align: int = ALIGN) -> TileLayout:
    """Equal tiles (±alignment rounding; the last row/col absorbs remainder)."""
    rows = max(1, min(rows, height // align))
    cols = max(1, min(cols, width // align))

    def split(total: int, n: int) -> tuple[int, ...]:
        base = (total // n) // align * align
        base = max(base, align)
        sizes = [base] * n
        sizes[-1] = total - base * (n - 1)
        assert sizes[-1] >= align, (total, n, sizes)
        return tuple(sizes)

    return TileLayout(split(height, rows), split(width, cols))


# --------------------------------------------------------------------------
# Non-uniform layouts around bounding boxes
# --------------------------------------------------------------------------
def _merge_intervals(iv: list[tuple[int, int]]) -> list[tuple[int, int]]:
    if not iv:
        return []
    iv = sorted(iv)
    out = [list(iv[0])]
    for s, e in iv[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _axis_cuts(intervals: list[tuple[int, int]], total: int, *,
               align: int, min_tile: int) -> tuple[int, ...]:
    """Cut positions bracketing merged intervals, aligned, respecting minimum
    tile size, and never cutting through an interval."""
    merged = _merge_intervals(intervals)
    cuts = {0, total}
    for s, e in merged:
        cuts.add(max(0, (s // align) * align))        # snap start down
        cuts.add(min(total, -(-e // align) * align))  # snap end up
    # a snapped edge of one interval may land inside a neighbouring interval
    # when the gap between them is < align: drop any cut that crosses a box
    cuts = {c for c in cuts if not any(s < c < e for s, e in merged)} | {0, total}
    ordered = sorted(cuts)
    # enforce min tile size by dropping offending internal cuts (dropping a
    # cut merges tiles and can never cut a box)
    ok = [ordered[0]]
    for c in ordered[1:-1]:
        if c - ok[-1] >= min_tile and total - c >= min_tile:
            ok.append(c)
    ok.append(total)
    sizes = tuple(b - a for a, b in zip(ok[:-1], ok[1:]))
    assert sum(sizes) == total
    return sizes


def fine_grained_layout(height: int, width: int, boxes: Iterable[BBox], *,
                        align: int = ALIGN, min_tile: int = MIN_TILE) -> TileLayout:
    boxes = list(boxes)
    if not boxes:
        return single_tile_layout(height, width)
    hs = _axis_cuts([(b[0], b[2]) for b in boxes], height,
                    align=align, min_tile=min_tile)
    ws = _axis_cuts([(b[1], b[3]) for b in boxes], width,
                    align=align, min_tile=min_tile)
    return TileLayout(hs, ws)


def coarse_grained_layout(height: int, width: int, boxes: Iterable[BBox], *,
                          align: int = ALIGN, min_tile: int = MIN_TILE) -> TileLayout:
    boxes = list(boxes)
    if not boxes:
        return single_tile_layout(height, width)
    y1 = min(b[0] for b in boxes)
    y2 = max(b[2] for b in boxes)
    x1 = min(b[1] for b in boxes)
    x2 = max(b[3] for b in boxes)
    hs = _axis_cuts([(y1, y2)], height, align=align, min_tile=min_tile)
    ws = _axis_cuts([(x1, x2)], width, align=align, min_tile=min_tile)
    return TileLayout(hs, ws)


def partition(height: int, width: int, boxes: Iterable[BBox], *,
              granularity: str = "fine", align: int = ALIGN,
              min_tile: int = MIN_TILE) -> TileLayout:
    """PARTITION(s, O) from the paper: non-uniform layout around boxes."""
    fn = fine_grained_layout if granularity == "fine" else coarse_grained_layout
    return fn(height, width, boxes, align=align, min_tile=min_tile)
