"""Spatial grid index over bounding boxes (paper §3.2's suggested extension:
"A spatial index could further accelerate queries containing conjunctive
predicates by efficiently computing the intersection of bounding boxes
before fetching tiles").

A uniform grid (cell lists) per (video, frame): conjunctive CNF evaluation
only tests box pairs sharing a grid cell instead of the full cross product —
O(n·k) instead of O(n·m) when boxes are sparse.  Plugged into SemanticIndex
as an optional accelerator; equivalence with the brute-force path is property
tested.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Iterable, Optional

from repro_torch.core.layout import BBox


def _intersect(a: BBox, b: BBox) -> Optional[BBox]:
    y1 = max(a[0], b[0]); x1 = max(a[1], b[1])
    y2 = min(a[2], b[2]); x2 = min(a[3], b[3])
    if y1 < y2 and x1 < x2:
        return (y1, x1, y2, x2)
    return None


class SpatialGrid:
    """A uniform grid over one frame's boxes."""

    def __init__(self, cell: int = 64):
        self.cell = cell
        self._cells: dict[tuple[int, int], list[int]] = defaultdict(list)
        self._boxes: list[BBox] = []

    def add(self, box: BBox) -> int:
        idx = len(self._boxes)
        self._boxes.append(box)
        y1, x1, y2, x2 = box
        for cy in range(y1 // self.cell, (max(y2 - 1, y1)) // self.cell + 1):
            for cx in range(x1 // self.cell, (max(x2 - 1, x1)) // self.cell + 1):
                self._cells[(cy, cx)].append(idx)
        return idx

    def candidates(self, box: BBox) -> set[int]:
        y1, x1, y2, x2 = box
        out: set[int] = set()
        for cy in range(y1 // self.cell, (max(y2 - 1, y1)) // self.cell + 1):
            for cx in range(x1 // self.cell, (max(x2 - 1, x1)) // self.cell + 1):
                out.update(self._cells.get((cy, cx), ()))
        return out

    def intersections(self, box: BBox) -> list[BBox]:
        out = []
        for i in sorted(self.candidates(box)):
            got = _intersect(box, self._boxes[i])
            if got:
                out.append(got)
        return out


def conjunctive_intersections(clause_a: Iterable[BBox], clause_b: Iterable[BBox],
                              *, cell: int = 64) -> list[BBox]:
    """All pairwise intersections between two box sets, grid-accelerated.

    Result order/content matches the brute-force nested loop (deduplicated,
    sorted) — verified by property test against the SemanticIndex path.
    """
    grid = SpatialGrid(cell=cell)
    bs = list(clause_b)
    for b in bs:
        grid.add(b)
    out: set[BBox] = set()
    for a in clause_a:
        out.update(grid.intersections(a))
    return sorted(out)


def brute_force_intersections(clause_a, clause_b) -> list[BBox]:
    out: set[BBox] = set()
    for a in clause_a:
        for b in clause_b:
            got = _intersect(a, b)
            if got:
                out.add(got)
    return sorted(out)
