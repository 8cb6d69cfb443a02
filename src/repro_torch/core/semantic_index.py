"""Semantic index (paper §3.2–3.3).

A B+-tree clustered on (video, label, frame); leaf values are bounding boxes
plus the id of the tile layout epoch they map to (the "pointer to the
underlying tile on disk").  Populated incrementally through ``add`` — the
ADDMETADATA(video, frame, label, x1,y1,x2,y2) API — as detections arrive as a
byproduct of query execution.

Label predicates are CNF over labels (paper §3.1): a disjunctive clause
retrieves the union of its labels' boxes; a conjunction intersects the
regions of its clauses (pixel-level bbox intersection).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Optional, Sequence

from repro_torch.core.btree import BPlusTree
from repro_torch.core.layout import BBox

# CNF: conjunction of clauses; each clause is a tuple of alternative labels.
CNF = Sequence[Sequence[str]]


def parse_predicate(labels) -> CNF:
    """Accepts 'car', ['car','person'] (one disjunctive clause), or CNF."""
    if isinstance(labels, str):
        return ((labels,),)
    labels = list(labels)
    if labels and isinstance(labels[0], str):
        return (tuple(labels),)
    return tuple(tuple(c) for c in labels)


def _intersect(a: BBox, b: BBox) -> Optional[BBox]:
    y1 = max(a[0], b[0]); x1 = max(a[1], b[1])
    y2 = min(a[2], b[2]); x2 = min(a[3], b[3])
    if y1 < y2 and x1 < x2:
        return (y1, x1, y2, x2)
    return None


@dataclass
class Detection:
    bbox: BBox
    tile_epoch: int = -1  # which layout epoch the box is stored under


class SemanticIndex:
    """Clustered on (video, label, frame)."""

    def __init__(self, order: int = 32):
        self._tree = BPlusTree(order=order)
        self._labels: dict[str, set[str]] = {}

    def add(self, video: str, frame: int, label: str, bbox: BBox,
            tile_epoch: int = -1) -> None:
        self._tree.insert((video, label, frame), Detection(tuple(bbox), tile_epoch))
        self._labels.setdefault(video, set()).add(label)

    def add_metadata(self, video_id: str, frame: int, label: str,
                     x1: int, y1: int, x2: int, y2: int) -> None:
        """The paper's ADDMETADATA signature (x/y order as in §3.1)."""
        self.add(video_id, frame, label, (y1, x1, y2, x2))

    def labels(self, video: str) -> set[str]:
        return set(self._labels.get(video, set()))

    def boxes_for_label(self, video: str, label: str,
                        frame_range: Optional[tuple[int, int]] = None
                        ) -> dict[int, list[BBox]]:
        lo_f, hi_f = frame_range if frame_range else (0, 2 ** 60)
        out: dict[int, list[BBox]] = {}
        for (v, l, f), dets in self._tree.scan((video, label, lo_f),
                                               (video, label, hi_f)):
            out.setdefault(f, []).extend(d.bbox for d in dets)
        return out

    def query(self, video: str, labels, frame_range=None) -> dict[int, list[BBox]]:
        """CNF evaluation -> frame -> list of requested regions."""
        cnf = parse_predicate(labels)
        per_clause: list[dict[int, list[BBox]]] = []
        for clause in cnf:
            merged: dict[int, list[BBox]] = {}
            for label in clause:
                for f, boxes in self.boxes_for_label(video, label, frame_range).items():
                    merged.setdefault(f, []).extend(boxes)
            per_clause.append(merged)
        out = per_clause[0]
        for nxt in per_clause[1:]:
            conj: dict[int, list[BBox]] = {}
            for f, boxes in out.items():
                if f not in nxt:
                    continue
                inter = []
                for a in boxes:
                    for b in nxt[f]:
                        got = _intersect(a, b)
                        if got:
                            inter.append(got)
                if inter:
                    conj[f] = inter
            out = conj
        return out

    def frames_with_any(self, video: str, labels: Iterable[str],
                        frame_range=None) -> set[int]:
        out: set[int] = set()
        for label in labels:
            out.update(self.boxes_for_label(video, label, frame_range))
        return out

    def has_locations(self, video: str, labels: Iterable[str],
                      frame_range) -> bool:
        """True iff the index has at least one detection for every label in
        the given range (used by the lazy strategy, §4.3)."""
        return all(bool(self.boxes_for_label(video, l, frame_range))
                   for l in labels)

    def stats(self) -> dict:
        return {"entries": len(self._tree), "depth": self._tree.depth()}

    # -- persistence (engine manifest) --------------------------------------
    def dump(self, video: str) -> list:
        """JSON-serializable records for one video:
        ``[[frame, label, [y1,x1,y2,x2], tile_epoch], ...]`` in
        (label, frame) order."""
        out = []
        for label in sorted(self._labels.get(video, ())):
            for (v, l, f), dets in self._tree.scan((video, label, -1),
                                                   (video, label, 2 ** 60)):
                for d in dets:
                    out.append([f, l, list(d.bbox), d.tile_epoch])
        return out

    def load(self, video: str, records: Iterable) -> None:
        """Re-insert :meth:`dump` records for one video."""
        for frame, label, bbox, tile_epoch in records:
            self.add(video, int(frame), label, tuple(bbox), int(tile_epoch))
