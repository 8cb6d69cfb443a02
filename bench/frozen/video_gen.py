"""Frozen copy of src/repro_torch/data/video_gen.py at commit d863ae1 (the
benchmark's own, so a later change to the program cannot change the
video a cell stores).  The original's docstring follows.

Procedural Visual-Road-style video generator.

Produces (frames [T, H, W] float32 luma in [0,255], detections) with exact
ground-truth bounding boxes.  Object classes, counts and sizes are seeded and
configurable, so the paper's sparse (<20% frame coverage) and dense (>=20%)
regimes are reproducible on CPU at any resolution.  A panning camera and
textured background keep the codec honest (residuals are non-trivial).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

BBox = tuple[int, int, int, int]  # (y1, x1, y2, x2), half-open


@dataclass
class ObjectSpec:
    label: str
    count: int
    size: tuple[int, int]          # (h, w) nominal
    speed: float = 2.0             # px/frame
    intensity: float = 200.0


@dataclass
class VideoSpec:
    height: int = 192
    width: int = 320
    n_frames: int = 256
    seed: int = 0
    camera_pan: float = 0.0        # background px/frame
    objects: list[ObjectSpec] = field(default_factory=lambda: [
        ObjectSpec("car", 3, (28, 44), 2.5, 210.0),
        ObjectSpec("person", 4, (30, 14), 1.2, 240.0),
    ])

    @property
    def shape(self):
        return (self.n_frames, self.height, self.width)


# Preset regimes used throughout the benchmarks (Table 1 analogues)
def sparse_spec(seed=0, n_frames=256, height=192, width=320) -> VideoSpec:
    return VideoSpec(height=height, width=width, n_frames=n_frames, seed=seed)


def dense_spec(seed=0, n_frames=256, height=192, width=320) -> VideoSpec:
    return VideoSpec(
        height=height, width=width, n_frames=n_frames, seed=seed,
        objects=[
            ObjectSpec("car", 6, (44, 72), 2.0, 210.0),
            ObjectSpec("person", 8, (48, 22), 1.5, 240.0),
            ObjectSpec("boat", 2, (52, 88), 1.0, 180.0),
        ])


def multiclass_spec(seed=0, n_frames=256, height=192, width=320) -> VideoSpec:
    spec = sparse_spec(seed, n_frames, height, width)
    spec.objects = spec.objects + [ObjectSpec("traffic_light", 1, (18, 8), 0.3, 250.0)]
    return spec


def generate(spec: VideoSpec):
    """Returns (frames [T,H,W] float32, detections: list per frame of
    (label, bbox))."""
    rng = np.random.default_rng(spec.seed)
    T, H, W = spec.n_frames, spec.height, spec.width

    # textured background, wide enough to pan over.  Noise is smoothed with a
    # separable box blur: real video backgrounds are spatially correlated —
    # white noise would be uncodeable and sink PSNR for any codec.
    pan_total = int(abs(spec.camera_pan) * T) + W + 8
    noise = rng.normal(0.0, 14.0, size=(H + 8, pan_total + 8))
    k = np.ones(9) / 9.0
    noise = np.apply_along_axis(lambda r: np.convolve(r, k, mode="same"), 1, noise)
    noise = np.apply_along_axis(lambda c: np.convolve(c, k, mode="same"), 0, noise)
    bg_base = 110.0 + 3.0 * noise[4:H + 4, 4:pan_total + 4]
    yy = np.linspace(0, 6 * np.pi, H)[:, None]
    xx = np.linspace(0, 6 * np.pi * pan_total / W, pan_total)[None, :]
    bg_base = bg_base + 25 * np.sin(yy) * np.cos(xx)
    bg_base = np.clip(bg_base, 0, 255).astype(np.float32)

    # object trajectories: linear with bounce, randomized phase
    objs = []
    for ospec in spec.objects:
        for i in range(ospec.count):
            h = max(8, int(ospec.size[0] * rng.uniform(0.8, 1.25)))
            w = max(8, int(ospec.size[1] * rng.uniform(0.8, 1.25)))
            y0 = rng.uniform(0, max(H - h, 1))
            x0 = rng.uniform(0, max(W - w, 1))
            ang = rng.uniform(0, 2 * np.pi)
            vy = ospec.speed * np.sin(ang)
            vx = ospec.speed * np.cos(ang)
            tex = rng.normal(ospec.intensity, 4.0, size=(h, w)).astype(np.float32)
            tex[::4] -= 12.0  # horizontal banding: structured, codeable texture
            tex = np.clip(tex, 0, 255)
            objs.append(dict(label=ospec.label, h=h, w=w, y=y0, x=x0,
                             vy=vy, vx=vx, tex=tex))

    frames = np.empty((T, H, W), dtype=np.float32)
    detections: list[list[tuple[str, BBox]]] = []
    for t in range(T):
        off = int(abs(spec.camera_pan) * t)
        frame = bg_base[:, off:off + W].copy()
        dets: list[tuple[str, BBox]] = []
        for o in objs:
            # integrate & bounce
            o["y"] += o["vy"]
            o["x"] += o["vx"]
            if o["y"] < 0 or o["y"] + o["h"] > H:
                o["vy"] = -o["vy"]
                o["y"] = np.clip(o["y"], 0, H - o["h"])
            if o["x"] < 0 or o["x"] + o["w"] > W:
                o["vx"] = -o["vx"]
                o["x"] = np.clip(o["x"], 0, W - o["w"])
            y, x = int(o["y"]), int(o["x"])
            frame[y:y + o["h"], x:x + o["w"]] = o["tex"]
            dets.append((o["label"], (y, x, y + o["h"], x + o["w"])))
        frames[t] = frame
        detections.append(dets)
    return frames, detections


def coverage(detections, height: int, width: int) -> float:
    """Mean fraction of frame area covered by objects (Table-1 statistic)."""
    fracs = []
    for dets in detections:
        m = np.zeros((height, width), dtype=bool)
        for _, (y1, x1, y2, x2) in dets:
            m[y1:y2, x1:x2] = True
        fracs.append(m.mean())
    return float(np.mean(fracs))
