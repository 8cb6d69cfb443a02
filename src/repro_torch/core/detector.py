"""Object detectors feeding the semantic index (paper §3.3, §5.2.4).

No GPU model is available, so detection quality/cost regimes are modelled on
the paper's three settings, all derived from generator ground truth except
background subtraction (which is computed from real frame differences):

- ``full``   : YOLOv3-analogue — every object, tight boxes, every frame.
- ``strided``: full quality every k-th frame, boxes propagated between
               detections (the "YOLOv3 every five frames" edge regime).
- ``tiny``   : Tiny-YOLO-analogue — misses a (seeded) fraction of objects and
               jitters boxes (the paper found this yields poor layouts).
- ``bgsub``  : real frame-difference foreground extraction (KNN-subtraction
               stand-in; genuinely fails on camera pan, as in the paper).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.core.layout import BBox


@dataclass
class DetectorConfig:
    kind: str = "full"      # full | strided | tiny | bgsub
    stride: int = 1         # detect every k-th frame (strided)
    miss_rate: float = 0.0  # fraction of objects missed (tiny: ~0.5)
    jitter: int = 0         # bbox jitter in px (tiny: ~4)
    seconds_per_frame: float = 0.05  # modelled detector latency (YOLOv3-ish)
    seed: int = 0


def detect(frames: np.ndarray, gt_detections, cfg: DetectorConfig,
           frame_range: Optional[tuple[int, int]] = None):
    """Returns (detections_by_frame, modelled_seconds).

    detections_by_frame: frame -> [(label, bbox)].
    """
    lo, hi = frame_range if frame_range else (0, len(gt_detections))
    lo, hi = max(lo, 0), min(hi, len(gt_detections))
    rng = np.random.default_rng(cfg.seed + lo)
    out: dict[int, list] = {}

    if cfg.kind == "bgsub":
        secs = 0.002 * (hi - lo)  # cheap
        for f in range(max(lo, 1), hi):
            diff = np.abs(frames[f] - frames[f - 1]) > 25.0
            if not diff.any():
                continue
            ys, xs = np.nonzero(diff)
            # single foreground box around all motion (KNN-subtraction-grade)
            box = (int(ys.min()), int(xs.min()), int(ys.max()) + 1, int(xs.max()) + 1)
            out[f] = [("object", box)]
        return out, secs

    stride = cfg.stride if cfg.kind == "strided" else 1
    detected_frames = list(range(lo, hi, stride))
    secs = cfg.seconds_per_frame * len(detected_frames)
    H = frames.shape[1] if frames is not None else 10 ** 9
    W = frames.shape[2] if frames is not None else 10 ** 9
    for f in detected_frames:
        dets = []
        for label, bbox in gt_detections[f]:
            if cfg.kind == "tiny" or cfg.miss_rate > 0:
                miss = cfg.miss_rate if cfg.miss_rate > 0 else 0.5
                if rng.random() < miss:
                    continue
            box = bbox
            jit = cfg.jitter if cfg.jitter else (4 if cfg.kind == "tiny" else 0)
            if jit:
                dy, dx = rng.integers(-jit, jit + 1, size=2)
                box = (int(np.clip(bbox[0] + dy, 0, H - 1)),
                       int(np.clip(bbox[1] + dx, 0, W - 1)),
                       int(np.clip(bbox[2] + dy, 1, H)),
                       int(np.clip(bbox[3] + dx, 1, W)))
            dets.append((label, box))
        if dets:
            out[f] = dets
    # strided: propagate each detection to the skipped frames (cheap tracking)
    if stride > 1:
        filled: dict[int, list] = {}
        for f in range(lo, hi):
            anchor = lo + ((f - lo) // stride) * stride
            if anchor in out:
                filled[f] = out[anchor]
        out = filled
    return out, secs
