"""Cost-model calibration (paper §4.1), timed on the port's own codec.

The paper fits ``C = beta*P + gamma*T`` on >1,400 (video, query object,
layout) decode measurements (R^2 = 0.996 on NVDEC) and prescribes re-fitting
per system.  This module measures *this* port on ``device``: it encodes
sample videos under a spread of uniform and non-uniform layouts with the
device encoder (``encode_tiles``), times the batched tile decodes the store
runs (``decode_tile_batch``), and fits (beta, gamma) — and analogously the
re-encode model R(s, L) from timed ``encode_tiles`` calls.  Both return
host arrays only after synchronising the device, so every timed loop ends
with the device's work done.  The sample grid (videos, layouts, tile
prefixes) is the reference's, so the (pixels, tiles) columns match it.
"""
from __future__ import annotations

import time

from repro_torch.codec.batch import decode_tile_batch
from repro_torch.codec.encode import EncoderConfig, encode_tiles
from repro_torch.core.cost import (CostModel, calibrate, calibrate_encode,
                                   calibrate_io)
from repro_torch.core.layout import (TileLayout, fine_grained_layout,
                                     single_tile_layout, uniform_layout)
from repro_torch.data.video_gen import dense_spec, generate, sparse_spec
from repro_torch.kernels.decode.ops import resolve_device


def _sample_layouts(H: int, W: int, detections) -> list[TileLayout]:
    layouts = [single_tile_layout(H, W)]
    for r, c in [(1, 2), (2, 2), (2, 3), (3, 3), (3, 5), (4, 4), (4, 6)]:
        layouts.append(uniform_layout(H, W, r, c))
    # non-uniform around each label on a few windows
    labels = {l for dets in detections[:32] for l, _ in dets}
    for label in sorted(labels):
        boxes = [b for dets in detections[:16] for l, b in dets if l == label]
        if boxes:
            layouts.append(fine_grained_layout(H, W, boxes))
    return layouts


def measure_decode_samples(enc_cfg: EncoderConfig, *, seeds=(0, 1),
                           n_frames: int = 32, height: int = 192,
                           width: int = 320, repeats: int = 2,
                           device="cuda"):
    """Returns [(pixels, tiles, seconds)] over layout x video samples."""
    device = resolve_device(device)
    samples: list[tuple[float, float, float]] = []
    for seed in seeds:
        for spec_fn in (sparse_spec, dense_spec):
            spec = spec_fn(seed=seed, n_frames=n_frames, height=height,
                           width=width)
            frames, dets = generate(spec)
            for layout in _sample_layouts(height, width, dets):
                encs = encode_tiles(frames, layout.tile_rects(), enc_cfg,
                                    device=device)
                # decode a prefix of tiles (1, half, all) to vary P and T
                for n_tiles in sorted({1, max(1, layout.n_tiles // 2),
                                       layout.n_tiles}):
                    chosen = encs[:n_tiles]
                    items = [(e, None, None, None) for e in chosen]
                    # warm
                    decode_tile_batch([(e, [0], None, None) for e in chosen],
                                      device=device)
                    t0 = time.perf_counter()
                    for _ in range(repeats):
                        decode_tile_batch(items, device=device)
                    dt = (time.perf_counter() - t0) / repeats
                    pixels = sum(e["h"] * e["w"] * e["n_frames"] for e in chosen)
                    samples.append((float(pixels), float(len(chosen)), dt))
    return samples


def measure_io_samples(enc_cfg: EncoderConfig, *, seed=0,
                       n_frames: int = 32, height: int = 192,
                       width: int = 320, repeats: int = 2, device="cuda"):
    """``(masked_pixels, tiles, io_pixels, seconds)`` rows from
    block-masked (ROI-restricted) decodes: a single 8x8 block gathered
    out of tiles of varying size, across varying GOP prefixes, so the
    opened-but-not-decoded pixel gap spans a wide range while the
    gathered pixel count stays tiny.  Feeds :func:`calibrate_io`."""
    device = resolve_device(device)
    spec = sparse_spec(seed=seed, n_frames=n_frames, height=height,
                       width=width)
    frames, _ = generate(spec)
    samples: list[tuple[float, float, float, float]] = []
    for r, c in [(1, 1), (2, 2), (3, 3), (4, 6)]:
        layout = uniform_layout(height, width, r, c)
        rect = layout.tile_rects()[0]
        enc, = encode_tiles(frames, [rect], enc_cfg, device=device)
        y1, x1, y2, x2 = rect
        th, tw = y2 - y1, x2 - x1
        n_gops = max(1, n_frames // enc_cfg.gop)
        for k in sorted({1, max(1, n_gops // 2), n_gops}):
            items = [(enc, list(range(k)), None, (0,))]
            decode_tile_batch(items, device=device)  # warm
            t0 = time.perf_counter()
            for _ in range(repeats):
                decode_tile_batch(items, device=device)
            dt = (time.perf_counter() - t0) / repeats
            f_decoded = k * enc_cfg.gop
            samples.append((64.0 * f_decoded, float(k),
                            float(th * tw * f_decoded), dt))
    return samples


def measure_encode_samples(enc_cfg: EncoderConfig, *, seed=0,
                           n_frames: int = 32, height: int = 192,
                           width: int = 320, device="cuda"):
    device = resolve_device(device)
    samples: list[tuple[float, float, float]] = []
    spec = sparse_spec(seed=seed, n_frames=n_frames, height=height, width=width)
    frames, dets = generate(spec)
    layouts = _sample_layouts(height, width, dets)[:8]
    # warm: the first call builds the kernels
    encode_tiles(frames, layouts[0].tile_rects(), enc_cfg, device=device)
    for layout in layouts:
        t0 = time.perf_counter()
        encode_tiles(frames, layout.tile_rects(), enc_cfg, device=device)
        dt = time.perf_counter() - t0
        samples.append((float(height * width * n_frames),
                        float(layout.n_tiles), dt))
    return samples


def calibrated_cost_model(enc_cfg: EncoderConfig | None = None, *,
                          device="cuda", **kw) -> CostModel:
    """Measure + fit both the decode and encode linear models on
    ``device`` (the store's: ``"cuda"`` unless the caller asks for the
    CPU)."""
    enc_cfg = enc_cfg or EncoderConfig()
    model = calibrate(measure_decode_samples(enc_cfg, device=device, **kw))
    model = calibrate_encode(measure_encode_samples(enc_cfg, device=device),
                             model)
    model = calibrate_io(measure_io_samples(enc_cfg, device=device), model)
    return model
