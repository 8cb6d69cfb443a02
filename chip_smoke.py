#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--seed N]

From the root of a checkout, on a machine with a CUDA device and ``nvcc``:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the CUDA decode kernel from ``src/repro_torch/kernels/decode/csrc``;
3. kernel phase: holds the kernel against its plain PyTorch version on the
   card for F in {1, 4, 16}, M in {64, 4096, 32768}, qp in {4, 8, 12}
   (max |diff| <= 1e-3 on pixel-scale output) and times both, with the
   bound F*M*384 B over the card's published HBM rate;
4. path phase: ingests a 1080p, 64-frame synthetic video (gop 16, qp 8)
   under a 6x8 uniform layout (48 tiles; a full-frame SOT is one
   32,400-column dispatch) and runs a full-frame scan, a label (ROI) scan,
   ``execute_many`` of four overlapping scans and a ``serve()`` session of
   four requests through ``repro_torch.core.VideoStore`` on the card; every
   region is held against the numpy ``decode_tile`` oracle at atol=1e-3,
   rtol=1e-5, merged and served results must equal the serial ones bit for
   bit, and the kernel's launch counter must have grown;
5. prints one JSON line with the kernel's numbers, then as its last line
   ``{"ok": true, "device": {...}}``.

Any failed check raises, and the script exits non-zero without the last
line; so it does without a CUDA device, or outside a checkout.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 FLOP/s
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
#: per 8x8 block-frame: int16 in + f32 out; 64 pixels x (16 FMAs + dequant
#: multiply + running-sum add)
BYTES_PER_BLOCK_FRAME = 64 * 2 + 64 * 4
FLOPS_PER_BLOCK_FRAME = 64 * (2 * 16 + 2)
ATOL, RTOL = 1e-3, 1e-5
KERNEL_SOURCE = "src/repro_torch/kernels/decode/csrc/decode_gop_blocks.cu"
KERNEL_REPLACES = "src/repro/kernels/decode/decode.py:46"


def bound_ms(n_frames: int, m: int) -> tuple[float, str]:
    n = n_frames * m
    t_bytes = n * BYTES_PER_BLOCK_FRAME / HBM_BYTES_PER_S
    t_ops = n * FLOPS_PER_BLOCK_FRAME / FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def random_stream(rng, n_frames: int, m: int, qp: int) -> np.ndarray:
    """Coefficients with the statistics of encoded video: a keyframe row
    whose DC lands in [0, 255] pixels plus small AC terms, then sparse
    small residuals."""
    q = np.zeros((n_frames, m, 8, 8), dtype=np.int16)
    dc_max = int(255 * 8 / (16 * max(qp, 1) / 16.0))
    q[0, :, 0, 0] = rng.integers(0, dc_max + 1, size=m)
    q[0] += rng.integers(-3, 4, size=(m, 8, 8)).astype(np.int16)
    if n_frames > 1:
        resid = rng.integers(-2, 3, size=(n_frames - 1, m, 8, 8))
        resid[rng.random(resid.shape) < 0.7] = 0
        q[1:] = resid
    return q


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ------------------------------------------------------------------ phases
def kernel_phase(seed: int) -> dict:
    from repro_torch.kernels.decode import decode_fused_ref, decode_gop_blocks

    rng = np.random.default_rng(seed)
    worst = 0.0
    at_main = None
    for n_frames in (1, 4, 16):
        for m in (64, 4096, 32768):
            for qp in (4, 8, 12):
                q = torch.from_numpy(random_stream(rng, n_frames, m, qp))
                q = q.cuda()
                got = decode_gop_blocks(q, qp)
                want = decode_fused_ref(q, qp)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                check(err <= ATOL, f"kernel vs plain F={n_frames} M={m} "
                                   f"qp={qp}: max |diff| {err} > {ATOL}")
                worst = max(worst, err)
                if qp != 8:
                    continue
                k_ms = cuda_ms(lambda: decode_gop_blocks(q, qp), iters=50)
                r_ms = cuda_ms(lambda: decode_fused_ref(q, qp), iters=3,
                               warmup=1)
                b_ms, b_by = bound_ms(n_frames, m)
                print(f"kernel F={n_frames:2d} M={m:5d} qp={qp}: "
                      f"kernel_ms={k_ms:.6f} ref_ms={r_ms:.6f} "
                      f"bound_ms={b_ms:.6f} ({b_by}) "
                      f"share_of_bound={b_ms / k_ms:.3f} max_abs_err={err:.3g}",
                      flush=True)
                if (n_frames, m) == (16, 32768):
                    at_main = dict(ms=k_ms, plain_ms=r_ms, bound_ms=b_ms,
                                   bound_by=b_by)
                    host_in = torch.empty(q.shape, dtype=q.dtype,
                                          pin_memory=True)
                    host_out = torch.empty(got.shape, dtype=got.dtype,
                                           pin_memory=True)
                    h2d = cuda_ms(lambda: q.copy_(host_in, non_blocking=True),
                                  iters=10)
                    d2h = cuda_ms(lambda: host_out.copy_(got,
                                                         non_blocking=True),
                                  iters=10)
                    at_main.update(h2d_ms=h2d, d2h_ms=d2h)
                    print(f"copies F=16 M=32768 (pinned): h2d_ms={h2d:.6f} "
                          f"({q.numel() * 2} B) d2h_ms={d2h:.6f} "
                          f"({got.numel() * 4} B)", flush=True)
    at_main["max_abs_err"] = worst
    return at_main


def _oracle_frames(ts) -> np.ndarray:
    """Every frame of the store, decoded tile by tile by the numpy oracle."""
    from repro_torch.codec.encode import decode_tile

    last = ts.sots[-1]
    out = np.zeros((last.frame_end, last.layout.frame_height,
                    last.layout.frame_width), dtype=np.float32)
    for rec in ts.sots:
        for i, (y1, x1, y2, x2) in enumerate(rec.layout.tile_rects()):
            out[rec.frame_start:rec.frame_end, y1:y2, x1:x2] = \
                decode_tile(ts._read_tile(rec, i))
    return out


def _check_regions(regions, oracle, what: str) -> float:
    check(len(regions) > 0, f"{what}: no regions")
    worst = 0.0
    for frame, (y1, x1, y2, x2), px in regions:
        want = oracle[frame, y1:y2, x1:x2]
        check(px.dtype == np.float32 and px.shape == want.shape,
              f"{what}: region {frame} {(y1, x1, y2, x2)} is "
              f"{px.dtype}{px.shape}, want float32{want.shape}")
        np.testing.assert_allclose(px, want, atol=ATOL, rtol=RTOL,
                                   err_msg=f"{what} frame {frame}")
        worst = max(worst, float(np.abs(px - want).max(initial=0.0)))
    return worst


def _check_identical(a, b, what: str) -> None:
    check(len(a) == len(b), f"{what}: {len(a)} vs {len(b)} regions")
    for ra, rb in zip(a, b):
        check(ra[:-1] == rb[:-1] and np.array_equal(ra[-1], rb[-1]),
              f"{what}: region {ra[:-1]} differs")


def _device_split(store) -> dict:
    """Device time of one more full-frame scan, by kind, from the profiler
    (None where it recorded no device time)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        store.scan("v").labels("frame").frames(0, 64).execute()
        torch.cuda.synchronize()
    split = {"kernel_ms": 0.0, "h2d_ms": 0.0, "d2h_ms": 0.0}
    for evt in prof.key_averages():
        us = evt.device_time_total
        name = evt.key
        if "decode_gop_blocks" in name:
            split["kernel_ms"] += us / 1e3
        elif "HtoD" in name:
            split["h2d_ms"] += us / 1e3
        elif "DtoH" in name:
            split["d2h_ms"] += us / 1e3
    if split["kernel_ms"] == 0.0:
        return {k: None for k in split}
    return split


def path_phase(seed: int) -> dict:
    from repro_torch.codec.encode import EncoderConfig
    from repro_torch.core import CacheConfig, VideoStore, uniform_layout
    from repro_torch.data.video_gen import generate, sparse_spec
    from repro_torch.kernels.decode import LAUNCHES

    h, w, n = 1080, 1920, 64
    timings = {}
    t0 = time.perf_counter()
    frames, dets = generate(sparse_spec(seed=seed, height=h, width=w,
                                        n_frames=n))
    timings["generate_s"] = time.perf_counter() - t0
    # cache off: every scan decodes, so each phase drives the kernel and
    # the merged/served results are decoded anew, not read back
    store = VideoStore(cache=CacheConfig(budget_bytes=0))
    check(store.decode_backend == "batched"
          and store.decode_config.device.startswith("cuda"),
          f"store decodes with {store.decode_backend} on "
          f"{store.decode_config.device}")
    layout = uniform_layout(h, w, 6, 8)
    check(layout.n_tiles == 48, f"layout has {layout.n_tiles} tiles")
    t0 = time.perf_counter()
    store.ingest("v", frames, detections=dets,
                 encoder=EncoderConfig(gop=16, qp=8),
                 initial_layouts={s: layout for s in range(n // 16)})
    store.add_detections("v", {f: [("frame", (0, 0, h, w))]
                               for f in range(n)})
    timings["ingest_s"] = time.perf_counter() - t0
    del frames
    t0 = time.perf_counter()
    oracle = _oracle_frames(store.video("v").store)
    timings["oracle_s"] = time.perf_counter() - t0

    queries = [("car", (0, 64)), ("person", (8, 40)), ("car", (16, 48)),
               ("frame", (30, 34))]
    worst = 0.0
    per_phase = {}

    def timed(name, fn):
        before = LAUNCHES.count
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        per_phase[name] = dict(wall_s=time.perf_counter() - t,
                               launches=LAUNCHES.count - before)
        return out

    LAUNCHES.reset()
    full = timed("full_frame_scan", lambda: store.scan("v").labels("frame")
                 .frames(0, n).execute())
    roi = timed("label_scan", lambda: store.scan("v").labels("car")
                .frames(0, n).execute())
    serial = timed("serial_four", lambda: [
        store.scan("v").labels(l).frames(*f).execute() for l, f in queries])
    merged = timed("execute_many_four", lambda: store.execute_many(
        [store.scan("v").labels(l).frames(*f) for l, f in queries]))

    def serve():
        with store.serve() as session:
            futs = [session.submit(store.scan("v").labels(l).frames(*f))
                    for l, f in queries]
            return [f.result(timeout=300) for f in futs]

    served = timed("serve_four", serve)
    launches = LAUNCHES.count

    check(len(full.regions) == n, f"full-frame scan: {len(full.regions)} "
                                  f"regions, want {n}")
    check(per_phase["full_frame_scan"]["launches"] == n // 16,
          f"full-frame scan launched {per_phase['full_frame_scan']} times, "
          f"want one per SOT ({n // 16})")
    worst = max(worst, _check_regions(full.regions, oracle, "full-frame"))
    worst = max(worst, _check_regions(roi.regions, oracle, "label scan"))
    for (lbl, fr), s, m, v in zip(queries, serial, merged, served):
        worst = max(worst, _check_regions(s.regions, oracle,
                                          f"serial {lbl}{fr}"))
        _check_identical(s.regions, m.regions, f"execute_many {lbl}{fr}")
        _check_identical(s.regions, v.regions, f"serve {lbl}{fr}")
    check(launches > 0, "the scan path never launched the kernel")
    for name, p in per_phase.items():
        check(p["launches"] > 0, f"{name} never launched the kernel")
        print(f"path {name}: wall_s={p['wall_s']:.6f} "
              f"launches={p['launches']}", flush=True)
    split = _device_split(store)
    store.close()
    print("path full-frame scan device time (torch.profiler): " +
          " ".join(f"{k}={'not measured' if v is None else f'{v:.6f}'}"
                   for k, v in split.items()), flush=True)
    print("path setup: " + " ".join(f"{k}={v:.3f}"
                                     for k, v in timings.items()),
          f"regions_checked max_abs_err={worst:.3g}", flush=True)
    return dict(launches=launches, max_abs_err=worst)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from repro_torch.kernels.decode import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    build.build()
    print(f"build_s={time.perf_counter() - t0:.3f}", flush=True)

    k = kernel_phase(args.seed)
    p = path_phase(args.seed)
    print(json.dumps({"kernels": [{
        "name": "decode_gop_blocks", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
        "launches": p["launches"],
        "max_abs_err": k["max_abs_err"],
        "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"], "library_ms": None}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
