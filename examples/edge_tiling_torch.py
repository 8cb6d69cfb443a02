"""Edge tiling on the PyTorch/CUDA port: the flow of
``examples/edge_tiling.py`` on ``repro_torch`` (paper §4.3).  The camera
detects objects as frames are captured — full YOLO every k frames (an edge
GPU can't run every frame) — and the video arrives at the VDBMS already
tiled around O_Q, with the semantic index pre-initialized.  Compare
against bgsub- and tiny-detector edge configurations (§5.2.4).  Each
configuration is one video in a single VideoStore catalog, so one engine
serves them all.

    PYTHONPATH=src python examples/edge_tiling_torch.py
    PYTHONPATH=src python examples/edge_tiling_torch.py --device cpu

``--device`` is ``cuda`` by default (the store's decode and encode, and
the cost model's calibration): each edge layout's ingest encodes with the
``dct_quant`` and ``idct_dequant`` kernels, the scans decode with
``decode_gop_blocks``.  The script exits 1 without a CUDA device, and
exits 1 if a detector's layouts were not applied at ingest.  :func:`run`
is the whole flow, importable as it is; it returns the contracts by name.
"""
import argparse
import sys

from repro_torch.codec.encode import EncoderConfig
from repro_torch.core import (CacheConfig, DecodeConfig, NoTilingPolicy,
                              VideoStore)
from repro_torch.core.calibrate import calibrated_cost_model
from repro_torch.core.detector import DetectorConfig, detect
from repro_torch.core.layout import partition
from repro_torch.data.video_gen import generate, sparse_spec

ENC = EncoderConfig(gop=16, qp=8)
O_Q = ["car"]  # the VDBMS tells the camera which objects queries target


def run(device: str = "cuda") -> dict:
    """The edge configurations in one store on ``device``; returns the
    contracts (each should be True) by name."""
    frames, gt = generate(sparse_spec(seed=2, n_frames=128))
    H, W = frames.shape[1:]
    model = calibrated_cost_model(ENC, seeds=(0,), repeats=1, device=device)

    # cache off: this example compares repeat-decode cost across edge
    # layouts
    store = VideoStore(default_encoder=ENC, default_cost_model=model,
                       default_policy=NoTilingPolicy(),
                       cache=CacheConfig(budget_bytes=0),
                       decode=DecodeConfig(device=device))
    ok = {}

    def edge_ingest(det_cfg: DetectorConfig, name: str):
        found, det_secs = detect(frames, gt, det_cfg)
        # the camera designs PARTITION(v, O_Q) layouts per GOP at capture
        # time
        layouts = {}
        for g in range(len(frames) // ENC.gop):
            boxes = [b for f in range(g * ENC.gop, (g + 1) * ENC.gop)
                     for l, b in found.get(f, [])
                     if l in O_Q or l == "object"]
            if boxes:
                layouts[g] = partition(H, W, boxes)
        store.add_video(name)
        store.add_detections(name, found)   # pre-initialized semantic index
        store.ingest(name, frames, initial_layouts=layouts)
        # ground truth boxes are what queries ultimately retrieve
        store.add_detections(name, {f: d for f, d in enumerate(gt)})
        applied = all(store.video(name).store.sots[g].layout == lay
                      for g, lay in layouts.items())
        secs = 0.0
        for _ in range(6):
            st = store.scan(name).labels("car").frames(0, 64).execute() \
                      .stats
            secs += st.decode_s + st.lookup_s
        return det_secs, secs, layouts, applied

    # baseline: cloud ingest, no tiles — just another catalog entry
    store.add_video("untiled")
    store.ingest("untiled", frames)
    store.add_detections("untiled", {f: d for f, d in enumerate(gt)})
    base_q = store.scan("untiled").labels("car").frames(0, 64)
    base_secs = sum((base_q.execute().stats.decode_s
                     + base_q.execute().stats.lookup_s) for _ in range(3))

    print(f"{'edge detector':28s} {'on-camera s':>12s} "
          f"{'6-query decode s':>17s}")
    for name, cfg in [
        ("full YOLO every frame", DetectorConfig(kind="full")),
        ("full YOLO every 5 frames", DetectorConfig(kind="strided",
                                                    stride=5)),
        ("tiny YOLO (misses ~50%)", DetectorConfig(kind="tiny")),
        ("background subtraction", DetectorConfig(kind="bgsub")),
    ]:
        det_secs, q_secs, layouts, applied = edge_ingest(
            cfg, name.replace(" ", "_"))
        ok[f"layouts_applied[{name}]"] = applied and bool(layouts)
        print(f"{name:28s} {det_secs:12.2f} {q_secs:17.3f}   "
              f"({len(layouts)} GOPs pre-tiled)")
    print(f"{'(untiled cloud ingest)':28s} {'-':>12s} {base_secs * 2:17.3f}")
    print(f"\ncatalog now holds {len(store)} videos: {store.videos()}")
    plan = store.scan(store.videos()).labels("car").frames(0, 16).explain()
    print(f"one cross-video plan touches {len(plan.sot_scans)} SOTs, "
          f"est {plan.est_cost_s * 1e3:.1f} ms")
    ok["catalog_holds_five"] = len(store) == 5
    store.close()
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; exits 1 without a CUDA device), "
                         "cuda:N, or cpu")
    args = ap.parse_args(argv)
    try:
        DecodeConfig(device=args.device).resolve()
    except RuntimeError as e:  # no CUDA device for --device cuda
        print(f"edge_tiling_torch: {e}", file=sys.stderr)
        return 1
    ok = run(args.device)
    failed = sorted(k for k, v in ok.items() if not v)
    print(f"\ncontracts: {len(ok) - len(failed)} of {len(ok)} hold"
          + (f"; failed: {failed}" if failed else ""))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
