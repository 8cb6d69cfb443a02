"""Full paper pipeline (Fig. 2) on the PyTorch/CUDA port: the flow of
``examples/video_analytics.py`` on ``repro_torch``.  The VideoStore engine
ingests a video on the device (the ``dct_quant`` and ``idct_dequant``
kernels), scans decode object regions (``decode_gop_blocks``), and the
VLM family's backbone (internvl2-26b, reduced as the reference's example
reduces it) scores crops of them (``flash_attention`` in every layer);
the background tuner then applies the layouts the regret policy learned
from those queries.

    PYTHONPATH=src python examples/video_analytics_torch.py
    PYTHONPATH=src python examples/video_analytics_torch.py --device cpu

``--device`` is ``cuda`` by default (the store's decode and encode, the
cost model's calibration and the model), and the script exits 1 without a
CUDA device.  ``build_store``, ``patch_embeds`` and ``score`` are the
pipeline's pieces, importable as they are (``chip_smoke.py`` drives them
with the full-width backbone).
"""
import argparse
import sys

import torch

from repro_torch.codec.encode import EncoderConfig
from repro_torch.configs.base import get_config, reduce_config
from repro_torch.core import DecodeConfig, RegretPolicy, VideoStore
from repro_torch.core.calibrate import calibrated_cost_model
from repro_torch.data.video_gen import generate, sparse_spec
from repro_torch.models import init_model, zoo
from repro_torch.train.data import tasm_region_batches

ENC = EncoderConfig(gop=16, qp=8)
LABELS = ["car", "person"]


def build_store(device) -> VideoStore:
    """The storage layer: a VideoStore on ``device`` with incremental
    tiling (the regret policy over a cost model calibrated there), holding
    ``cam0`` (``sparse_spec(seed=4, n_frames=96)``) and its detections."""
    frames, dets = generate(sparse_spec(seed=4, n_frames=96))
    cost = calibrated_cost_model(ENC, seeds=(0,), repeats=1, device=device)
    store = VideoStore(decode=DecodeConfig(device=str(device)))
    store.add_video("cam0", encoder=ENC, policy=RegretPolicy(),
                    cost_model=cost)
    store.ingest("cam0", frames)
    store.add_detections("cam0", {f: d for f, d in enumerate(dets)})
    return store


def patch_embeds(pixels: torch.Tensor, cfg) -> torch.Tensor:
    """The frontend stub: crops [B, crop, crop] -> patch embeddings
    [B, frontend_tokens, frontend_dim], the crop's pixels in order,
    zero-padded, over 255."""
    b = pixels.shape[0]
    need = cfg.frontend_tokens * cfg.frontend_dim
    pe = pixels.reshape(b, -1)[:, :need]
    pe = torch.nn.functional.pad(pe, (0, max(0, need - pe.shape[1])))
    return pe.reshape(b, cfg.frontend_tokens, cfg.frontend_dim) / 255.0


@torch.no_grad()
def score(model, cfg, pixels: torch.Tensor,
          tokens: torch.Tensor) -> torch.Tensor:
    """Crops and text tokens [B, T] -> the backbone's last-position logits
    [B, 1, V] (f32): the patch embeddings lead the sequence."""
    batch = {"patch_embeds": patch_embeds(pixels, cfg), "tokens": tokens}
    h = zoo.forward(model, cfg, batch, remat=False)
    return zoo.logits_fn(model, cfg, h[:, -1:])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; exits 1 without a CUDA device), "
                         "cuda:N, or cpu")
    args = ap.parse_args(argv)
    try:
        store = build_store(args.device)
    except RuntimeError as e:  # no CUDA device for --device cuda
        print(f"video_analytics_torch: {e}", file=sys.stderr)
        return 1

    # --- analytics model: internvl2-family backbone (reduced) ------------
    cfg = reduce_config(get_config("internvl2-26b"))
    model = init_model(cfg, 0, device=args.device)
    dev = model.device
    print(f"analytics backbone: {cfg.name} "
          f"({cfg.param_count() / 1e3:.0f}K params) on {dev}")

    # the engine streams decoded object crops; the frontend stub turns each
    # crop into patch embeddings for the backbone
    batches = tasm_region_batches(store, LABELS, batch=4, crop=16,
                                  video="cam0")
    for i in range(3):
        b = next(batches)
        pixels = torch.from_numpy(b["pixels"]).to(dev)
        tokens = torch.zeros((pixels.shape[0], 8), dtype=torch.long,
                             device=dev)
        logits = score(model, cfg, pixels, tokens)
        finite = bool(torch.isfinite(logits).all())
        print(f"batch {i}: crops {tuple(b['pixels'].shape)} labels "
              f"{b['labels']} -> logits {tuple(logits.shape)}, "
              f"finite={finite}")
        if not finite:
            return 1

    store.drain_tuner()  # let the background tuner apply pending re-tiles
    entry = store.video("cam0")
    print("layouts after analytics queries:",
          [r.layout.describe() for r in entry.store.sots])
    print("per-query history (decode ms / cache h:m):",
          [f"{s.decode_s * 1e3:.0f} {s.cache_hits}:{s.cache_misses}"
           for s in entry.history[-8:]])
    store.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
