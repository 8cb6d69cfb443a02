"""The paper's analytics loop (Fig. 2): scan object regions out of stored
video with the program's ``VideoStore``, crop them, and score the crops
with the program's VLM prefill.

Configuration (the model keys, and the deployment): ``video_seed``,
``video_height``, ``video_width``, ``video_frames``, ``gop``, ``qp``,
``tile_cache_bytes``.  The stored video is the deployment's, the same for
every run; ``--seed`` orders the queries and draws their text and the
weights.
Mix parameters: ``labels``, ``window_frames``, ``start_step`` (the window's
first frames are every ``start_step``-th frame, each label with each start
once a cycle, the cycle shuffled by the seed), ``warm_cycles_max``,
``warm_quiet_cycles``,
``crops_per_query``, ``crop``, ``text_tokens``, ``check_queries`` and
``check_from`` (the compared queries, drawn from the seed among the first
``check_from``; the window lasts ``--seconds`` and until they are
answered).

Closed loop, one analyst: each query scans its label over its window,
takes the first ``crops_per_query`` regions at least 8 pixels a side as
crops, and waits for their last-position logits.  Set-up ingests the video
(RegretPolicy over the default CostModel, the store under ``TMPDIR``),
draws the weights, and scans whole cycles of the mix in one fixed order,
the same for every seed, draining the background tuner after each scan, so
that each observation is replayed alone and the retiles land alike in
every run; it stops after ``warm_quiet_cycles`` cycles in a row that
retile nothing (at most ``warm_cycles_max`` cycles; RegretPolicy can
retile again after one quiet cycle), and scores one batch.  The window keeps the tuner
live: whatever it retiles there is part of the cell, and counted
(``retile_s``, the store's re-encode seconds in the window).
"""
from __future__ import annotations

import shutil
import tempfile
import warnings

import numpy as np
import torch

from frozen import flops
from frozen.crops import crop_regions, patch_embeds
from frozen.video_gen import generate, sparse_spec
from harness import RunOutput
from loops import common
from modelspec import model_spec
from reference import codec, lm
from devtrace import DeviceTrace, Spans, by_kind

PX_TOL = 0.01   # a scanned pixel further than this from the reference is off


def cycle(mix: dict, config: dict) -> list:
    """One cycle of the mix: every label at every window start."""
    starts = range(0, config["video_frames"] - mix["window_frames"] + 1,
                   mix["start_step"])
    return [(lbl, f0) for lbl in mix["labels"] for f0 in starts]


def queries(mix: dict, config: dict, vocab: int, seed: int):
    """Endless (label, first frame, text tokens) of the mix, a shuffled
    cycle at a time."""
    rng = common.rng(seed, 1)
    pairs = cycle(mix, config)
    while True:
        for i in rng.permutation(len(pairs)):
            lbl, f0 = pairs[i]
            yield lbl, f0, rng.integers(0, vocab, mix["text_tokens"])


def _check_scan(q: dict, dets, frames, config: dict, control: bool):
    """(boxes wrong, pixels off, pixels) of one query's regions."""
    lo, hi = q["f0"], q["f0"] + q["window"]
    want = {(f, tuple(int(v) for v in b)) for f in range(lo, hi)
            for lbl, b in dets[f] if lbl == q["label"]}
    got = [(f, tuple(int(v) for v in b)) for f, b, _ in q["regions"]]
    wrong = len(want ^ set(got)) + (len(got) - len(set(got)))
    ref = codec.decode_boxes(frames, got, gop=config["gop"],
                             qp=config["qp"])
    cand = ([r[2] for r in q["regions"]] if not control else
            codec.decode_boxes(frames, got, gop=config["gop"],
                               qp=config["qp"], control=True))
    off = sum(int((np.abs(c - r) > PX_TOL).sum())
              for c, r in zip(cand, ref))
    return wrong, off, sum(r.size for r in ref)


def _logit_err(cand: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest error of any logit, over the reference's spread across
    the vocabulary, of any row."""
    cand, ref = cand.float().flatten(1), ref.float().flatten(1)
    return float(((cand - ref).abs().amax(1) / ref.std(1)).max())


def run(cell, *, seed: int, seconds: float, trace: bool, device: str,
        t_start: float, control: bool = False) -> RunOutput:
    from repro_torch.codec.encode import EncoderConfig
    from repro_torch.core import (CacheConfig, DecodeConfig, RegretPolicy,
                                  TuningConfig, VideoStore)
    from repro_torch.core.cost import CostModel
    from repro_torch.serve import make_prefill_step

    import sut

    config, mix = cell.config, cell.traffic
    spec = model_spec(config)
    n_img, n_text = spec.frontend_tokens, mix["text_tokens"]
    seq = n_img + n_text
    per_query = mix["crops_per_query"]
    marks = [("start", common.now())]
    frames, dets = generate(sparse_spec(
        config["video_seed"], n_frames=config["video_frames"],
        height=config["video_height"], width=config["video_width"]))
    frames.setflags(write=False)         # the reference reads them after
    warnings.filterwarnings("ignore", message="The given NumPy array is not "
                            "writable")
    root = tempfile.mkdtemp(prefix="bench_store_")
    store = None
    try:
        common.reset_peak(device)
        store = VideoStore(
            root, decode=DecodeConfig(device=device),
            cache=CacheConfig(budget_bytes=config["tile_cache_bytes"]),
            tuning=TuningConfig(mode="background"))
        store.ingest("cam0", frames, detections=dets,
                     encoder=EncoderConfig(gop=config["gop"],
                                           qp=config["qp"]),
                     policy=RegretPolicy(), cost_model=CostModel())
        common.sync(device)
        marks.append(("ingest", common.now()))
        weights = lm.Weights(spec, seed, device)
        pcfg = sut.program_config(config)
        model = sut.build_model(pcfg, weights)
        prefill = make_prefill_step(pcfg, seq, device=device)
        common.sync(device)
        marks.append(("weights", common.now()))

        def score(pixels: np.ndarray, text: np.ndarray):
            px = torch.from_numpy(pixels).to(device)
            pe = patch_embeds(px, n_img, spec.frontend_dim)
            tok = torch.from_numpy(np.tile(text, (len(pixels), 1))).to(device)
            logits, _ = prefill(model, {"patch_embeds": pe, "tokens": tok})
            return logits

        def scan(label: str, f0: int):
            return (store.scan("cam0").labels(label)
                    .frames(f0, f0 + mix["window_frames"]).execute())

        warm, quiet = cycle(mix, config), 0
        for _ in range(mix["warm_cycles_max"]):
            applied = store.tuner_stats().applied
            for lbl, f0 in warm:
                res = scan(lbl, f0)
                store.drain_tuner()
            quiet = quiet + 1 if store.tuner_stats().applied == applied \
                else 0
            if quiet == mix["warm_quiet_cycles"]:
                break
        marks.append(("warm_scans", common.now()))
        pixels, _ = crop_regions(res.regions, count=per_query,
                                 crop=mix["crop"])
        score(pixels, np.zeros(n_text, dtype=np.int64))
        common.sync(device)
        marks.append(("warm_score", common.now()))
        tuned = store.tuner_stats()
        common.log(f"warm: retiles={tuned.applied} retile_s="
                   f"{tuned.retile_s:.3f}")

        pick = common.rng(seed, 2).choice(mix["check_from"],
                                          mix["check_queries"], replace=False)
        spans, dev_trace = Spans(), DeviceTrace(trace)
        gen = queries(mix, config, spec.vocab, seed)
        kept, crops, pixels_decoded, attempted, failed = [], 0, 0.0, 0, 0
        batches: dict = {}
        before = sut.launch_counts()
        dev_trace.start()
        t0 = common.now()
        setup_s = t0 - t_start
        while True:
            label, f0, text = next(gen)
            attempted += 1
            a = common.now()
            res = scan(label, f0)
            b = common.now()
            pixels, _ = crop_regions(res.regions, count=per_query,
                                     crop=mix["crop"])
            if len(pixels) < per_query:
                failed += 1
            logits = score(pixels, text)
            common.sync(device)
            c = common.now()
            spans.add("scan", a, b)
            spans.add("model", b, c)
            crops += len(pixels)
            batches[len(pixels)] = batches.get(len(pixels), 0) + 1
            pixels_decoded += res.stats.pixels_decoded
            if attempted - 1 in pick:
                kept.append(dict(label=label, f0=f0,
                                 window=mix["window_frames"],
                                 regions=res.regions, pixels=pixels,
                                 text=text, logits=logits.clone()))
            if c - t0 >= seconds and attempted > max(pick):
                break
        window_s = c - t0
        dev_trace.stop()
        window_tuned = store.tuner_stats()
        common.log("setup: " + " ".join(
            f"{n}_s={t - p:.3f}" for (_, p), (n, t) in zip(marks, marks[1:]))
            + f" imports_s={marks[0][1] - t_start:.3f}")
        common.log(f"window: queries={attempted} crops={crops} "
                   f"scan_s={spans.total('scan'):.3f} "
                   f"model_s={spans.total('model'):.3f} retiles="
                   f"{window_tuned.applied - tuned.applied} retile_s="
                   f"{window_tuned.retile_s - tuned.retile_s:.3f}")
        launches = {k: v - before[k]
                    for k, v in sut.launch_counts().items()}
        peak = common.memory_peak(device)
        del model, prefill, logits
        store.close()
        store = None
        common.free(device)
        trace_out = dev_trace.reduce(spans)
        if trace_out is not None:
            common.log("device: " + " ".join(
                f"{k}_s={v:.4f}" for k, v in
                by_kind(trace_out["kernel_s"]).items()))

        # ---- the comparison, after the window
        t_cmp = common.now()
        common.plain_f32()
        wrong = off = total = 0
        ctl_off = 0
        logit_err = ctl_err = 0.0
        for q in kept:
            w, o, n = _check_scan(q, dets, frames, config, False)
            wrong, off, total = wrong + w, off + o, total + n
            if control:
                ctl_off += _check_scan(q, dets, frames, config, True)[1]
            pe = patch_embeds(torch.from_numpy(q["pixels"]).to(device),
                              n_img, spec.frontend_dim)
            tok = torch.from_numpy(np.tile(q["text"], (len(q["pixels"]), 1))
                                   ).to(device)
            ref = lm.forward(spec, weights, tok, logit_positions=[seq - 1],
                             patch_embeds=pe)
            logit_err = max(logit_err, _logit_err(q["logits"], ref))
            if control:
                ctl_err = max(ctl_err, _logit_err(lm.forward(
                    spec, weights, tok, logit_positions=[seq - 1],
                    patch_embeds=pe, quant="fp8"), ref))
        numbers = {"scan_boxes_wrong": float(wrong) if kept else None,
                   "scan_px_off": off / total if total else None,
                   "logit_err": logit_err if kept else None}
        compare_s = common.now() - t_cmp
        common.log(f"compare: queries={len(kept)} crops="
                   f"{sum(len(q['pixels']) for q in kept)} "
                   f"compare_s={compare_s:.3f}")
        control_numbers = {}
        if control and total:
            control_numbers = {"scan_boxes_wrong": 0.0,
                               "scan_px_off": ctl_off / total,
                               "logit_err": ctl_err}
    finally:
        if store is not None:
            store.close()
        shutil.rmtree(root, ignore_errors=True)

    useful = sum(count * flops.model_flops(spec, [seq] * b,
                                           image_tokens=n_img)
                 for b, count in batches.items())
    calls = {(b, spec.n_heads, spec.attn_kv_heads, seq, spec.qk_dim,
              spec.v_dim): count * spec.n_layers
             for b, count in batches.items()}
    ctx = {"window_s": window_s, "spans": {"scan": spans.total("scan"),
                                           "model": spans.total("model")},
           "counters": {"crops": crops, "queries": attempted,
                        "pixels_decoded": pixels_decoded,
                        "retile_s": window_tuned.retile_s - tuned.retile_s},
           "useful_flops": useful, "attention_calls": calls,
           "launches": launches}
    e2e = {"setup_s": setup_s, "crops_per_s": crops / window_s}
    return RunOutput(attempted=attempted, failed=failed, end_to_end=e2e,
                     ctx=ctx, numbers=numbers, memory_peak_bytes=peak,
                     trace=trace_out, control=control_numbers)
