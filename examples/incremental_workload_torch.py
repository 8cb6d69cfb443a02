"""Tiling strategies over a shifting query workload on the PyTorch/CUDA
port: the flow of ``examples/incremental_workload.py`` on ``repro_torch``
(paper §5.3 W4: queries move car -> person -> car).  It prints the
cumulative cost table, then demos the background physical tuner: the same
regret-tuned workload with re-tiling moved off the scan path
(``tuning="background"`` + ``drain_tuner()``), converging to the same
layouts with no query ever charged re-encode time.

    PYTHONPATH=src python examples/incremental_workload_torch.py
    PYTHONPATH=src python examples/incremental_workload_torch.py --device cpu

``--device`` is ``cuda`` by default (every store's decode and encode, and
the cost model's calibration): the policies' retiles encode with the
``dct_quant`` and ``idct_dequant`` kernels, the scans decode with
``decode_gop_blocks``.  The script exits 1 without a CUDA device, and
exits 1 if the background tuner charged a query or did not converge to
the inline layouts.  :func:`run` is the whole flow, importable as it is;
it returns the contracts by name.
"""
import argparse
import sys

import numpy as np

from repro_torch.codec.encode import EncoderConfig
from repro_torch.core import (CacheConfig, DecodeConfig, MorePolicy,
                              NoTilingPolicy, PretileAllPolicy, RegretPolicy,
                              TuningConfig, VideoStore)
from repro_torch.core.calibrate import calibrated_cost_model
from repro_torch.data.video_gen import generate, sparse_spec

ENC = EncoderConfig(gop=16, qp=8)
N_FRAMES, N_QUERIES, WINDOW = 256, 60, 32


def run(device: str = "cuda") -> dict:
    """The workload with every store on ``device``; returns its contracts
    (each should be True) by name."""
    frames, dets = generate(sparse_spec(seed=1, n_frames=N_FRAMES))
    model = calibrated_cost_model(ENC, seeds=(0,), repeats=1, device=device)

    rng = np.random.default_rng(0)
    starts = rng.integers(0, N_FRAMES - WINDOW, N_QUERIES)
    labels = (["car"] * (N_QUERIES // 3) + ["person"] * (N_QUERIES // 3)
              + ["car"] * (N_QUERIES - 2 * (N_QUERIES // 3)))
    queries = list(zip(labels, [(int(s), int(s) + WINDOW) for s in starts]))

    def make_store(policy_cls, tuning):
        # cache off + ROI decode off: this example compares full-tile
        # decode cost across tiling policies (ROI-restricted decode would
        # flatten it)
        store = VideoStore(cache=CacheConfig(budget_bytes=0),
                           tuning=TuningConfig(mode=tuning),
                           decode=DecodeConfig(roi=False, device=device))
        store.add_video("v", encoder=ENC, policy=policy_cls(),
                        cost_model=model)
        store.add_detections("v", {f: d for f, d in enumerate(dets)})
        return store

    results = {}
    for name, policy_cls in [("not_tiled", NoTilingPolicy),
                             ("all_objects", PretileAllPolicy),
                             ("incremental_more", MorePolicy),
                             ("incremental_regret", RegretPolicy)]:
        # inline tuning: this table charges re-tiling to the triggering
        # query (the paper's cumulative-cost accounting)
        store = make_store(policy_cls, "inline")
        pre = store.ingest("v", frames).pretile_s
        cum = pre if name == "all_objects" else 0.0
        series = []
        for label, t_range in queries:
            st = store.scan("v").labels(label).frames(*t_range) \
                      .execute().stats
            cum += st.decode_s + st.lookup_s + st.retile_s
            series.append(cum)
        results[name] = np.array(series)
        layouts = [r.layout.describe()
                   for r in store.video("v").store.sots[:6]]
        print(f"{name:20s} final cumulative = {cum:6.2f}s  layouts: "
              f"{layouts}...")
        if name != "incremental_regret":
            store.close()

    base = results["not_tiled"]
    print("\ncumulative cost normalized to not_tiled (paper Fig. 11d):")
    for name, series in results.items():
        pts = [f"{100 * series[i] / base[i]:5.0f}%" for i in
               (9, N_QUERIES // 2, N_QUERIES - 1)]
        print(f"  {name:20s} @q10/q{N_QUERIES // 2}/q{N_QUERIES}: "
              f"{' '.join(pts)}")

    # --- background tuning: the same regret workload, re-tiling off the
    # scan path.  Queries only *observe*; the tuner thread replays the
    # workload log, coalesces proposals, and applies retiles through the
    # durable epoch-bumping path.  drain_tuner() after each query is the
    # deterministic barrier that keeps the tuning cadence identical to
    # inline — so the layouts converge identically while
    # ScanStats.retile_s stays 0 for every query.
    print("\nbackground tuner (tuning='background', RegretPolicy):")
    bg = make_store(RegretPolicy, "background")
    bg.ingest("v", frames)
    worst_ms, charged = 0.0, 0
    for label, t_range in queries:
        st = bg.scan("v").labels(label).frames(*t_range).execute().stats
        worst_ms = max(worst_ms,
                       1e3 * (st.decode_s + st.lookup_s + st.retile_s))
        charged += st.retile_s > 0
        bg.drain_tuner()          # barrier, OUTSIDE the query's critical path
    ts = bg.tuner_stats()
    print(f"  queries charged retile time: {charged}/{N_QUERIES} "
          f"(worst query {worst_ms:.0f} ms pays decode+lookup only)")
    print(f"  tuner: {ts.observed} observations -> {ts.proposals} proposals, "
          f"{ts.coalesced} coalesced, {ts.applied} applied "
          f"({ts.retile_s:.2f}s re-encode off the scan path)")
    inline_layouts = [r.layout.describe()
                      for r in store.video("v").store.sots]
    bg_layouts = [r.layout.describe() for r in bg.video("v").store.sots]
    same = bg_layouts == inline_layouts
    print(f"  converged to the same layouts as inline: {same}")
    bg.close()
    store.close()
    return {"no_query_charged_retile": charged == 0,
            "same_layouts_as_inline": same, "retiled": ts.applied > 0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; exits 1 without a CUDA device), "
                         "cuda:N, or cpu")
    args = ap.parse_args(argv)
    try:
        DecodeConfig(device=args.device).resolve()
    except RuntimeError as e:  # no CUDA device for --device cuda
        print(f"incremental_workload_torch: {e}", file=sys.stderr)
        return 1
    ok = run(args.device)
    failed = sorted(k for k, v in ok.items() if not v)
    print(f"\ncontracts: {len(ok) - len(failed)} of {len(ok)} hold"
          + (f"; failed: {failed}" if failed else ""))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
