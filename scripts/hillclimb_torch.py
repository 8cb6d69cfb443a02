"""Perf-iteration harness of the port: walk ONE (arch x shape) cell of the
dry run under a named variant and print its roofline terms and
collective breakdown.

    PYTHONPATH=src python scripts/hillclimb_torch.py --arch olmo-1b \\
        --shape train_4k --variant baseline|f32w|... \\
        [--mesh single|pod|multi] [--out DIR]

The port's counterpart of ``scripts/hillclimb.py``, over the port's dry
run (``repro_torch.launch.dryrun``) on one H100 (``single``), the
reference's 16x16 (``pod``) or its 2x16x16 (``multi``), the last two as
rank 0 of a ``fake`` world of 256 or 512 ranks: the variant is read by
the port through ``REPRO_TORCH_VARIANT`` (``f32w`` keeps f32 training
params; over a mesh ``plainkv`` keeps the plain cache, ``fsdp_tp`` and
``nosp`` as in the reference); the row is appended to
``<out>/hillclimb_<arch>_<shape>.jsonl`` (default
``results/dryrun_torch/``).
"""
import argparse
import json
import os
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--mesh", choices=["single", "pod", "multi"],
                    default="single")
    ap.add_argument("--out", default=str(ROOT / "results" / "dryrun_torch"))
    args = ap.parse_args(argv)

    # variant switches are read inside repro_torch via env
    os.environ["REPRO_TORCH_VARIANT"] = args.variant

    from repro_torch.launch.dryrun import MESHES, run_cell

    mesh_name, mesh = MESHES[args.mesh]
    row = run_cell(args.arch, args.shape, mesh, mesh_name)
    if row["status"] != "ok":
        print("ERROR:", row.get("error", row.get("reason")))
        print(row.get("traceback", "")[-2000:])
        return 1
    t = row["roofline"]
    print(f"VARIANT {args.variant}: dominant={t['dominant']}")
    print(f"  compute_s    = {t['compute_s']:.4e}")
    print(f"  memory_s     = {t['memory_s']:.4e}")
    print(f"  collective_s = {t['collective_s']:.4e}")
    print(f"  useful_ratio = {t['useful_ratio']:.3f}")
    print(f"  GB/dev       = {row['memory']['total_device_bytes'] / 1e9:.2f}"
          f"  fits={row['fits_hbm']}")
    c = row["collectives"]
    for k, v in sorted(c["bytes_by_kind"].items(), key=lambda kv: -kv[1]):
        print(f"  {k:20s} {v / 1e9:10.2f} GB/chip "
              f"(ops={c['count_by_kind'].get(k)})")
    out = json.dumps({"variant": args.variant, **{k: row[k] for k in
                     ("arch", "shape", "mesh", "roofline", "collectives",
                      "memory")}})
    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / f"hillclimb_{args.arch}_{args.shape}.jsonl",
              "a") as f:
        f.write(out + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
