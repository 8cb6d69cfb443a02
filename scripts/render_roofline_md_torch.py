"""Render the port's roofline / dry-run tables (markdown) from its dry-run
rows.

    PYTHONPATH=src python scripts/render_roofline_md_torch.py \\
        [all|table|delta|mfu] [--dir results/dryrun_torch]

The port's counterpart of ``scripts/render_roofline_md.py``, over the
rows ``python -m repro_torch.launch.dryrun`` writes for one H100
(``1xh100.jsonl``); the delta table compares ``1xh100_baseline.jsonl``,
where a baseline run was saved under that name, with them.
"""
import argparse
import json
import pathlib

RES = pathlib.Path("results/dryrun_torch")
ROWS = "1xh100.jsonl"
BASELINE = "1xh100_baseline.jsonl"


def load(path: pathlib.Path) -> dict:
    rows = {}
    if not path.exists():
        return rows
    for line in path.read_text().splitlines():
        try:
            r = json.loads(line)
            rows[(r["arch"], r["shape"])] = r
        except json.JSONDecodeError:
            pass
    return rows


def fmt(x):
    return f"{x:.2e}"


def roofline_table(rows):
    out = ["| arch | shape | dominant | compute_s | memory_s | collective_s | "
           "useful | GB/dev | fits |",
           "|---|---|---|---|---|---|---|---|---|"]
    for (a, s), r in sorted(rows.items()):
        if r["status"] == "skipped":
            out.append(f"| {a} | {s} | — | — | — | — | — | — | skipped "
                       f"(full attention @500k) |")
            continue
        if r["status"] != "ok":
            out.append(f"| {a} | {s} | error | — | — | — | — | — | — |")
            continue
        t = r["roofline"]
        gb = r["memory"]["total_device_bytes"] / 1e9
        out.append(
            f"| {a} | {s} | {t['dominant']} | {fmt(t['compute_s'])} | "
            f"{fmt(t['memory_s'])} | {fmt(t['collective_s'])} | "
            f"{t['useful_ratio']:.2f} | {gb:.1f} | {r.get('fits_hbm')} |")
    return "\n".join(out)


def delta_table(base, opt):
    out = ["| arch | shape | dominant (base→opt) | dominant-term s "
           "(base→opt) | Δ |", "|---|---|---|---|---|"]
    for key in sorted(base):
        b, o = base[key], opt.get(key)
        if b["status"] != "ok" or not o or o["status"] != "ok":
            continue
        tb, to = b["roofline"], o["roofline"]
        db = max(tb["compute_s"], tb["memory_s"], tb["collective_s"])
        do = max(to["compute_s"], to["memory_s"], to["collective_s"])
        delta = (db - do) / db * 100
        out.append(f"| {key[0]} | {key[1]} | {tb['dominant']}→"
                   f"{to['dominant']} | {fmt(db)}→{fmt(do)} | {delta:+.0f}% |")
    return "\n".join(out)


def mfu_summary(rows):
    """Projected roofline fraction = useful compute / dominant term."""
    out = ["| arch | shape | projected roofline fraction |", "|---|---|---|"]
    for (a, s), r in sorted(rows.items()):
        if r["status"] != "ok":
            continue
        t = r["roofline"]
        dom = max(t["compute_s"], t["memory_s"], t["collective_s"])
        frac = t["useful_ratio"] * t["compute_s"] / dom if dom else 0
        out.append(f"| {a} | {s} | {frac:.3f} |")
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("which", nargs="?", default="all",
                    choices=["all", "table", "delta", "mfu"])
    ap.add_argument("--dir", default=str(RES))
    args = ap.parse_args(argv)
    rows = load(pathlib.Path(args.dir) / ROWS)
    if args.which in ("all", "table"):
        print("### One H100 (1xh100)\n")
        print(roofline_table(rows))
    if args.which in ("all", "delta"):
        base = load(pathlib.Path(args.dir) / BASELINE)
        print("\n### Baseline -> now, dominant term per cell\n")
        print(delta_table(base, rows) if base else
              f"(no {BASELINE} in {args.dir})")
    if args.which in ("all", "mfu"):
        print("\n### Projected roofline fractions (one H100)\n")
        print(mfu_summary(rows))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
