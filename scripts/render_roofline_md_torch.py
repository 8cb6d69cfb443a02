"""Render the port's roofline / dry-run tables (markdown) from its dry-run
rows.

    PYTHONPATH=src python scripts/render_roofline_md_torch.py \\
        [all|table|delta|mfu] [--dir results/dryrun_torch]

The port's counterpart of ``scripts/render_roofline_md.py``, over the
rows ``python -m repro_torch.launch.dryrun`` writes for one H100
(``1xh100.jsonl``) and, where they were walked, for the reference's
16x16 (``--mesh pod``: ``16_16.jsonl``) and 2x16x16 (``--mesh multi``:
``2_16_16.jsonl``); the delta tables compare ``<rows>_baseline.jsonl``,
where a baseline run was saved under that name, with them.
"""
import argparse
import json
import pathlib

RES = pathlib.Path("results/dryrun_torch")
#: (title, rows file) of each mesh's table
TABLES = (("One H100 (1xh100)", "1xh100.jsonl"),
          ("Single-pod 16x16", "16_16.jsonl"),
          ("Multi-pod 2x16x16", "2_16_16.jsonl"))


def baseline_of(rows_file: str) -> str:
    return rows_file.replace(".jsonl", "_baseline.jsonl")


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
    d = pathlib.Path(args.dir)
    # one H100's tables always; a mesh's where its rows were walked
    shown = [(title, name, load(d / name)) for i, (title, name) in
             enumerate(TABLES) if i == 0 or (d / name).exists()]
    for title, name, rows in shown:
        if args.which in ("all", "table"):
            print(f"### {title}\n")
            print(roofline_table(rows) + "\n")
        if args.which in ("all", "delta"):
            base = load(d / baseline_of(name))
            print(f"### Baseline -> now, dominant term per cell ({title})"
                  f"\n")
            print((delta_table(base, rows) if base else
                   f"(no {baseline_of(name)} in {args.dir})") + "\n")
        if args.which in ("all", "mfu"):
            print(f"### Projected roofline fractions ({title})\n")
            print(mfu_summary(rows) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
