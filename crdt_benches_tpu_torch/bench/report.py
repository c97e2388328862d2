"""HTML report of saved bench results (the JAX package's
``bench/report.py``): Criterion's per-bench report, as one self-contained
HTML file with a summary table per group and an inline-SVG strip of every
sample per cell (median marked); no plotting dependency.

Reads result files of both packages (the list of records that
``bench/harness.py save_results`` writes): the port's
``bench_results/torch_*.json`` and the JAX package's files alike.

    python -m crdt_benches_tpu_torch.bench.report [results.json ...] \
        [-o bench_results/torch_report.html]

With no inputs, every ``bench_results/*.json`` is read.
"""

from __future__ import annotations

import argparse
import glob
import html
import json
import os

#: ``bench_results/`` at the repository root.
RESULTS_DIR = os.path.normpath(
    os.path.join(os.path.dirname(__file__), "..", "..", "bench_results")
)


def _fmt(n: float) -> str:
    if n >= 1e6:
        return f"{n/1e6:,.1f}M"
    if n >= 1e3:
        return f"{n/1e3:,.0f}k"
    return f"{n:,.0f}"


def _strip_svg(times: list[float], width: int = 220, h: int = 26) -> str:
    """Sample-distribution strip: one tick per sample on a linear time
    axis spanning [min, max], median in a second color."""
    if not times:
        return ""
    lo, hi = min(times), max(times)
    span = (hi - lo) or 1e-12
    x = lambda t: 6 + (width - 12) * (t - lo) / span
    med = sorted(times)[len(times) // 2]
    ticks = "".join(
        f'<line x1="{x(t):.1f}" y1="4" x2="{x(t):.1f}" y2="{h-10}" '
        f'stroke="#4878d0" stroke-width="1.5"/>'
        for t in times
    )
    return (
        f'<svg width="{width}" height="{h}" role="img">'
        f'<line x1="6" y1="{h-8}" x2="{width-6}" y2="{h-8}" '
        f'stroke="#999" stroke-width="1"/>'
        f"{ticks}"
        f'<line x1="{x(med):.1f}" y1="2" x2="{x(med):.1f}" y2="{h-8}" '
        f'stroke="#d65f5f" stroke-width="2.5"/>'
        f"</svg>"
    )


def load_results(paths: list[str]) -> list[dict]:
    rows = []
    for p in paths:
        try:
            with open(p) as fh:
                data = json.load(fh)
        except (OSError, json.JSONDecodeError):
            continue
        # save_results writes a flat list of cell records
        cells = data if isinstance(data, list) else data.get("results", [])
        for r in cells:
            if not isinstance(r, dict) or "group" not in r:
                continue
            r = dict(r)
            r["_source"] = os.path.basename(p)
            rows.append(r)
    return rows


def render(rows: list[dict]) -> str:
    groups: dict[str, list[dict]] = {}
    for r in rows:
        groups.setdefault(r.get("group", "?"), []).append(r)
    parts = [
        "<!doctype html><meta charset='utf-8'>",
        "<title>crdt_benches_tpu_torch report</title>",
        "<style>body{font:14px system-ui;margin:2em;max-width:70em}"
        "table{border-collapse:collapse;margin:1em 0}"
        "td,th{border:1px solid #ccc;padding:4px 10px;text-align:right}"
        "th{background:#f3f3f3}td.l,th.l{text-align:left}"
        "caption{font-weight:600;text-align:left;padding:4px 0}</style>",
        "<h1>crdt_benches_tpu_torch — bench report</h1>",
        "<p>element = one trace patch (the reference's Criterion "
        "throughput unit); strip = per-sample times, red line = "
        "median.</p>",
    ]
    for group in sorted(groups):
        parts.append(
            f"<table><caption>{html.escape(group)}</caption>"
            "<tr><th class='l'>trace/config</th><th class='l'>backend</th>"
            "<th>median el/s</th><th>median s</th><th>min s</th>"
            "<th>max s</th><th>n</th><th class='l'>samples</th>"
            "<th class='l'>source</th></tr>"
        )
        for r in sorted(
            groups[group],
            key=lambda r: (r.get("trace", ""), r.get("backend", "")),
        ):
            times = r.get("samples", r.get("times", []))
            med = sorted(times)[len(times) // 2] if times else 0.0
            elements = r.get("elements", 0)
            reps = r.get("replicas", 1) or 1
            # prefer the harness's own aggregate figure when present
            eps = r.get(
                "elements_per_sec", elements * reps / med if med else 0.0
            )
            stats = (
                f"<td>{med:.4f}</td><td>{min(times):.4f}</td>"
                f"<td>{max(times):.4f}</td><td>{len(times)}</td>"
                f"<td class='l'>{_strip_svg(times)}</td>"
                if times
                else "<td></td><td></td><td></td><td>0</td><td></td>"
            )
            parts.append(
                "<tr>"
                f"<td class='l'>{html.escape(str(r.get('trace', '')))}</td>"
                f"<td class='l'>{html.escape(str(r.get('backend', '')))}</td>"
                f"<td>{_fmt(eps)}</td>"
                f"{stats}"
                f"<td class='l'>{html.escape(r.get('_source', ''))}</td>"
                "</tr>"
            )
        parts.append("</table>")
    return "".join(parts)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("inputs", nargs="*", help="results JSON files")
    ap.add_argument("-o", "--out",
                    default=os.path.join(RESULTS_DIR, "torch_report.html"))
    args = ap.parse_args(argv)
    paths = args.inputs or sorted(glob.glob(os.path.join(RESULTS_DIR,
                                                         "*.json")))
    rows = load_results(paths)
    if not rows:
        print("no results found")
        return 1
    html_text = render(rows)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write(html_text)
    print(f"wrote {args.out}: {len(rows)} cells from {len(paths)} files")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
