"""Single-file HTML reports for repro_torch.obs (counterpart of
``repro.obs.report``, copied): sessions, postmortem
bundles, and BENCH trajectories rendered with inline-SVG sparklines and
bar charts — zero dependencies, one self-contained file, open it
anywhere.

Three section kinds compose into one report:

* **BENCH trajectory** — every ``BENCH_*.json`` under a directory in
  sorted order (a perf trajectory): per-file total-seconds bars, per-entry wall-time and
  ``max_rel_err`` sparklines across the trajectory with last-hop
  deltas, and presence changes.
* **Session** — a ``Session.snapshot()``: balance/stability gauge
  tiles (the paper's balanced-utilization thesis at a glance), the
  span table, counters, histogram summaries, and per-step series
  sparklines when raw curves are supplied (a live session has them;
  a snapshot dict only has summaries).
* **Postmortem bundle** — a watchdog dump: the trigger banner, the
  run context, and the flight recorder's ring-buffer channels as
  sparklines (the last-W steps before the anomaly).

Programmatic::

    from repro_torch.obs import report
    report.render_report("report.html", bench_dir=".",
                         sessions=[("sweep", sess.snapshot(),
                                    report.session_series(sess))],
                         bundles=[obs.load_bundle(path)])

CLI::

    python -m repro_torch.obs.report -o report.html --bench-dir . \
        --bundle postmortems/postmortem_dest_stability_200.json \
        --session snap.json
"""

from __future__ import annotations

import argparse
import glob as globmod
import html as htmlmod
import json
import os
import sys
import time

__all__ = ["render_report", "html_report", "session_series", "main"]

_CSS = """
body { font-family: -apple-system, 'Segoe UI', Roboto, sans-serif;
       margin: 2em auto; max-width: 72em; color: #1a1a2e; }
h1 { font-size: 1.5em; border-bottom: 2px solid #16213e; }
h2 { font-size: 1.15em; margin-top: 2em; color: #16213e; }
h3 { font-size: 0.95em; margin-bottom: 0.3em; }
table { border-collapse: collapse; font-size: 0.82em; margin: 0.6em 0; }
th, td { padding: 2px 10px; text-align: right; }
th { border-bottom: 1px solid #888; text-align: right; }
td.l, th.l { text-align: left; }
tr:nth-child(even) { background: #f4f5fa; }
.tiles { display: flex; flex-wrap: wrap; gap: 8px; margin: 0.6em 0; }
.tile { border: 1px solid #d0d4e4; border-radius: 6px;
        padding: 6px 12px; background: #fafbff; }
.tile .v { font-size: 1.25em; font-weight: 600; }
.tile .k { font-size: 0.72em; color: #555; }
.spark { vertical-align: middle; }
.banner { border-left: 5px solid #c0392b; background: #fdf0ee;
          padding: 8px 14px; margin: 0.8em 0; font-size: 0.9em; }
.ok { border-left-color: #27ae60; background: #eefbf2; }
.up { color: #c0392b; } .down { color: #27ae60; }
.muted { color: #777; font-size: 0.8em; }
svg { overflow: visible; }
"""


def _esc(s) -> str:
    return htmlmod.escape(str(s))


def _fmt(v, digits: int = 4) -> str:
    if v is None:
        return "—"
    try:
        f = float(v)
    except (TypeError, ValueError):
        return _esc(v)
    if f != f:
        return "nan"
    if f == int(f) and abs(f) < 1e12:
        return str(int(f))
    return f"{f:.{digits}g}"


def _spark(values, w: int = 180, h: int = 30, color: str = "#16213e") -> str:
    """Inline-SVG sparkline of a numeric sequence (empty-safe)."""
    vals = [float(v) for v in values
            if isinstance(v, (int, float)) and float(v) == float(v)]
    if len(vals) < 2:
        return '<span class="muted">·</span>'
    lo, hi = min(vals), max(vals)
    span = (hi - lo) or 1.0
    n = len(vals)
    pts = " ".join(
        f"{(w - 4) * i / (n - 1) + 2:.1f},"
        f"{h - 3 - (h - 6) * (v - lo) / span:.1f}"
        for i, v in enumerate(vals))
    last_y = h - 3 - (h - 6) * (vals[-1] - lo) / span
    return (f'<svg class="spark" width="{w}" height="{h}">'
            f'<polyline points="{pts}" fill="none" stroke="{color}" '
            f'stroke-width="1.3"/>'
            f'<circle cx="{w - 2}" cy="{last_y:.1f}" r="2" '
            f'fill="{color}"/></svg>')


def _bars(items, w: int = 420, color: str = "#3b5bdb") -> str:
    """Horizontal bar chart from ``[(label, value), ...]``."""
    items = [(str(k), float(v)) for k, v in items]
    if not items:
        return '<span class="muted">no data</span>'
    vmax = max((v for _k, v in items), default=0.0) or 1.0
    rowh, lab_w = 18, 180
    h = rowh * len(items) + 4
    parts = [f'<svg width="{w + lab_w + 70}" height="{h}">']
    for i, (k, v) in enumerate(items):
        y = i * rowh + 2
        bw = max(w * v / vmax, 1.0)
        parts.append(
            f'<text x="{lab_w - 6}" y="{y + 12}" text-anchor="end" '
            f'font-size="11">{_esc(k[:28])}</text>'
            f'<rect x="{lab_w}" y="{y + 2}" width="{bw:.1f}" '
            f'height="{rowh - 6}" fill="{color}" rx="2"/>'
            f'<text x="{lab_w + bw + 5:.1f}" y="{y + 12}" '
            f'font-size="11">{_fmt(v)}</text>')
    parts.append("</svg>")
    return "".join(parts)


def _tiles(pairs) -> str:
    """Stat tiles from ``[(label, value), ...]``."""
    cells = "".join(
        f'<div class="tile"><div class="v">{_fmt(v)}</div>'
        f'<div class="k">{_esc(k)}</div></div>' for k, v in pairs)
    return f'<div class="tiles">{cells}</div>'


# -- BENCH trajectory ------------------------------------------------------

def _bench_files(bench_dir: str, pattern: str) -> list:
    out = []
    for path in sorted(globmod.glob(os.path.join(bench_dir, pattern))):
        try:
            with open(path) as fh:
                payload = json.load(fh)
        except (OSError, json.JSONDecodeError):
            continue
        if "entries" in payload:
            out.append((os.path.basename(path), payload))
    return out


def _bench_section(files: list) -> str:
    if not files:
        return ("<h2>BENCH trajectory</h2>"
                '<p class="muted">no BENCH files found</p>')
    parts = [f"<h2>BENCH trajectory ({len(files)} files)</h2>"]
    totals = [(name, payload.get("total_seconds", 0.0))
              for name, payload in files]
    parts.append("<h3>total wall seconds per artifact</h3>")
    parts.append(_bars(totals))
    # per-entry series across the trajectory
    order: list[str] = []
    by_entry: dict = {}
    for fname, payload in files:
        for e in payload.get("entries", []):
            name = e.get("name")
            if name not in by_entry:
                by_entry[name] = {}
                order.append(name)
            by_entry[name][fname] = e
    fnames = [f for f, _p in files]
    rows = []
    for name in order:
        recs = by_entry[name]
        secs = [recs[f].get("seconds") if f in recs else None
                for f in fnames]
        errs = [recs[f].get("max_rel_err") if f in recs else None
                for f in fnames]
        have = [f for f in fnames if f in recs]
        present = (f"{len(have)}/{len(fnames)}"
                   if len(have) < len(fnames) else "all")
        s_list = [s for s in secs if s is not None]
        e_list = [e for e in errs if e is not None]
        d_sec = d_err = ""
        if len(s_list) >= 2 and s_list[-2] > 0:
            pct = 100.0 * (s_list[-1] - s_list[-2]) / s_list[-2]
            cls = "up" if pct > 10 else ("down" if pct < -10 else "")
            d_sec = f'<span class="{cls}">{pct:+.0f}%</span>'
        if len(e_list) >= 2:
            dv = e_list[-1] - e_list[-2]
            cls = "up" if dv > 1e-6 else ("down" if dv < -1e-6 else "")
            d_err = f'<span class="{cls}">{dv:+.2g}</span>'
        rows.append(
            f'<tr><td class="l">{_esc(name)}</td>'
            f"<td>{_spark(secs)}</td><td>{_fmt(s_list[-1] if s_list else None)}"
            f"</td><td>{d_sec}</td>"
            f"<td>{_spark(errs, color='#c0392b')}</td>"
            f"<td>{_fmt(e_list[-1] if e_list else None)}</td>"
            f"<td>{d_err}</td><td>{present}</td></tr>")
    parts.append(
        '<h3>per-entry trajectory</h3><table><tr><th class="l">entry</th>'
        "<th>seconds</th><th>last</th><th>Δ</th>"
        "<th>max_rel_err</th><th>last</th><th>Δ</th><th>present</th></tr>"
        + "".join(rows) + "</table>")
    crashed = [(f, [e.get("section") for e in p.get("errors") or []])
               for f, p in files if p.get("errors")]
    for fname, sections in crashed:
        parts.append(f'<div class="banner">crashed sections in '
                     f"{_esc(fname)}: {_esc(sections)}</div>")
    return "".join(parts)


# -- session snapshots -----------------------------------------------------

# the gauges worth a tile, in display order (the paper's balance story)
_TILE_GAUGES = ("sim.balance.gini", "sim.balance.p99_over_mean",
                "sim.balance.max_over_mean", "sim.dest_stability.min",
                "sim.dest_stability.mean", "sim.theta", "sim.residual",
                "sim.alpha", "sim.delivered_rate")


def session_series(sess) -> dict:
    """Raw per-step curves of a LIVE session's series metrics —
    ``{name: [floats]}`` — for sparkline rendering (snapshots only keep
    summaries)."""
    out = {}
    reg = getattr(sess, "metrics", None)
    if reg is None:
        return out
    for name in reg.names():
        m = reg.get(name)
        if getattr(m, "kind", None) == "series":
            out[name] = list(m.values)
    return out


def _session_section(title: str, snap: dict, series: dict | None) -> str:
    if not snap:
        return (f"<h2>session: {_esc(title)}</h2>"
                '<p class="muted">empty snapshot</p>')
    parts = [f"<h2>session: {_esc(title)} "
             f'<span class="muted">mode={_esc(snap.get("mode"))}</span></h2>']
    metrics = snap.get("metrics") or {}
    tiles = [(n, metrics[n]["value"]) for n in _TILE_GAUGES
             if n in metrics and "value" in metrics[n]]
    if tiles:
        parts.append(_tiles(tiles))
    spans = snap.get("spans") or {}
    if spans:
        ranked = sorted(spans.items(),
                        key=lambda kv: -kv[1].get("total_s", 0.0))
        rows = "".join(
            f'<tr><td class="l">{_esc(n)}</td><td>{r.get("count")}</td>'
            f'<td>{_fmt(r.get("total_s"))}</td>'
            f'<td>{_fmt(r.get("max_s"))}</td></tr>'
            for n, r in ranked[:20])
        parts.append('<h3>spans (top 20 by total time)</h3><table>'
                     '<tr><th class="l">span</th><th>count</th>'
                     "<th>total_s</th><th>max_s</th></tr>"
                     + rows + "</table>")
    kinds: dict = {"counter": [], "gauge": [], "histogram": [],
                   "series": []}
    for name in sorted(metrics):
        kinds.setdefault(metrics[name].get("type"), []).append(name)
    if kinds["counter"]:
        rows = "".join(
            f'<tr><td class="l">{_esc(n)}</td>'
            f'<td>{_fmt(metrics[n]["value"])}</td></tr>'
            for n in kinds["counter"])
        parts.append('<h3>counters</h3><table><tr><th class="l">counter'
                     "</th><th>total</th></tr>" + rows + "</table>")
    if kinds["histogram"]:
        rows = "".join(
            f'<tr><td class="l">{_esc(n)}</td>'
            + "".join(f"<td>{_fmt(metrics[n].get(k))}</td>"
                      for k in ("count", "mean", "min", "p50", "p90",
                                "p99", "max"))
            + "</tr>" for n in kinds["histogram"])
        parts.append('<h3>histograms</h3><table><tr><th class="l">'
                     "histogram</th><th>count</th><th>mean</th><th>min"
                     "</th><th>p50</th><th>p90</th><th>p99</th><th>max"
                     "</th></tr>" + rows + "</table>")
    if kinds["series"]:
        rows = []
        for n in kinds["series"]:
            rec = metrics[n]
            curve = (series or {}).get(n)
            spk = (_spark(curve, w=260) if curve
                   else '<span class="muted">summary only</span>')
            rows.append(f'<tr><td class="l">{_esc(n)}</td><td>{spk}</td>'
                        f'<td>{_fmt(rec.get("count"))}</td>'
                        f'<td>{_fmt(rec.get("last"))}</td>'
                        f'<td>{_fmt(rec.get("max"))}</td></tr>')
        parts.append('<h3>series</h3><table><tr><th class="l">series'
                     "</th><th>curve</th><th>count</th><th>last</th>"
                     "<th>max</th></tr>" + "".join(rows) + "</table>")
    return "".join(parts)


# -- postmortem bundles ----------------------------------------------------

def _bundle_section(bundle: dict) -> str:
    trig = bundle.get("trigger") or {}
    parts = [f"<h2>postmortem: {_esc(trig.get('name', '?'))}</h2>",
             f'<div class="banner"><b>{_esc(trig.get("name"))}</b> — '
             f"{_esc(bundle.get('reason', ''))}</div>"]
    ctx = dict(bundle.get("context") or {})
    ctx["git_rev"] = bundle.get("git_rev")
    if ctx:
        rows = "".join(
            f'<tr><td class="l">{_esc(k)}</td>'
            f'<td class="l">{_esc(_fmt(v) if isinstance(v, float) else v)}'
            f"</td></tr>" for k, v in sorted(ctx.items()))
        parts.append('<h3>context</h3><table><tr><th class="l">key</th>'
                     '<th class="l">value</th></tr>' + rows + "</table>")
    rec = bundle.get("recorder")
    if rec and rec.get("channels"):
        steps = rec.get("steps") or []
        lo = steps[0] if steps else "?"
        hi = steps[-1] if steps else "?"
        parts.append(f"<h3>flight recorder — steps {lo}..{hi} "
                     f'(window {rec.get("window")})</h3>')
        rows = []
        for name in sorted(rec["channels"]):
            vals = rec["channels"][name]
            last = vals[-1] if vals else None
            rows.append(
                f'<tr><td class="l">{_esc(name)}</td>'
                f"<td>{_spark(vals, w=300, color='#c0392b')}</td>"
                f"<td>{_fmt(last)}</td></tr>")
        parts.append('<table><tr><th class="l">channel</th><th>last-W '
                     "curve</th><th>last</th></tr>"
                     + "".join(rows) + "</table>")
    sample = bundle.get("sample") or {}
    if sample:
        rows = "".join(
            f'<tr><td class="l">{_esc(k)}</td><td>{_fmt(v)}</td></tr>'
            for k, v in sorted(sample.items()))
        parts.append('<h3>firing sample</h3><table><tr><th class="l">'
                     "field</th><th>value</th></tr>" + rows + "</table>")
    if bundle.get("metrics"):
        parts.append(_session_section(
            "bundle metrics", {"mode": "bundle",
                               "metrics": bundle["metrics"],
                               "spans": bundle.get("spans") or {}}, None))
    return "".join(parts)


# -- top level -------------------------------------------------------------

def html_report(bench_dir: str | None = None,
                bench_glob: str = "BENCH_*.json",
                sessions=None, bundles=None,
                title: str = "repro observability report") -> str:
    """Assemble the single-file HTML document (as a string)."""
    body = [f"<h1>{_esc(title)}</h1>",
            f'<p class="muted">generated '
            f"{time.strftime('%Y-%m-%d %H:%M:%S')}</p>"]
    if bench_dir is not None:
        body.append(_bench_section(_bench_files(bench_dir, bench_glob)))
    for entry in (sessions or []):
        name, snap = entry[0], entry[1]
        series = entry[2] if len(entry) > 2 else None
        body.append(_session_section(name, snap or {}, series))
    for bundle in (bundles or []):
        body.append(_bundle_section(bundle))
    return ("<!DOCTYPE html><html><head><meta charset='utf-8'>"
            f"<title>{_esc(title)}</title><style>{_CSS}</style></head>"
            "<body>" + "".join(body) + "</body></html>")


def render_report(out_path: str, **kwargs) -> str:
    """Write :func:`html_report` to ``out_path``; returns the path."""
    doc = html_report(**kwargs)
    with open(out_path, "w") as fh:
        fh.write(doc)
    return out_path


def _load_session_arg(path: str) -> list:
    """A --session file is either one snapshot or a BENCH payload with
    per-section snapshots under "obs"."""
    with open(path) as fh:
        payload = json.load(fh)
    base = os.path.basename(path)
    if payload.get("schema") == "repro.obs/1":
        return [(base, payload)]
    if "obs" in payload:
        return [(f"{base}:{sec}", snap)
                for sec, snap in payload["obs"].items()]
    raise ValueError(f"{path}: neither a session snapshot nor a BENCH "
                     f"payload with an 'obs' block")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-o", "--out", default="report.html")
    ap.add_argument("--bench-dir", default=None, metavar="PATH",
                    help="render the BENCH_*.json trajectory under PATH")
    ap.add_argument("--glob", default="BENCH_*.json")
    ap.add_argument("--session", action="append", default=[],
                    metavar="SNAP.json",
                    help="session snapshot file (or BENCH payload with an "
                         "'obs' block); repeatable")
    ap.add_argument("--bundle", action="append", default=[],
                    metavar="BUNDLE.json",
                    help="postmortem bundle from a watchdog; repeatable")
    ap.add_argument("--title", default="repro observability report")
    args = ap.parse_args(argv)
    try:
        sessions = []
        for path in args.session:
            sessions.extend(_load_session_arg(path))
        from .watchdog import load_bundle
        bundles = [load_bundle(p) for p in args.bundle]
        render_report(args.out, bench_dir=args.bench_dir,
                      bench_glob=args.glob, sessions=sessions,
                      bundles=bundles, title=args.title)
    except (OSError, ValueError, json.JSONDecodeError) as e:
        print(f"# report failed: {e}", file=sys.stderr)
        return 2
    print(f"# wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
