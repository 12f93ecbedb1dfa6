"""Parameter-sweep reports: an interactive HTML app and a static report.

Port of ``gims_tpu/tools/parameter_visualize.py`` (reference
tools/parameter_visualize.py, a password-gated Dash dashboard over the
``parameter_search`` records: heatmaps per fixed r/t/m, a 3-D scatter of
correct matches and time, line plots):

- ``render_interactive``: the self-contained HTML app (records embedded as
  JSON, drawn client-side: scene, metric, fixed axis and value, hover
  tooltips, per-axis summary lines, the best parameter sets, an optional
  password), the JAX package's file to the byte for the same records;
- ``render_report``: the static report without matplotlib. Its sections
  and titles, in order, and the numbers behind each plot (each heatmap's
  grid, the per-axis means) are JAX's; the plots are drawn with
  ``core/drawing.py`` (viridis from ``core/viridis.py``, the 3-D scatter an
  orthographic projection from matplotlib's default view, elevation 30 and
  azimuth -60) and embedded as base64 PNG written by ``core/image_io.py``.

Input: ``record.txt`` (rows [r, t, m, correct, total, time], the
``parameter_search`` output) or ``record.csv``; ``record.xlsx`` needs a
spreadsheet reader the port does not have (``ROADMAP.md``).

    python -m gims_tpu_torch.tools.parameter_visualize out/search/a_b/record.txt \\
        --out dash.html [--static] [--password pw] [--serve --port 8050]
"""

from __future__ import annotations

import argparse
import ast
import base64
import csv
import json
import math
from pathlib import Path

import numpy as np

from gims_tpu_torch.core import drawing, image_io
from gims_tpu_torch.core.viridis import VIRIDIS

AXES = ("r", "t", "m")
WHITE = (255, 255, 255)
BLACK = (0, 0, 0)
GRAY = (200, 200, 200)
BLUE = (180, 119, 31)  # matplotlib's C0 (tab:blue), BGR
RED = (40, 39, 214)  # tab:red, BGR
FONT = drawing.FONT_HERSHEY_SIMPLEX
VIEW = (30.0, -60.0)  # elevation, azimuth of the 3-D scatter (matplotlib's default view)


def load_records(path):
    """A record.txt or record.csv as an (N, 6) float array."""
    path = str(path)
    if path.endswith(".xlsx"):
        raise NotImplementedError(f"{path}: .xlsx needs a spreadsheet reader the port does "
                                  "not have; use record.txt or record.csv (ROADMAP.md)")
    if path.endswith(".csv"):
        with open(path, newline="") as f:
            rows = [[float(v) for v in row] for row in list(csv.reader(f))[1:] if row]
        return np.array(rows, float)
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(ast.literal_eval(line))
    return np.array(rows, float)


def heatmap_grid(records, fix_axis, fix_value, value_col=3):
    """The heatmap of `value_col` over the two free axes with `fix_axis` at
    `fix_value`: (free axes, xs, ys, grid (len(ys), len(xs)) with NaN where
    no record lies), or None where no record has that value."""
    free = [a for a in (0, 1, 2) if a != fix_axis]
    sel = records[records[:, fix_axis] == fix_value]
    if len(sel) == 0:
        return None
    xs = np.unique(sel[:, free[0]])
    ys = np.unique(sel[:, free[1]])
    grid = np.full((len(ys), len(xs)), np.nan)
    for row in sel:
        grid[np.searchsorted(ys, row[free[1]]), np.searchsorted(xs, row[free[0]])] = row[value_col]
    return free, xs, ys, grid


def axis_means(records):
    """For each of r, t, m: (values, mean correct, mean time) over the
    records at each value."""
    out = []
    for i in range(3):
        vals = np.unique(records[:, i])
        out.append((vals, [records[records[:, i] == v, 3].mean() for v in vals],
                    [records[records[:, i] == v, 5].mean() for v in vals]))
    return out


def _colour(t):
    """Viridis at t in [0, 1], BGR."""
    r, g, b = VIRIDIS[int(round(min(max(t, 0.0), 1.0) * 255))]
    return (b, g, r)


def _text(img, text, org, scale=0.7, color=BLACK):
    drawing.put_text(img, str(text), (int(org[0]), int(org[1])), FONT, scale, color, 2)


def _png_b64(img):
    return base64.b64encode(image_io.encode_png(img)).decode()


def _colorbar(img, x0, y0, y1, lo, hi):
    for y in range(y0, y1):
        drawing.rectangle(img, (x0, y), (x0 + 16, y),
                          _colour((y1 - 1 - y) / max(y1 - y0 - 1, 1)), drawing.FILLED)
    drawing.rectangle(img, (x0, y0), (x0 + 16, y1 - 1), BLACK, 1)
    _text(img, f"{hi:g}", (x0 + 22, y0 + 12))
    _text(img, f"{lo:g}", (x0 + 22, y1))


def _heatmap(records, fix_axis, fix_value, value_col=3):
    """A heatmap PNG (base64), or None where no record has `fix_value`."""
    found = heatmap_grid(records, fix_axis, fix_value, value_col)
    if found is None:
        return None
    free, xs, ys, grid = found
    img = np.full((400, 520, 3), 255, np.uint8)
    x0, y0, x1, y1 = 70, 40, 400, 340
    lo, hi = np.nanmin(grid), np.nanmax(grid)
    cw, ch = (x1 - x0) / len(xs), (y1 - y0) / len(ys)
    for yi in range(len(ys)):
        for xi in range(len(xs)):
            v = grid[yi, xi]
            colour = GRAY if np.isnan(v) else _colour((v - lo) / max(hi - lo, 1e-12))
            drawing.rectangle(img, (int(x0 + xi * cw), int(y1 - (yi + 1) * ch)),
                              (int(x0 + (xi + 1) * cw) - 1, int(y1 - yi * ch) - 1), colour,
                              drawing.FILLED)
    for xi, x in enumerate(xs):
        _text(img, f"{x:g}", (x0 + (xi + 0.5) * cw - 8, y1 + 22))
    for yi, y in enumerate(ys):
        _text(img, f"{y:g}", (x0 - 30, y1 - (yi + 0.5) * ch + 6))
    _text(img, AXES[free[0]], ((x0 + x1) / 2, y1 + 48))
    _text(img, AXES[free[1]], (10, (y0 + y1) / 2))
    name = "correct" if value_col == 3 else "time"
    _text(img, f"{name} @ {AXES[fix_axis]}={fix_value:g}", (x0, 26))
    _colorbar(img, 440, y0, y1, lo, hi)
    return _png_b64(img)


def project(points, view=VIEW):
    """Orthographic screen coordinates (N, 2) and depth (N,) of points in
    the unit cube, seen from `view` = (elevation, azimuth) in degrees."""
    el, az = (math.radians(a) for a in view)
    p = np.asarray(points, float) - 0.5
    right = np.array([-math.sin(az), math.cos(az), 0.0])
    up = np.array([-math.sin(el) * math.cos(az), -math.sin(el) * math.sin(az), math.cos(el)])
    eye = np.array([math.cos(el) * math.cos(az), math.cos(el) * math.sin(az), math.sin(el)])
    return np.stack([p @ right, p @ up], 1), p @ eye


def _scatter3d(records, value_col=3):
    """A 3-D scatter PNG (base64) of the records over (r, t, m), coloured by
    `value_col`."""
    img = np.full((460, 560, 3), 255, np.uint8)
    lo3, hi3 = records[:, :3].min(0), records[:, :3].max(0)
    unit = (records[:, :3] - lo3) / np.maximum(hi3 - lo3, 1e-12)
    centre, scale = np.array([240.0, 240.0]), 260.0

    def screen(p):
        xy, _ = project(p)
        return [(int(round(centre[0] + scale * x)), int(round(centre[1] - scale * y)))
                for x, y in xy]

    corner = np.zeros(3)
    for axis in range(3):
        end = corner.copy()
        end[axis] = 1.0
        a, b = screen([corner, end])
        drawing.line(img, a, b, BLACK)
        _text(img, AXES[axis], (b[0] + 4, b[1] + 4))
    vals = records[:, value_col]
    lo, hi = vals.min(), vals.max()
    _, depth = project(unit)
    for i in np.argsort(depth, kind="stable"):  # far points first
        (x, y), = screen(unit[i:i + 1])
        drawing.circle(img, (x, y), 4, _colour((vals[i] - lo) / max(hi - lo, 1e-12)),
                       drawing.FILLED)
    name = "correct matches" if value_col == 3 else "time (s)"
    _text(img, f"3-D sweep: {name}", (20, 26))
    _colorbar(img, 480, 60, 400, lo, hi)
    return _png_b64(img)


def _polyline(img, xs, ys, colour, marker):
    pts = np.array([[int(round(x)), int(round(y))] for x, y in zip(xs, ys)], np.int32)
    if len(pts) > 1:
        drawing.polylines(img, [pts], False, colour, 1)
    for x, y in pts:
        if marker == "o":
            drawing.circle(img, (int(x), int(y)), 3, colour, drawing.FILLED)
        else:
            drawing.rectangle(img, (int(x) - 3, int(y) - 3), (int(x) + 3, int(y) + 3), colour,
                              drawing.FILLED)


def _lines(records):
    """The per-axis summary PNG (base64): for r, t and m, the mean correct
    matches (blue, circles) and the mean time (red, squares, its own scale)
    at each value."""
    pw, ph = 430, 300
    img = np.full((ph, 3 * pw, 3), 255, np.uint8)
    for i, (vals, mean_c, mean_t) in enumerate(axis_means(records)):
        x0, x1, y0, y1 = i * pw + 60, i * pw + pw - 60, 20, ph - 60
        drawing.rectangle(img, (x0, y0), (x1, y1), BLACK, 1)
        span = max(vals.max() - vals.min(), 1e-12)
        xs = [x0 + (v - vals.min()) / span * (x1 - x0) for v in vals]
        for series, colour, marker in ((mean_c, BLUE, "o"), (mean_t, RED, "s")):
            lo, hi = min(series), max(series)
            ys = [y1 - (v - lo) / max(hi - lo, 1e-12) * (y1 - y0) for v in series]
            _polyline(img, xs, ys, colour, marker)
        for v, x in zip(vals, xs):
            _text(img, f"{v:g}", (x - 8, y1 + 22))
        _text(img, AXES[i], ((x0 + x1) / 2, y1 + 48))
        _text(img, f"{min(mean_c):.4g}-{max(mean_c):.4g}", (x0, y0 + 18), color=BLUE)
        _text(img, f"{min(mean_t):.3g}-{max(mean_t):.3g} s", (x0, y0 + 40), color=RED)
    return _png_b64(img)


def report_sections(records):
    """(title, PNG base64 or None) of one record file's report, in JAX's
    order: the two 3-D scatters, the axis summaries, then a heatmap with
    each axis fixed at its middle value."""
    imgs = [("3-D correct matches", _scatter3d(records, 3)),
            ("3-D time", _scatter3d(records, 5)),
            ("axis summaries", _lines(records))]
    for axis in (0, 1, 2):
        vals = np.unique(records[:, axis])
        mid = vals[len(vals) // 2]
        hm = _heatmap(records, axis, mid)
        if hm:
            imgs.append((f"heatmap (fix axis {'rtm'[axis]}={mid:g})", hm))
    return imgs


def render_report(record_paths, out_html="parameter_report.html"):
    sections = []
    for path in record_paths:
        records = load_records(path)
        if len(records) == 0:
            continue
        body = "".join(f"<h3>{title}</h3><img src='data:image/png;base64,{b64}'/>"
                       for title, b64 in report_sections(records) if b64)
        sections.append(f"<h2>{Path(path).parent.name}</h2>{body}")
    html = ("<html><head><title>GIMS-TPU parameter sweeps</title></head>"
            "<body><h1>AGC parameter sweep report</h1>" + "".join(sections) + "</body></html>")
    with open(out_html, "w") as f:
        f.write(html)
    return out_html


_APP_JS = r"""
const DATA = __DATA__;
const PASSWORD = __PASSWORD__;
const AXES = ['r', 't', 'm'];
let state = {scene: Object.keys(DATA)[0], metric: 3, fix: 2, fixVal: null};

function uniq(rows, col) {
  return [...new Set(rows.map(r => r[col]))].sort((a, b) => a - b);
}
function colormap(v) { // viridis-ish 5-stop ramp
  const stops = [[68,1,84],[59,82,139],[33,145,140],[94,201,98],[253,231,37]];
  const t = Math.max(0, Math.min(1, v)) * (stops.length - 1);
  const i = Math.min(Math.floor(t), stops.length - 2), f = t - i;
  const c = stops[i].map((x, k) => Math.round(x + f * (stops[i+1][k] - x)));
  return `rgb(${c[0]},${c[1]},${c[2]})`;
}
function drawHeatmap() {
  const rows = DATA[state.scene];
  const free = [0, 1, 2].filter(a => a !== state.fix);
  const sel = rows.filter(r => r[state.fix] === state.fixVal);
  const xs = uniq(sel, free[0]), ys = uniq(sel, free[1]);
  const cv = document.getElementById('hm'), ctx = cv.getContext('2d');
  ctx.clearRect(0, 0, cv.width, cv.height);
  if (!sel.length) return;
  const vals = sel.map(r => r[state.metric]);
  const lo = Math.min(...vals), hi = Math.max(...vals);
  const cw = (cv.width - 60) / xs.length, chh = (cv.height - 40) / ys.length;
  const cells = {};
  sel.forEach(r => {
    cells[`${r[free[0]]},${r[free[1]]}`] = r;
  });
  xs.forEach((x, xi) => ys.forEach((y, yi) => {
    const r = cells[`${x},${y}`];
    if (!r) return;
    const v = (r[state.metric] - lo) / Math.max(hi - lo, 1e-9);
    ctx.fillStyle = colormap(v);
    ctx.fillRect(50 + xi * cw, cv.height - 30 - (yi + 1) * chh, cw - 1, chh - 1);
  }));
  ctx.fillStyle = '#222'; ctx.font = '11px sans-serif';
  xs.forEach((x, xi) => ctx.fillText(x, 50 + xi * cw + cw / 2 - 6, cv.height - 14));
  ys.forEach((y, yi) => ctx.fillText(y, 18, cv.height - 30 - yi * chh - chh / 2 + 4));
  ctx.fillText(AXES[free[0]], cv.width / 2, cv.height - 2);
  ctx.save(); ctx.translate(8, cv.height / 2); ctx.rotate(-Math.PI / 2);
  ctx.fillText(AXES[free[1]], 0, 0); ctx.restore();
  cv.onmousemove = ev => {
    const b = cv.getBoundingClientRect();
    const xi = Math.floor((ev.clientX - b.left - 50) / cw);
    const yi = Math.floor((cv.height - 30 - (ev.clientY - b.top)) / chh);
    const tip = document.getElementById('tip');
    if (xi >= 0 && xi < xs.length && yi >= 0 && yi < ys.length) {
      const r = cells[`${xs[xi]},${ys[yi]}`];
      if (r) {
        tip.textContent = `r=${r[0]} t=${r[1]} m=${r[2]}  correct=${r[3]}/${r[4]}  time=${r[5].toFixed(2)}s`;
        return;
      }
    }
    tip.textContent = '';
  };
}
function drawLines() {
  const rows = DATA[state.scene];
  AXES.forEach((name, axis) => {
    const cv = document.getElementById('ln' + axis), ctx = cv.getContext('2d');
    ctx.clearRect(0, 0, cv.width, cv.height);
    const vals = uniq(rows, axis);
    const means = vals.map(v => {
      const sel = rows.filter(r => r[axis] === v);
      return sel.reduce((s, r) => s + r[state.metric], 0) / sel.length;
    });
    const lo = Math.min(...means), hi = Math.max(...means);
    ctx.strokeStyle = '#2a6'; ctx.beginPath();
    vals.forEach((v, i) => {
      const x = 28 + i * (cv.width - 40) / Math.max(vals.length - 1, 1);
      const y = cv.height - 22 - (means[i] - lo) / Math.max(hi - lo, 1e-9) * (cv.height - 36);
      i ? ctx.lineTo(x, y) : ctx.moveTo(x, y);
      ctx.fillStyle = '#222'; ctx.fillText(v, x - 6, cv.height - 8);
    });
    ctx.stroke();
    ctx.fillText(`mean ${state.metric === 3 ? 'correct' : 'time'} vs ${name}`, 30, 12);
  });
}
function drawTable() {
  const rows = [...DATA[state.scene]];
  rows.sort((a, b) => b[3] - a[3]);
  const top = rows.slice(0, 12);
  document.getElementById('tbl').innerHTML =
    '<tr><th>r</th><th>t</th><th>m</th><th>correct</th><th>total</th><th>time (s)</th></tr>' +
    top.map(r => `<tr><td>${r[0]}</td><td>${r[1]}</td><td>${r[2]}</td>` +
      `<td>${r[3]}</td><td>${r[4]}</td><td>${r[5].toFixed(2)}</td></tr>`).join('');
}
function refit() {
  const rows = DATA[state.scene];
  const vals = uniq(rows, state.fix);
  const slider = document.getElementById('fixval');
  slider.max = vals.length - 1;
  if (state.fixVal === null || !vals.includes(state.fixVal)) {
    slider.value = Math.floor(vals.length / 2);
  }
  state.fixVal = vals[slider.value];
  document.getElementById('fixlabel').textContent =
    `${AXES[state.fix]} = ${state.fixVal}`;
  drawHeatmap(); drawLines(); drawTable();
}
function init() {
  if (PASSWORD && prompt('password') !== PASSWORD) {
    document.body.innerHTML = '<h2>locked</h2>'; return;
  }
  const scene = document.getElementById('scene');
  Object.keys(DATA).forEach(k => scene.add(new Option(k, k)));
  scene.onchange = () => { state.scene = scene.value; state.fixVal = null; refit(); };
  document.getElementById('metric').onchange =
    e => { state.metric = +e.target.value; refit(); };
  document.getElementById('fixaxis').onchange =
    e => { state.fix = +e.target.value; state.fixVal = null; refit(); };
  document.getElementById('fixval').oninput = () => { state.fixVal = null; refit(); };
  refit();
}
window.onload = init;
"""

_APP_HTML = """<html><head><title>GIMS-TPU parameter sweeps</title>
<style>
 body {{ font-family: sans-serif; margin: 18px; }}
 canvas {{ border: 1px solid #ccc; margin: 4px; }}
 select, input {{ margin: 0 10px 0 4px; }}
 table {{ border-collapse: collapse; }}
 td, th {{ border: 1px solid #bbb; padding: 2px 10px; text-align: right; }}
 #tip {{ height: 18px; color: #333; font-size: 13px; }}
</style></head><body>
<h1>AGC parameter sweep dashboard</h1>
<div>
 scene <select id="scene"></select>
 metric <select id="metric"><option value="3">correct</option>
 <option value="5">time</option></select>
 fix axis <select id="fixaxis"><option value="0">r</option>
 <option value="1">t</option><option value="2" selected>m</option></select>
 <input type="range" id="fixval" min="0" max="0" value="0"/>
 <span id="fixlabel"></span>
</div>
<canvas id="hm" width="640" height="420"></canvas>
<div id="tip"></div>
<div>
 <canvas id="ln0" width="300" height="160"></canvas>
 <canvas id="ln1" width="300" height="160"></canvas>
 <canvas id="ln2" width="300" height="160"></canvas>
</div>
<h3>best parameter sets</h3>
<table id="tbl"></table>
<script>{script}</script>
</body></html>"""


def render_interactive(record_paths, out_html="parameter_dashboard.html", password=None):
    """The self-contained interactive dashboard (the Dash app's counterpart)."""
    data = {}
    for path in record_paths:
        records = load_records(path)
        if len(records):
            data[Path(path).parent.name or Path(path).stem] = records.tolist()
    script = _APP_JS.replace("__DATA__", json.dumps(data)).replace(
        "__PASSWORD__", json.dumps(password))
    with open(out_html, "w") as f:
        f.write(_APP_HTML.format(script=script))
    return out_html


def serve(out_html, port=8050):
    """Serve the report's directory with the standard library's HTTP server."""
    import functools
    import http.server

    directory = str(Path(out_html).resolve().parent)
    handler = functools.partial(http.server.SimpleHTTPRequestHandler, directory=directory)
    print(f"Serving {out_html} at http://127.0.0.1:{port}/{Path(out_html).name}")
    http.server.HTTPServer(("127.0.0.1", port), handler).serve_forever()


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("records", nargs="+", help="record.txt / record.csv files")
    parser.add_argument("--out", type=str, default="parameter_report.html")
    parser.add_argument("--serve", action="store_true")
    parser.add_argument("--port", type=int, default=8050)
    parser.add_argument("--static", action="store_true",
                        help="the static report instead of the interactive app")
    parser.add_argument("--password", type=str, default=None,
                        help="optional access gate (the reference's Dash app is "
                             "password-protected)")
    args = parser.parse_args(argv)
    if args.static:
        out = render_report(args.records, args.out)
    else:
        out = render_interactive(args.records, args.out, args.password)
    print(f"wrote {out}")
    if args.serve:
        serve(out, args.port)
    return out


if __name__ == "__main__":
    main()
