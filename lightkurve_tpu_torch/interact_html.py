"""Self-contained HTML/JS live widgets (``lightkurve_tpu/interact_html.py``,
copied: the port never imports the JAX package).

Lightkurve's ``tpf.interact()`` / ``lc.interact_bls()`` /
``Seismology.interact_echelle()`` run a bokeh *server* session that
recomputes photometry / BLS / the echelle fold in Python on every
browser event (reference ``interact.py:999-1318``,
``interact_bls.py:602-1004``, ``seismology/core.py:502-640``).  Here one
batched pass precomputes the interaction state space up front — a dense
BLS period grid on the device (the card unless the caller asks for the
CPU), every pixel's light curve, the whole power spectrum — and the
browser then only does O(N) folding/summing in vanilla JavaScript.  The
result is a single portable HTML file that needs no server, no bokeh, no
network, and stays interactive (sliders, pixel clicks, zoom and fold all
run client-side).  The pages' data, layout and JavaScript are the JAX
package's.

Four exporters:

- :func:`export_interact_bls_html` — the three linked BLS panels
  (power spectrum, folded curve + box model, full curve with in-transit
  highlights).  Period selection re-folds instantly in JS; the period
  grid is precomputed on the device.
- :func:`export_interact_html` — the pixel-selector widget: click
  pixels to edit the aperture, the SAP preview re-sums live; the
  per-pixel light curves come from one host pass over the cube.
- :func:`export_interact_echelle_html` — the echelle explorer with a
  live Δν slider re-folding the power spectrum on a canvas.
- :func:`export_interact_sky_html` — the sky view of an offline catalog
  projected through the TPF's WCS.
"""
from __future__ import annotations

import json
import math
import os

import numpy as np
import torch

from .utils import LightkurveError, LightkurveWarning

__all__ = ["export_interact_bls_html", "export_interact_html",
           "export_interact_echelle_html", "export_interact_sky_html",
           "demo_sky_catalog"]


def demo_sky_catalog():
    """Path of the bundled demo sky catalog (CSV) for the Tabby-star TPF.

    The reference's ``tpf.interact_sky()`` pulls live Gaia sources over
    the network (reference ``interact.py:91-153``), which this package
    does not use, so a small SYNTHETIC catalog — 25 sources with
    Kepler-field-like magnitudes and Gaia-like proper motions, laid out
    on the stamp of the reference's Tabby-star test TPF
    (``test-tpf-kplr-tabby-100-cadences.fits``) — ships with the package
    so the sky widget can be demoed out of the box::

        export_interact_sky_html(tpf, "sky.html",
                                 catalog=demo_sky_catalog())

    For real work, pass your own Gaia archive cone-search export
    (CSV/JSON) instead.
    """
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "data", "demo_sky_catalog_tabby.csv")


# ----------------------------------------------------------------------
# embedding helpers
# ----------------------------------------------------------------------

def _host(a):
    """A column (Quantity, Time, tensor on any device, or array) as a
    float64 host array."""
    a = getattr(a, "value", a)
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=np.float64)


def _js_array(a, sig=6):
    """Compact JSON list for embedding; NaN/inf become null."""
    a = _host(a).ravel()
    fmt = "%." + str(int(sig)) + "g"
    out = [None if not math.isfinite(v) else float(fmt % v)
           for v in a.tolist()]
    return json.dumps(out, separators=(",", ":"))


def _decimate(n, max_points):
    """Indices that keep at most ``max_points`` samples (uniform stride)."""
    if n <= max_points:
        return np.arange(n)
    stride = int(np.ceil(n / max_points))
    return np.arange(0, n, stride)


def _bin_cube(time, cube, max_cadences):
    """nan-aware bin-average of (T, ...) down to <= max_cadences."""
    T = time.shape[0]
    if T <= max_cadences:
        return time, cube
    k = int(np.ceil(T / max_cadences))
    nb = T // k
    tt = time[: nb * k].reshape(nb, k).mean(axis=1)
    cc = cube[: nb * k].reshape((nb, k) + cube.shape[1:])
    with np.errstate(invalid="ignore"):
        cc = np.nanmean(cc, axis=1)
    return tt, cc


_CSS = """
body{font-family:system-ui,-apple-system,sans-serif;margin:16px;
     background:#fafafa;color:#1a1a1a;max-width:980px}
h2{font-size:18px;margin:4px 0 2px}
.sub{color:#666;font-size:12px;margin:0 0 10px}
canvas{background:#fff;border:1px solid #d8d8d8;border-radius:4px;
       display:block;margin:8px 0;touch-action:none}
.readout{font-size:13px;color:#333;font-variant-numeric:tabular-nums;
         margin:2px 0}
button{font:12px system-ui;margin-right:6px;padding:3px 10px;
       border:1px solid #bbb;border-radius:4px;background:#fff;
       cursor:pointer}
button:hover{background:#eef}
input[type=range]{width:420px;vertical-align:middle}
.hint{color:#888;font-size:11px}
"""

# Shared JS plotting helpers: axes, series, scatter on a 2d canvas.
_JS_LIB = r"""
function mkplot(canvas){
  const ctx = canvas.getContext('2d');
  const P = {l:54, r:10, t:8, b:30};
  const o = {canvas, ctx, P, xmin:0, xmax:1, ymin:0, ymax:1};
  o.sx = x => P.l + (x - o.xmin)/(o.xmax - o.xmin)*(canvas.width - P.l - P.r);
  o.sy = y => canvas.height - P.b -
              (y - o.ymin)/(o.ymax - o.ymin)*(canvas.height - P.t - P.b);
  o.clear = function(xl, yl){
    ctx.clearRect(0,0,canvas.width,canvas.height);
    ctx.strokeStyle = '#999'; ctx.lineWidth = 1;
    ctx.strokeRect(P.l, P.t, canvas.width-P.l-P.r, canvas.height-P.t-P.b);
    ctx.fillStyle = '#444'; ctx.font = '11px system-ui';
    const nt = 5;
    for (let i = 0; i <= nt; i++){
      const x = o.xmin + (o.xmax-o.xmin)*i/nt;
      const y = o.ymin + (o.ymax-o.ymin)*i/nt;
      ctx.textAlign = 'center';
      ctx.fillText(fmt(x), o.sx(x), canvas.height-P.b+14);
      ctx.textAlign = 'right';
      ctx.fillText(fmt(y), P.l-4, o.sy(y)+4);
    }
    ctx.textAlign = 'center';
    if (xl) ctx.fillText(xl, (P.l+canvas.width-P.r)/2, canvas.height-4);
    if (yl){ ctx.save(); ctx.translate(12,(P.t+canvas.height-P.b)/2);
             ctx.rotate(-Math.PI/2); ctx.fillText(yl,0,0); ctx.restore(); }
  };
  o.clip = function(fn){
    ctx.save(); ctx.beginPath();
    ctx.rect(P.l, P.t, canvas.width-P.l-P.r, canvas.height-P.t-P.b);
    ctx.clip(); fn(); ctx.restore();
  };
  o.line = function(xs, ys, color){
    o.clip(() => {
      ctx.strokeStyle = color; ctx.lineWidth = 1; ctx.beginPath();
      let pen = false;
      for (let i = 0; i < xs.length; i++){
        if (ys[i] === null || xs[i] === null){ pen = false; continue; }
        const X = o.sx(xs[i]), Y = o.sy(ys[i]);
        if (pen) ctx.lineTo(X, Y); else { ctx.moveTo(X, Y); pen = true; }
      }
      ctx.stroke();
    });
  };
  o.dots = function(xs, ys, color, r, sel){
    o.clip(() => {
      ctx.fillStyle = color;
      for (let i = 0; i < xs.length; i++){
        if (ys[i] === null || xs[i] === null) continue;
        if (sel && !sel(i)) continue;
        ctx.fillRect(o.sx(xs[i])-r, o.sy(ys[i])-r, 2*r, 2*r);
      }
    });
  };
  o.vline = function(x, color){
    o.clip(() => {
      ctx.strokeStyle = color; ctx.setLineDash([4,3]); ctx.beginPath();
      ctx.moveTo(o.sx(x), P.t); ctx.lineTo(o.sx(x), canvas.height-P.b);
      ctx.stroke(); ctx.setLineDash([]);
    });
  };
  return o;
}
function fmt(v){
  if (v === 0) return '0';
  const a = Math.abs(v);
  if (a >= 1e5 || a < 1e-3) return v.toExponential(1);
  return Number(v.toPrecision(5)).toString();
}
function ylimits(f){
  const fin = f.filter(v => v !== null);
  if (!fin.length) return [0, 1];
  const s = fin.slice().sort((a,b)=>a-b);
  const med = s[(s.length-1)>>1];
  const mean = fin.reduce((a,b)=>a+b,0)/fin.length;
  const sd = Math.sqrt(fin.reduce((a,b)=>a+(b-mean)*(b-mean),0)/fin.length);
  const keep = sd > 0 ? fin.filter(v => Math.abs(v-med) <= 5*sd) : fin;
  const k = keep.slice().sort((a,b)=>a-b);
  const lo = k[Math.floor(0.01*(k.length-1))];
  const hi = k[Math.ceil(0.99*(k.length-1))];
  const m = 0.10*(hi-lo) || Math.abs(hi)*0.05 || 1;
  return [lo-m, hi+m];
}
"""


def _page(title, subtitle, body, data_js, main_js, path):
    html = f"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title>
<style>{_CSS}</style></head>
<body>
<h2>{title}</h2>
<p class="sub">{subtitle}</p>
{body}
<script>
{_JS_LIB}
{data_js}
{main_js}
</script>
</body></html>
"""
    with open(path, "w") as fh:
        fh.write(html)
    return path


# ----------------------------------------------------------------------
# BLS explorer (reference interact_bls.py:602-1004)
# ----------------------------------------------------------------------

_BLS_JS = r"""
// D.p is a sorted NON-UNIFORM period axis: the dense base grid merged
// with second-level fine grids around the top peaks, so zooming into a
// peak reveals ~an order of magnitude more resolution (the reference
// widget gets this by recomputing BLS server-side on every zoom,
// interact_bls.py:899-934; here it is precomputed on device).
const NP = D.p.length, P0 = D.p[0], P1 = D.p[NP - 1];
const period = i => D.p[i];
function lowerBound(x){               // first index with D.p[i] >= x
  let lo = 0, hi = NP;
  while (lo < hi){ const m = (lo + hi) >> 1;
    if (D.p[m] < x) lo = m + 1; else hi = m; }
  return lo;
}
let sel = D.best;                 // selected period index
let vx0 = P0, vx1 = P1;           // power-panel x view
const pp = mkplot(document.getElementById('power'));
const pf = mkplot(document.getElementById('folded'));
const pl = mkplot(document.getElementById('full'));

function drawPower(){
  pp.xmin = vx0; pp.xmax = vx1;
  let lo = Infinity, hi = -Infinity;
  const i0 = Math.max(0, lowerBound(vx0) - 1);
  const i1 = Math.min(NP-1, lowerBound(vx1));
  for (let i = i0; i <= i1; i++){
    const v = D.power[i];
    if (v !== null){ if (v < lo) lo = v; if (v > hi) hi = v; }
  }
  if (!isFinite(lo)){ lo = 0; hi = 1; }
  const m = 0.06*(hi-lo) || 1; pp.ymin = lo - m; pp.ymax = hi + m;
  pp.clear('period [d]', 'BLS power');
  const xs = [], ys = [];
  // decimate to <=2 samples/px with min/max pairs so peaks survive
  const W = pp.canvas.width, span = i1 - i0 + 1;
  const step = Math.max(1, Math.floor(span / W));
  for (let i = i0; i <= i1; i += step){
    let mn = Infinity, mx = -Infinity, imn = i, imx = i;
    for (let j = i; j < Math.min(i1+1, i+step); j++){
      const v = D.power[j]; if (v === null) continue;
      if (v < mn){ mn = v; imn = j; } if (v > mx){ mx = v; imx = j; }
    }
    if (!isFinite(mn)) { xs.push(null); ys.push(null); continue; }
    if (imn < imx){ xs.push(period(imn), period(imx)); ys.push(mn, mx); }
    else { xs.push(period(imx), period(imn)); ys.push(mx, mn); }
  }
  pp.line(xs, ys, '#3b5bdb');
  pp.vline(period(sel), '#e03131');
}
function drawFolded(){
  const P = period(sel), t0 = D.t0[sel], dur = D.dur[sel],
        dep = D.dep[sel];
  const ph = new Array(D.t.length);
  for (let i = 0; i < D.t.length; i++){
    let p = (D.t[i] - t0 + 0.5*P) % P; if (p < 0) p += P;
    ph[i] = p - 0.5*P;
  }
  pf.xmin = -0.5*P; pf.xmax = 0.5*P;
  const yl = ylimits(D.f); pf.ymin = yl[0]; pf.ymax = yl[1];
  pf.clear('phase [d]', 'normalized flux');
  pf.dots(ph, D.f, '#555', 1);
  // box model: out-of-transit baseline minus depth inside the box
  const fin = D.f.filter(v => v !== null).slice().sort((a,b)=>a-b);
  const base = fin.length ? fin[(fin.length-1)>>1] : 1;
  const hw = 0.5*dur;
  pf.line([-0.5*P, -hw, -hw, hw, hw, 0.5*P],
          [base, base, base-dep, base-dep, base, base], '#e03131');
}
function drawFull(){
  const P = period(sel), t0 = D.t0[sel], dur = D.dur[sel];
  pl.xmin = D.t[0]; pl.xmax = D.t[D.t.length-1];
  const yl = ylimits(D.f); pl.ymin = yl[0]; pl.ymax = yl[1];
  pl.clear('time [d]', 'normalized flux');
  const inT = i => {
    let p = (D.t[i] - t0 + 0.5*P) % P; if (p < 0) p += P;
    return Math.abs(p - 0.5*P) < 0.5*dur;
  };
  pl.dots(D.t, D.f, '#555', 1, i => !inT(i));
  pl.dots(D.t, D.f, '#e03131', 2, inT);
}
function readout(){
  document.getElementById('ro').textContent =
    'P = ' + fmt(period(sel)) + ' d    t0 = ' + fmt(D.t0[sel]) +
    '    duration = ' + fmt(D.dur[sel]) + ' d    depth = ' +
    fmt(D.dep[sel]) + '    power = ' + fmt(D.power[sel]);
}
function redraw(){ drawPower(); drawFolded(); drawFull(); readout(); }

const pc = document.getElementById('power');
pc.addEventListener('click', ev => {
  const r = pc.getBoundingClientRect();
  const x = vx0 + (ev.clientX - r.left - pp.P.l) /
            (pc.width - pp.P.l - pp.P.r) * (vx1 - vx0);
  // snap to the strongest peak within +-1% of the visible span
  const w = 0.01 * (vx1 - vx0);
  let best = -Infinity, bi = sel;
  for (let i = 0; i < NP; i++){
    const p = period(i);
    if (p < x - w || p > x + w) continue;
    const v = D.power[i];
    if (v !== null && v > best){ best = v; bi = i; }
  }
  if (isFinite(best)){ sel = bi; redraw(); }
});
pc.addEventListener('wheel', ev => {
  ev.preventDefault();
  const r = pc.getBoundingClientRect();
  const x = vx0 + (ev.clientX - r.left - pp.P.l) /
            (pc.width - pp.P.l - pp.P.r) * (vx1 - vx0);
  const z = ev.deltaY < 0 ? 0.8 : 1.25;
  vx0 = Math.max(P0, x - (x - vx0)*z);
  vx1 = Math.min(P1, x + (vx1 - x)*z);
  drawPower();
});
document.getElementById('reset').addEventListener('click', () => {
  vx0 = P0; vx1 = P1; sel = D.best; redraw();
});
redraw();
"""


def export_interact_bls_html(lc, path, minimum_period=None,
                             maximum_period=None, resolution=20000,
                             max_points=20000, durations=None,
                             refine_peaks=8, refine_factor=20):
    """Write a standalone interactive BLS explorer to ``path``.

    Live equivalent of the bokeh widget at reference
    ``interact_bls.py:602-1004``: three linked panels (BLS power,
    folded curve with the box model, full curve with in-transit
    cadences highlighted).  Clicking the power panel snap-selects the
    strongest nearby peak and re-folds instantly; the mouse wheel zooms.
    Where the reference *recomputes* BLS server-side on every zoom
    (``interact_bls.py:899-934``), this precomputes the whole
    interaction space on :data:`config.default_device` (the card unless
    the caller sets the CPU; the grids' ``to_periodogram(method="bls")``
    calls run there in :data:`config.default_dtype`): one dense base grid (default 20 000
    trial periods — 10× the reference widget's server-side resolution)
    PLUS second-level fine grids around the ``refine_peaks`` strongest
    peaks at ``refine_factor``× the base resolution, merged into one
    sorted period axis — zooming into a peak reveals the refined
    structure with zero round-trips, matching the reference's
    recompute-on-zoom capability.

    Returns the path written.
    """
    from .interact import _preprocess_lc_for_bls
    lc = _preprocess_lc_for_bls(lc)
    tv = _host(lc.time)
    fv = _host(lc.flux)
    dt = float(np.median(np.diff(tv)))
    if minimum_period is None:
        minimum_period = max(4 * dt, 0.33 + dt)
    if maximum_period is None:
        maximum_period = (tv.max() - tv.min()) / 3.0
    if maximum_period <= minimum_period:
        raise LightkurveError("baseline too short for a BLS explorer")
    periods = np.linspace(float(minimum_period), float(maximum_period),
                          int(resolution))
    kw = {}
    if durations is not None:
        kw["duration"] = durations
    pg = lc.to_periodogram(method="bls", period=periods, **kw)

    def _cols(pgi):
        return (_host(pgi.power), _host(pgi.transit_time),
                _host(pgi.duration), _host(pgi.depth))

    power, t0, dur, dep = _cols(pg)

    # second-level refine: fine grids (refine_factor x denser) around the
    # strongest well-separated peaks, merged into one sorted axis
    if refine_peaks and refine_factor > 1 and periods.size > 2:
        spacing = float(periods[1] - periods[0])
        halfw = 40.0 * spacing
        order = np.argsort(np.nan_to_num(power, nan=-np.inf))[::-1]
        centers = []
        for i in order[: 50 * max(int(refine_peaks), 1)]:
            p = float(periods[i])
            if all(abs(p - c) > 2 * halfw for c in centers):
                centers.append(p)
            if len(centers) >= int(refine_peaks):
                break
        fine = np.concatenate([
            np.linspace(max(periods[0], c - halfw),
                        min(periods[-1], c + halfw),
                        int(80 * refine_factor)) for c in centers]) \
            if centers else np.empty(0)
        if fine.size:
            pg_f = lc.to_periodogram(method="bls",
                                     period=np.unique(fine), **kw)
            pw_f, t0_f, dur_f, dep_f = _cols(pg_f)
            merged = np.concatenate([periods, np.unique(fine)])
            srt = np.argsort(merged, kind="stable")
            periods = merged[srt]
            power = np.concatenate([power, pw_f])[srt]
            t0 = np.concatenate([t0, t0_f])[srt]
            dur = np.concatenate([dur, dur_f])[srt]
            dep = np.concatenate([dep, dep_f])[srt]
    best = int(np.nanargmax(power))

    keep = _decimate(tv.size, max_points)
    data_js = (
        "const D = {"
        f"best:{best},p:{_js_array(periods, 9)},"
        f"power:{_js_array(power)},t0:{_js_array(t0, 9)},"
        f"dur:{_js_array(dur)},dep:{_js_array(dep)},"
        f"t:{_js_array(tv[keep], 10)},f:{_js_array(fv[keep])}"
        "};")
    label = str(lc.meta.get("LABEL") or lc.meta.get("OBJECT") or "light curve")
    body = """
<div class="readout" id="ro"></div>
<canvas id="power" width="940" height="230"></canvas>
<p class="hint">click = snap-select strongest nearby peak &middot;
wheel = zoom &middot; <button id="reset">reset</button></p>
<canvas id="folded" width="940" height="230"></canvas>
<canvas id="full" width="940" height="230"></canvas>
"""
    return _page(f"BLS explorer — {label}",
                 f"{periods.size} trial periods precomputed on device "
                 "(dense base grid + zoom-refined peak neighborhoods); "
                 "all interaction is client-side.",
                 body, data_js, _BLS_JS, path)


# ----------------------------------------------------------------------
# Pixel selector (reference interact.py:999-1318)
# ----------------------------------------------------------------------

_TPF_JS = r"""
const R = D.shape[0], C = D.shape[1], T = D.t.length;
let mask = D.init.slice();
const img = document.getElementById('img');
const ictx = img.getContext('2d');
const cell = Math.min(36, Math.floor(360 / Math.max(R, C)));
img.width = C * cell + 1; img.height = R * cell + 1;
const plc = mkplot(document.getElementById('lc'));

function stretch(v){
  if (v === null) return 0;
  const lo = D.imglo, hi = D.imghi;
  const x = Math.max(0, Math.min(1, (v - lo) / (hi - lo || 1)));
  return Math.sqrt(x);
}
// frame slider: -1 = median image, k = cadence k (the reference widget
// steps through cadences the same way, interact.py:999-1080)
const frame = document.getElementById('frame');
frame.max = T - 1;
function pixval(r, c){
  const k = parseInt(frame.value);
  return k < 0 ? D.img[r*C + c] : D.pix[r*C + c][k];
}
function frameLabel(){
  const k = parseInt(frame.value);
  document.getElementById('flab').textContent =
    k < 0 ? 'median frame' : ('cadence ' + k + '  t=' + fmt(D.t[k]));
}
function drawImg(){
  ictx.clearRect(0, 0, img.width, img.height);
  for (let r = 0; r < R; r++){
    for (let c = 0; c < C; c++){
      const s = stretch(pixval(r, c));
      const g = Math.round(245 - 190*s);
      ictx.fillStyle = 'rgb(' + g + ',' + g + ',' + Math.min(255,g+10) + ')';
      // row 0 at the bottom, like tpf.plot()
      ictx.fillRect(c*cell, (R-1-r)*cell, cell-1, cell-1);
      if (mask[r*C + c]){
        ictx.strokeStyle = '#e03131'; ictx.lineWidth = 2;
        ictx.strokeRect(c*cell+1.5, (R-1-r)*cell+1.5, cell-4, cell-4);
      }
    }
  }
}
function drawLC(){
  const n = mask.reduce((a,b)=>a+b, 0);
  const f = new Array(T);
  for (let i = 0; i < T; i++){
    let s = 0, any = false;
    for (let p = 0; p < R*C; p++){
      if (!mask[p]) continue;
      const v = D.pix[p][i];
      if (v !== null){ s += v; any = true; }
    }
    f[i] = (n > 0 && any) ? s : null;
  }
  plc.xmin = D.t[0]; plc.xmax = D.t[T-1];
  const yl = ylimits(f); plc.ymin = yl[0]; plc.ymax = yl[1];
  plc.clear('time [d]', 'SAP flux [' + D.unit + ']');
  plc.dots(D.t, f, '#3b5bdb', 1.5);
  document.getElementById('ro').textContent =
    'aperture: ' + n + ' px' + (n ? '' : ' (select pixels)');
  return f;
}
img.addEventListener('click', ev => {
  const rect = img.getBoundingClientRect();
  const c = Math.floor((ev.clientX - rect.left) / cell);
  const rr = R - 1 - Math.floor((ev.clientY - rect.top) / cell);
  if (c < 0 || c >= C || rr < 0 || rr >= R) return;
  mask[rr*C + c] = mask[rr*C + c] ? 0 : 1;
  drawImg(); drawLC();
});
for (const [id, src] of [['pipeline', D.pipeline],
                         ['threshold', D.threshold]]){
  const b = document.getElementById(id);
  if (src) b.addEventListener('click', () => {
    mask = src.slice(); drawImg(); drawLC(); });
  else b.disabled = true;
}
document.getElementById('all').addEventListener('click', () => {
  mask = mask.map(() => 1); drawImg(); drawLC(); });
document.getElementById('none').addEventListener('click', () => {
  mask = mask.map(() => 0); drawImg(); drawLC(); });
frame.addEventListener('input', () => { frameLabel(); drawImg(); });
frameLabel();
document.getElementById('export').addEventListener('click', () => {
  const out = {target: D.label, shape: D.shape,
               aperture_mask: Array.from({length: R}, (_, r) =>
                 mask.slice(r*C, (r+1)*C)),
               time: D.t, sap_flux: drawLC()};
  const a = document.createElement('a');
  a.href = 'data:application/json,' +
           encodeURIComponent(JSON.stringify(out));
  a.download = 'custom-aperture.json';
  a.click();
});
drawImg(); drawLC();
"""


def export_interact_html(tpf, path, aperture_mask="default",
                         max_cadences=3000):
    """Write a standalone interactive pixel-selector widget to ``path``.

    Live equivalent of the bokeh widget at reference
    ``interact.py:999-1318``: click pixels on the median frame to edit
    the aperture and the SAP light-curve preview re-sums instantly;
    buttons restore the pipeline/threshold masks and an export button
    downloads the selection (mask + SAP flux) as JSON — the analogue of
    the widget's FITS-export button (reference ``interact.py:1096-1130``).
    Every pixel's light curve is embedded from one pass over the cube
    (bin-averaged to ``max_cadences`` when longer).

    Returns the path written.
    """
    mask = tpf._parse_aperture_mask(aperture_mask)
    if not mask.any():
        mask = tpf.create_threshold_mask()
    if not mask.any():
        mask = tpf._parse_aperture_mask("all")

    tv = _host(tpf.time)
    cube = _host(tpf.flux)
    tv, cube = _bin_cube(tv, cube, int(max_cadences))
    R, C = cube.shape[1], cube.shape[2]
    with np.errstate(invalid="ignore", all="ignore"):
        img = np.nanmedian(cube, axis=0)
    finite = img[np.isfinite(img)]
    lo, hi = (np.percentile(finite, (1, 99)) if finite.size else (0.0, 1.0))

    pix_rows = ",".join(_js_array(cube[:, r, c])
                        for r in range(R) for c in range(C))
    try:
        pipe = tpf.pipeline_mask
        pipe = np.asarray(pipe, bool) if pipe is not None else None
        # an absent or empty pipeline aperture disables the button
        pipe_js = json.dumps([int(v) for v in pipe.ravel().tolist()]) \
            if pipe is not None and pipe.shape == (R, C) and pipe.any() \
            else "null"
    except Exception:
        pipe_js = "null"
    try:
        thr = tpf.create_threshold_mask()
        thr_js = json.dumps([int(v) for v in thr.ravel().tolist()])
    except Exception:
        thr_js = "null"

    label = str(tpf.meta.get("OBJECT") or getattr(tpf, "targetid", "") or "TPF")
    unit = str(getattr(tpf.flux, "unit", "") or "e-/s")
    data_js = (
        "const D = {"
        f"shape:[{R},{C}],t:{_js_array(tv, 10)},"
        f"pix:[{pix_rows}],img:{_js_array(img)},"
        f"imglo:{float(lo)!r},imghi:{float(hi)!r},"
        f"init:{json.dumps([int(v) for v in mask.ravel().tolist()])},"
        f"pipeline:{pipe_js},threshold:{thr_js},"
        f"label:{json.dumps(label)},unit:{json.dumps(unit)}"
        "};")
    body = """
<div>
<button id="pipeline">pipeline</button>
<button id="threshold">threshold</button>
<button id="all">all</button>
<button id="none">none</button>
<button id="export">download selection</button>
</div>
<canvas id="img"></canvas>
<div>frame: <input type="range" id="frame" min="-1" max="1" step="1"
     value="-1"> <span class="hint" id="flab"></span></div>
<div class="readout" id="ro"></div>
<canvas id="lc" width="940" height="260"></canvas>
<p class="hint">click pixels to toggle them in the aperture; the SAP
preview re-sums live.</p>
"""
    return _page(f"Pixel selector — {label}",
                 f"{R}×{C} pixels × {tv.size} cadences embedded; "
                 "aperture edits re-photometer client-side.",
                 body, data_js, _TPF_JS, path)


# ----------------------------------------------------------------------
# Echelle explorer (reference seismology/core.py:502-640)
# ----------------------------------------------------------------------

_ECH_JS = r"""
const cv = document.getElementById('ech');
const ctx = cv.getContext('2d');
const W = 360;                       // columns per echelle row
const slider = document.getElementById('dnu');
const ro = document.getElementById('ro');
function powerAt(f){
  const i = Math.round((f - D.f0) / D.df);
  return (i >= 0 && i < D.p.length && D.p[i] !== null) ? D.p[i] : 0;
}
function draw(){
  const dnu = parseFloat(slider.value);
  const n = Math.max(1, Math.floor((D.fmax - D.fmin) / dnu));
  const ch = Math.max(2, Math.min(24, Math.floor(420 / n)));
  cv.width = W + 70; cv.height = n * ch + 40;
  const vals = new Float64Array(n * W);
  let lo = Infinity, hi = -Infinity;
  for (let r = 0; r < n; r++){
    for (let c = 0; c < W; c++){
      const v = powerAt(D.fmin + (r + c / W) * dnu);
      vals[r*W + c] = v;
      if (v < lo) lo = v; if (v > hi) hi = v;
    }
  }
  ctx.clearRect(0, 0, cv.width, cv.height);
  for (let r = 0; r < n; r++){
    for (let c = 0; c < W; c++){
      const x = (vals[r*W + c] - lo) / (hi - lo || 1);
      const s = Math.sqrt(x);
      const g = Math.round(250 - 215*s);
      ctx.fillStyle = 'rgb(' + g + ',' + g + ',255)';
      ctx.fillRect(54 + c, cv.height - 30 - (r+1)*ch, 1, ch);
    }
  }
  ctx.strokeStyle = '#999';
  ctx.strokeRect(54, cv.height - 30 - n*ch, W, n*ch);
  ctx.fillStyle = '#444'; ctx.font = '11px system-ui';
  ctx.textAlign = 'center';
  ctx.fillText('frequency mod ' + fmt(dnu) + ' [' + D.unit + ']',
               54 + W/2, cv.height - 8);
  ctx.textAlign = 'right';
  ctx.fillText(fmt(D.fmin), 50, cv.height - 30);
  ctx.fillText(fmt(D.fmin + n*dnu), 50, cv.height - 26 - n*ch + 8);
  ro.textContent = 'Δν = ' + fmt(dnu) + ' ' + D.unit +
                   '   (' + n + ' orders)';
}
slider.addEventListener('input', draw);
draw();
"""


def export_interact_echelle_html(seismology, path, deltanu=None, numax=None,
                                 minimum_frequency=None,
                                 maximum_frequency=None,
                                 smooth_filter_width=0.1):
    """Write a standalone echelle explorer with a live Δν slider.

    Live equivalent of the bokeh widget at reference
    ``seismology/core.py:502-640``: the power spectrum is embedded once
    and the browser re-folds it at the slider's Δν on a canvas.  The
    slider spans 0.01 → max_frequency/5 like the reference's
    (``core.py:585-596``), centred on the estimated Δν.

    Returns the path written.
    """
    from .units import Quantity
    from .seismology.utils import get_fwhm

    deltanu = seismology._validate_deltanu(deltanu)
    funit = seismology.periodogram.frequency.unit
    dnu0 = float(Quantity(deltanu, funit).value)
    pg = (seismology.periodogram.smooth(filter_width=smooth_filter_width)
          if smooth_filter_width else seismology.periodogram)
    freq = _host(pg.frequency)
    power = _host(pg.power)
    fmin, fmax = float(freq[0]), float(freq[-1])
    if numax is not None and minimum_frequency is None \
            and maximum_frequency is None:
        numax_v = float(Quantity(numax, funit).value)
        fwhm = get_fwhm(seismology.periodogram, numax_v)
        fmin = max(numax_v - 2 * fwhm, fmin)
        fmax = min(numax_v + 2 * fwhm, fmax)
    if minimum_frequency is not None:
        fmin = float(Quantity(minimum_frequency, funit).value)
    if maximum_frequency is not None:
        fmax = float(Quantity(maximum_frequency, funit).value)
    df = float(np.median(np.diff(freq)))
    # reference slider bounds (core.py:585-596): 0.01 .. max_frequency/5
    # (lower bound additionally clamped so the fold never asks the canvas
    # for more than ~600 order rows)
    smin, smax = max(0.01, (fmax - fmin) / 600.0), fmax / 5.0
    dnu0 = min(max(dnu0, smin), smax)

    data_js = (
        "const D = {"
        f"f0:{float(freq[0])!r},df:{df!r},p:{_js_array(power)},"
        f"fmin:{fmin!r},fmax:{fmax!r},unit:{json.dumps(str(funit))}"
        "};")
    body = f"""
<div class="readout" id="ro"></div>
<div>Δν: <input type="range" id="dnu" min="{smin}" max="{smax}"
     step="{(smax - smin) / 2000}" value="{dnu0}"></div>
<canvas id="ech"></canvas>
<p class="hint">drag the slider — the spectrum re-folds client-side.</p>
"""
    return _page("Echelle explorer",
                 f"{freq.size} frequency bins embedded; fold runs in JS.",
                 body, data_js, _ECH_JS, path)


# ----------------------------------------------------------------------
# Sky view (reference interact.py:1319-1480 — offline-catalog variant)
# ----------------------------------------------------------------------

_SKY_JS = r"""
const R = D.shape[0], C = D.shape[1];
const cv = document.getElementById('sky');
const ctx = cv.getContext('2d');
const cell = Math.min(56, Math.floor(560 / Math.max(R, C)));
cv.width = C * cell + 1; cv.height = R * cell + 1;
const tip = document.getElementById('tip');
const stretch = document.getElementById('stretch');
let selected = -1;

function draw(){
  const gain = parseFloat(stretch.value);
  ctx.clearRect(0, 0, cv.width, cv.height);
  for (let r = 0; r < R; r++){
    for (let c = 0; c < C; c++){
      const v = D.img[r*C + c];
      let s = 0;
      if (v !== null){
        const x = Math.max(0, Math.min(1, (v - D.imglo)/(D.imghi - D.imglo || 1)));
        s = Math.pow(x, 1.0/gain);
      }
      const g = Math.round(248 - 200*s);
      ctx.fillStyle = 'rgb(' + g + ',' + g + ',' + Math.min(255, g+8) + ')';
      ctx.fillRect(c*cell, (R-1-r)*cell, cell-1, cell-1);
      if (D.aper && D.aper[r*C + c]){
        ctx.strokeStyle = 'rgba(224,49,49,0.7)'; ctx.lineWidth = 1.5;
        ctx.strokeRect(c*cell+1, (R-1-r)*cell+1, cell-3, cell-3);
      }
    }
  }
  // catalog sources: circle area scales with brightness, like the
  // reference's Gaia overlay size rule
  for (let i = 0; i < D.src.length; i++){
    const s = D.src[i];
    const x = (s.col + 0.5) * cell, y = (R - 1 - s.row + 0.5) * cell;
    ctx.beginPath();
    ctx.arc(x, y, s.r * cell * 0.18 + 2, 0, 2*Math.PI);
    ctx.strokeStyle = i === selected ? '#e8590c' : '#1971c2';
    ctx.lineWidth = i === selected ? 2.5 : 1.5;
    ctx.stroke();
  }
}
function nearest(ev){
  const rect = cv.getBoundingClientRect();
  const mx = ev.clientX - rect.left, my = ev.clientY - rect.top;
  let best = 1e9, bi = -1;
  for (let i = 0; i < D.src.length; i++){
    const s = D.src[i];
    const x = (s.col + 0.5) * cell, y = (R - 1 - s.row + 0.5) * cell;
    const d = Math.hypot(mx - x, my - y);
    if (d < best){ best = d; bi = i; }
  }
  return best < Math.max(14, cell*0.6) ? bi : -1;
}
cv.addEventListener('mousemove', ev => {
  const i = nearest(ev);
  if (i < 0){ tip.style.display = 'none'; return; }
  const s = D.src[i];
  tip.style.display = 'block';
  tip.style.left = (ev.pageX + 12) + 'px';
  tip.style.top = (ev.pageY + 12) + 'px';
  tip.innerHTML = (s.id ? ('<b>' + s.id + '</b><br>') : '') +
    'RA ' + fmt(s.ra) + '&deg;  Dec ' + fmt(s.dec) + '&deg;<br>' +
    (s.mag !== null ? ('mag ' + fmt(s.mag) + '<br>') : '') +
    'pixel (' + fmt(s.col) + ', ' + fmt(s.row) + ')' +
    (D.pm ? '<br><i>proper-motion corrected</i>' : '');
});
cv.addEventListener('mouseleave', () => { tip.style.display = 'none'; });
cv.addEventListener('click', ev => { selected = nearest(ev); draw();
  const s = selected >= 0 ? D.src[selected] : null;
  document.getElementById('ro').textContent = s ?
    ('selected: ' + (s.id || 'source ' + selected) + '  mag ' +
     (s.mag === null ? '?' : fmt(s.mag))) : '';
});
stretch.addEventListener('input', draw);
draw();
"""


def export_interact_sky_html(tpf, path, catalog=None, magnitude_limit=18.0,
                             aperture_mask="empty", catalog_epoch=2016.0,
                             tic_catalog=None):
    """Write a standalone sky-view widget over the TPF to ``path``.

    Offline-catalog variant of the reference's Gaia widget
    (``interact.py:1319-1480``): instead of querying the Gaia archive
    (no network here), the caller supplies ``catalog`` — a dict
    of arrays (or list of row dicts) with keys ``ra``/``dec`` (deg) and
    optionally ``mag``/``gmag``, ``id``/``source_id``, ``pmra``/``pmdec``
    (mas/yr).  Sources are proper-motion propagated from
    ``catalog_epoch`` (Julian year; Gaia DR2/DR3 ≈ 2015.5/2016.0) to the
    TPF's first cadence — linearly, the same small-angle approximation
    the reference applies via ``apply_space_motion``
    (``interact.py:91-120``) — then projected onto pixels with the TPF's
    own tangent-plane WCS.  The widget shows the median frame with a
    stretch slider, magnitude-scaled source circles, hover tooltips and
    click-to-select — all client-side.

    Returns the path written.
    """
    if not getattr(tpf, "has_wcs", True):
        # reference add_gaia_figure_elements raises here too
        # (test_interact_sky_functions_case_no_target_coordinate)
        raise LightkurveError(
            "Cannot render a sky overlay: the TPF carries no valid "
            "coordinate system (no tabular WCS keywords).")
    cube = _host(tpf.flux)
    R, C = cube.shape[1], cube.shape[2]
    with np.errstate(invalid="ignore", all="ignore"):
        img = np.nanmedian(cube, axis=0)
    finite = img[np.isfinite(img)]
    lo, hi = (np.percentile(finite, (1, 99)) if finite.size else (0.0, 1.0))

    # normalize the catalog to column arrays
    if catalog is None:
        catalog = {}
    if isinstance(catalog, (str, os.PathLike)):
        # a locally-saved catalog file (e.g. a Gaia archive cone-search
        # export): .json = dict of columns / list of rows; .csv = header
        # row of column names then numeric rows
        cpath = os.fspath(catalog)
        if cpath.lower().endswith(".json"):
            with open(cpath) as f:
                catalog = json.load(f)
        else:
            import csv
            with open(cpath, newline="") as f:
                rows = list(csv.DictReader(f))
            catalog = rows
    if isinstance(catalog, (list, tuple)):
        cols = {}
        for row in catalog:
            for k, v in dict(row).items():
                cols.setdefault(k, []).append(v)
        catalog = cols
    if tic_catalog:
        # merge a nearby-TIC report (reference _add_nearby_tics_if_tess);
        # a failing report degrades to a warning, never an exception —
        # the widget still renders with the Gaia-only catalog (reference
        # test_interact_sky_functions_case_nearby_tics_failed)
        import warnings as _warnings
        try:
            from .interact import merge_nearby_tics
            catalog, _, _ = merge_nearby_tics(catalog, tic_catalog)
        except Exception as exc:
            _warnings.warn(
                f"nearby-TIC catalog merge failed ({exc}); continuing "
                "without TIC annotations", LightkurveWarning)
    get = {k.lower(): np.atleast_1d(np.asarray(v))
           for k, v in dict(catalog).items()}
    ra = np.asarray(get.get("ra", []), dtype=float)
    dec = np.asarray(get.get("dec", []), dtype=float)
    n = ra.size
    mag = np.asarray(get.get("mag", get.get("gmag",
                     np.full(n, np.nan))), dtype=float)
    ids = get.get("id", get.get("source_id", np.array([""] * n)))
    pmra = np.asarray(get.get("pmra", np.zeros(n)), dtype=float)
    pmdec = np.asarray(get.get("pmdec", np.zeros(n)), dtype=float)

    # proper-motion propagation to the observation epoch (linear; the
    # reference uses SkyCoord.apply_space_motion, interact.py:91-120)
    pm_applied = bool(n and (np.any(pmra != 0) or np.any(pmdec != 0)))
    if pm_applied:
        t0_jd = float(np.atleast_1d(tpf.time.jd)[0])
        dt_yr = (t0_jd - 1721045.0) / 365.25 - float(catalog_epoch)
        dec_r = np.deg2rad(dec)
        ra = ra + np.nan_to_num(pmra) * dt_yr / 3.6e6 / \
            np.maximum(np.cos(dec_r), 1e-6)
        dec = dec + np.nan_to_num(pmdec) * dt_yr / 3.6e6

    # project through the TPF's own WCS; keep sources on (or just off)
    # the postage stamp and above the magnitude limit
    if n:
        col, row = tpf.wcs.world_to_pixel(ra, dec, origin=0)
        keep = ((col > -1.5) & (col < C + 0.5) & (row > -1.5)
                & (row < R + 0.5)
                & (np.isnan(mag) | (mag <= float(magnitude_limit))))
    else:
        col = row = keep = np.array([], dtype=float)

    srcs = []
    for i in np.flatnonzero(keep):
        m = None if not math.isfinite(mag[i]) else round(float(mag[i]), 3)
        # circle size grows toward bright sources, like the reference's
        # 1/2**(gmag/5) scaling (interact.py add_gaia_figure_elements)
        rsize = 2.0 ** ((float(magnitude_limit) -
                         (mag[i] if math.isfinite(mag[i]) else
                          float(magnitude_limit))) / 5.0)
        srcs.append({"ra": round(float(ra[i]), 7),
                     "dec": round(float(dec[i]), 7),
                     "col": round(float(col[i]), 3),
                     "row": round(float(row[i]), 3),
                     "mag": m, "r": round(min(float(rsize), 12.0), 3),
                     "id": str(ids[i]) if i < len(ids) else ""})

    try:
        aper = tpf._parse_aperture_mask(aperture_mask)
        aper_js = json.dumps([int(v) for v in aper.ravel().tolist()]) \
            if aper.any() else "null"
    except Exception:
        aper_js = "null"

    label = str(tpf.meta.get("OBJECT") or getattr(tpf, "targetid", "")
                or "TPF")
    data_js = (
        "const D = {"
        f"shape:[{R},{C}],img:{_js_array(img)},"
        f"imglo:{float(lo)!r},imghi:{float(hi)!r},"
        f"src:{json.dumps(srcs, separators=(',', ':'))},"
        f"aper:{aper_js},pm:{json.dumps(pm_applied)}"
        "};")
    body = """
<div class="readout" id="ro"></div>
<div>stretch: <input type="range" id="stretch" min="0.3" max="4"
     step="0.05" value="1"></div>
<canvas id="sky"></canvas>
<div id="tip" style="display:none;position:absolute;background:#fff;
     border:1px solid #999;border-radius:4px;padding:4px 8px;
     font-size:12px;pointer-events:none;box-shadow:0 1px 4px #0003"></div>
<p class="hint">hover a circle for source details; click to select.</p>
"""
    return _page(f"Sky view — {label}",
                 f"{len(srcs)} catalog sources projected through the TPF "
                 "WCS (offline catalog; no Gaia query).",
                 body, data_js, _SKY_JS, path)
