# A copy of clibd_tpu/analysis/interactive.py, which imports no jax: the port keeps its own copy
# so that it imports nothing of the JAX package.  Keep the two in step.
"""Self-contained interactive embedding scatter (HTML + vanilla-JS canvas).

The reference writes plotly HTML embedding plots
(scripts/inference_and_eval.py:98-220).  plotly is not a dependency here;
this writer emits ONE portable HTML file (data embedded as JSON, zero
external assets, no network) with the interactions that matter for
embedding inspection: pan (drag), zoom (wheel, cursor-centered), hover
tooltip with the full 4-level taxonomy, color-by-level dropdown, and
per-modality visibility toggles."""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

LEVELS = ("order", "family", "genus", "species")

_PAGE = """<!doctype html><html><head><meta charset="utf-8">
<title>{title}</title>
<style>
 body {{ font-family: system-ui, sans-serif; margin: 12px; background: #fff; }}
 #bar {{ margin-bottom: 8px; }}
 #bar label {{ margin-right: 12px; font-size: 13px; }}
 #wrap {{ position: relative; display: inline-block; }}
 canvas {{ border: 1px solid #ccc; cursor: grab; }}
 #tip {{ position: absolute; pointer-events: none; background: rgba(20,20,20,.92);
        color: #fff; padding: 4px 7px; border-radius: 4px; font-size: 12px;
        display: none; white-space: pre; z-index: 2; }}
 #legend {{ display: inline-block; vertical-align: top; margin-left: 14px;
           font-size: 12px; max-height: 640px; overflow-y: auto; }}
 .sw {{ display: inline-block; width: 10px; height: 10px; margin-right: 5px;
       border-radius: 2px; }}
</style></head><body>
<h3>{title}</h3>
<div id="bar">
 <label>color by <select id="level">{level_options}</select></label>
 {modality_toggles}
 <label><button id="reset">reset view</button></label>
</div>
<div id="wrap"><canvas id="c" width="840" height="640"></canvas><div id="tip"></div></div>
<div id="legend"></div>
<script>
const DATA = {data_json};
const MARKER = {{image: "circle", dna: "triangle", text: "square"}};
const PALETTE = ["#4e79a7","#f28e2b","#e15759","#76b7b2","#59a14f","#edc948",
                 "#b07aa1","#ff9da7","#9c755f","#bab0ac","#1b9e77","#d95f02"];
const cv = document.getElementById("c"), ctx = cv.getContext("2d");
const tip = document.getElementById("tip");
let level = "order";
let view = null;           // {{x0, y0, x1, y1}} in data coords
let visible = {{}};
DATA.modalities.forEach(m => visible[m] = true);

function dataBounds() {{
  let x0=Infinity,y0=Infinity,x1=-Infinity,y1=-Infinity;
  for (const p of DATA.points) {{
    if (p.x<x0) x0=p.x; if (p.x>x1) x1=p.x;
    if (p.y<y0) y0=p.y; if (p.y>y1) y1=p.y;
  }}
  const mx=(x1-x0)*0.04||1, my=(y1-y0)*0.04||1;
  return {{x0:x0-mx, y0:y0-my, x1:x1+mx, y1:y1+my}};
}}
function resetView() {{ view = dataBounds(); draw(); }}

function colorMap() {{
  const counts = {{}};
  for (const p of DATA.points) counts[p[level]] = (counts[p[level]]||0)+1;
  const classes = Object.keys(counts).sort((a,b)=>counts[b]-counts[a]);
  const cmap = {{}};
  classes.forEach((c,i) => cmap[c] = i < PALETTE.length ? PALETTE[i] : "#d0d0d0");
  return {{cmap, classes, counts}};
}}
function toPx(p) {{
  return [ (p.x-view.x0)/(view.x1-view.x0)*cv.width,
           cv.height - (p.y-view.y0)/(view.y1-view.y0)*cv.height ];
}}
function drawMark(x, y, m, color) {{
  ctx.fillStyle = color;
  ctx.beginPath();
  if (m === "triangle") {{ ctx.moveTo(x,y-3.6); ctx.lineTo(x-3.2,y+2.6); ctx.lineTo(x+3.2,y+2.6); }}
  else if (m === "square") {{ ctx.rect(x-2.6,y-2.6,5.2,5.2); }}
  else ctx.arc(x, y, 2.8, 0, 6.2832);
  ctx.fill();
}}
function draw() {{
  const {{cmap, classes, counts}} = colorMap();
  ctx.clearRect(0,0,cv.width,cv.height);
  ctx.globalAlpha = 0.78;
  for (const p of DATA.points) {{
    if (!visible[p.m]) continue;
    const [x,y] = toPx(p);
    if (x<-4||y<-4||x>cv.width+4||y>cv.height+4) continue;
    drawMark(x, y, MARKER[p.m], cmap[p[level]]);
  }}
  ctx.globalAlpha = 1;
  const lg = document.getElementById("legend");
  lg.innerHTML = "<b>" + level + "</b><br>" + classes.slice(0, PALETTE.length)
    .map(c => `<span class="sw" style="background:${{cmap[c]}}"></span>${{c}} (${{counts[c]}})`)
    .join("<br>") + (classes.length > PALETTE.length ?
      `<br><span class="sw" style="background:#d0d0d0"></span>other (${{classes.length-PALETTE.length}} classes)` : "");
}}
document.getElementById("level").onchange = e => {{ level = e.target.value; draw(); }};
DATA.modalities.forEach(m => {{
  const el = document.getElementById("m_"+m);
  if (el) el.onchange = e => {{ visible[m] = e.target.checked; draw(); }};
}});
document.getElementById("reset").onclick = resetView;

let drag = null;
cv.onmousedown = e => {{ drag = [e.offsetX, e.offsetY]; cv.style.cursor="grabbing"; }};
window.onmouseup = () => {{ drag = null; cv.style.cursor="grab"; }};
cv.onmousemove = e => {{
  if (drag) {{
    const dx = (e.offsetX-drag[0])/cv.width*(view.x1-view.x0);
    const dy = (e.offsetY-drag[1])/cv.height*(view.y1-view.y0);
    view.x0-=dx; view.x1-=dx; view.y0+=dy; view.y1+=dy;
    drag = [e.offsetX, e.offsetY]; tip.style.display="none"; draw(); return;
  }}
  let best = null, bd = 81;
  for (const p of DATA.points) {{
    if (!visible[p.m]) continue;
    const [x,y] = toPx(p);
    const d = (x-e.offsetX)**2 + (y-e.offsetY)**2;
    if (d < bd) {{ bd = d; best = p; }}
  }}
  if (best) {{
    tip.textContent = `${{best.m}}\\norder: ${{best.order}}\\nfamily: ${{best.family}}\\ngenus: ${{best.genus}}\\nspecies: ${{best.species}}`;
    tip.style.left = (e.offsetX+14)+"px"; tip.style.top = (e.offsetY+8)+"px";
    tip.style.display = "block";
  }} else tip.style.display = "none";
}};
cv.onwheel = e => {{
  e.preventDefault();
  const f = e.deltaY > 0 ? 1.15 : 1/1.15;
  const mx = view.x0 + e.offsetX/cv.width*(view.x1-view.x0);
  const my = view.y0 + (cv.height-e.offsetY)/cv.height*(view.y1-view.y0);
  view.x0 = mx + (view.x0-mx)*f; view.x1 = mx + (view.x1-mx)*f;
  view.y0 = my + (view.y0-my)*f; view.y1 = my + (view.y1-my)*f;
  draw();
}};
resetView();
</script></body></html>
"""


def write_interactive_embedding_plot(
    path: str,
    pieces: Dict[str, np.ndarray],
    gt_labels: List[dict],
    lang_inverse: Optional[np.ndarray] = None,
    title: str = "CLIBD embeddings",
    max_points: int = 20000,
    seed: int = 0,
) -> str:
    """pieces: {modality: [N, 2] projected coords} where image/dna rows align
    with gt_labels and 'text' holds unique rows indexed by lang_inverse.
    → the written HTML path."""
    n = len(gt_labels)
    rng = np.random.default_rng(seed)
    keep = np.arange(n)
    per_mod_budget = max_points // max(len(pieces), 1)
    if n > per_mod_budget:
        keep = np.sort(rng.choice(n, per_mod_budget, replace=False))

    points = []
    for name, xy in pieces.items():
        if xy is None:
            continue
        for i in keep:
            row = xy[lang_inverse[i]] if (name == "text" and lang_inverse is not None) else xy[i]
            lab = gt_labels[i]
            points.append({
                "m": name,
                "x": round(float(row[0]), 4), "y": round(float(row[1]), 4),
                **{lv: lab[lv] for lv in LEVELS},
            })

    modalities = [m for m in ("image", "dna", "text") if m in pieces and pieces[m] is not None]
    data_json = json.dumps({"points": points, "modalities": modalities})
    level_options = "".join(
        f'<option value="{lv}"{" selected" if lv == "order" else ""}>{lv}</option>'
        for lv in LEVELS)
    modality_toggles = "".join(
        f'<label><input type="checkbox" id="m_{m}" checked> {m}</label>'
        for m in modalities)
    html_out = _PAGE.format(title=title, data_json=data_json,
                            level_options=level_options,
                            modality_toggles=modality_toggles)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(html_out)
    return path
