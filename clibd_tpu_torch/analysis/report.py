# A copy of clibd_tpu/analysis/report.py, which imports no jax: the port keeps its own copy
# so that it imports nothing of the JAX package.  Keep the two in step.
"""Self-contained HTML report assembly (the reference publishes plotly HTML
into `html_plots/`, inference_and_eval.py:98-220; this framework embeds its
matplotlib PNGs + tables into one dependency-free HTML file)."""

from __future__ import annotations

import base64
import html
import os
from typing import Dict, List, Optional, Sequence


def _img_tag(png_path: str, max_width: int = 1100) -> str:
    with open(png_path, "rb") as f:
        b64 = base64.b64encode(f.read()).decode("ascii")
    return (f'<img src="data:image/png;base64,{b64}" '
            f'style="max-width:{max_width}px;width:100%" />')


def _table(rows: List[Sequence], header: bool = True) -> str:
    out = ["<table>"]
    for i, row in enumerate(rows):
        tag = "th" if (header and i == 0) else "td"
        cells = "".join(f"<{tag}>{html.escape(str(v))}</{tag}>" for v in row)
        out.append(f"<tr>{cells}</tr>")
    out.append("</table>")
    return "".join(out)


_STYLE = """
body { font-family: system-ui, sans-serif; margin: 2em auto; max-width: 1200px; }
h2 { border-bottom: 1px solid #ccc; padding-bottom: .2em; }
table { border-collapse: collapse; margin: 1em 0; }
td, th { border: 1px solid #bbb; padding: 4px 10px; font-size: 13px; }
th { background: #f0f0f0; }
"""


def write_html_report(
    output_path: str,
    title: str,
    sections: List[dict],
) -> str:
    """sections: list of {"title": str, then one of "image": png_path,
    "table": rows (first row = header), "text": str}.  Images are base64-
    embedded so the file is portable (no sidecar assets)."""
    parts = [f"<!doctype html><html><head><meta charset='utf-8'>"
             f"<title>{html.escape(title)}</title><style>{_STYLE}</style></head>"
             f"<body><h1>{html.escape(title)}</h1>"]
    for sec in sections:
        parts.append(f"<h2>{html.escape(sec.get('title', ''))}</h2>")
        if "text" in sec:
            parts.append(f"<p>{html.escape(sec['text'])}</p>")
        if "table" in sec:
            parts.append(_table(sec["table"]))
        if "image" in sec and sec["image"] and os.path.exists(sec["image"]):
            parts.append(_img_tag(sec["image"]))
    parts.append("</body></html>")
    os.makedirs(os.path.dirname(os.path.abspath(output_path)), exist_ok=True)
    with open(output_path, "w") as f:
        f.write("".join(parts))
    return output_path


def eval_report_sections(
    folder: str,
    acc_table_rows: Optional[List[Sequence]] = None,
) -> List[dict]:
    """Collect whatever eval artifacts exist under `folder` into sections
    (accuracy table, embedding plots, retrieval grids, similarity
    distributions)."""
    import glob

    sections: List[dict] = []
    if acc_table_rows:
        sections.append({"title": "Retrieval accuracy", "table": acc_table_rows})
    for png in sorted(glob.glob(os.path.join(folder, "plots", "*.png"))):
        sections.append({"title": f"Embeddings: {os.path.basename(png)}", "image": png})
    for png in sorted(glob.glob(os.path.join(folder, "retrieval", "*.png"))):
        sections.append({"title": f"Retrieval: {os.path.basename(png)}", "image": png})
    sim = os.path.join(folder, "similarity_distributions.png")
    if os.path.exists(sim):
        sections.append({"title": "Similarity distributions", "image": sim})
    return sections
