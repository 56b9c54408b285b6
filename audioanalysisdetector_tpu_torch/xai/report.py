"""Self-contained HTML explanation artifact (PyTorch port).

Counterpart of the JAX package's ``xai/report.py`` (the reference ships an
exported ``explanation.html`` LIME bundle; this is the capability
equivalent): heatmaps inlined as base64 PNGs + the LIME surrogate's
verdict, one file, no external assets. Without matplotlib the page is
written with each heatmap's section saying its image was skipped (one line
on stderr).
"""

from __future__ import annotations

import base64
import html
import io
import os

import numpy as np

from audioanalysisdetector_tpu_torch.xai.compare import have_matplotlib

_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>{title}</title>
<style>
 body {{ font-family: system-ui, sans-serif; margin: 2rem; color: #222; }}
 h1 {{ font-size: 1.3rem; }} h2 {{ font-size: 1.05rem; margin-top: 1.5rem; }}
 .verdict {{ padding: .6rem 1rem; border-radius: 6px; display: inline-block;
            background: {verdict_bg}; color: white; font-weight: 600; }}
 img {{ max-width: 720px; border: 1px solid #ddd; border-radius: 4px; }}
 table {{ border-collapse: collapse; }} td, th {{ border: 1px solid #ccc;
          padding: .3rem .7rem; text-align: right; }}
</style></head><body>
<h1>{title}</h1>
<p class="verdict">{verdict}</p>
{sections}
</body></html>
"""


def _png_b64(heatmap: np.ndarray, title: str) -> str:
    import matplotlib.pyplot as plt

    from audioanalysisdetector_tpu_torch.xai.compare import render_heatmap_figure

    fig = render_heatmap_figure(heatmap, title)
    buf = io.BytesIO()
    fig.savefig(buf, format="png", dpi=90)
    plt.close(fig)
    return base64.b64encode(buf.getvalue()).decode()


def write_explanation_html(
    out_path: str,
    *,
    score: float,
    heatmaps: dict[str, np.ndarray] | None = None,
    top_components: list[int] | None = None,
    coefficients: np.ndarray | None = None,
    title: str = "Spoof-detection explanation",
    threshold: float = 0.5,
) -> str:
    """Render one utterance's explanation to a standalone HTML file."""
    spoof = score > threshold
    sections = []
    if top_components is not None:
        rows = "".join(
            f"<tr><td>{c}</td><td>{coefficients[c]:+.4f}</td></tr>"
            if coefficients is not None
            else f"<tr><td>{c}</td><td>—</td></tr>"
            for c in top_components
        )
        sections.append(
            "<h2>Most influential components (LIME surrogate)</h2>"
            f"<table><tr><th>component</th><th>weight</th></tr>{rows}</table>"
        )
    images = bool(heatmaps) and have_matplotlib(f"heatmap images in {out_path}")
    for name, hm in (heatmaps or {}).items():
        img = (f'<img alt="{html.escape(name)}" src="data:image/png;base64,{_png_b64(hm, name)}">'
               if images else "<p>(image not rendered: matplotlib is not installed)</p>")
        sections.append(f"<h2>{html.escape(name)}</h2>{img}")
    doc = _PAGE.format(
        title=html.escape(title),
        verdict=f"{'SPOOF' if spoof else 'BONAFIDE'} — score {score:.3f}",
        verdict_bg="#b3261e" if spoof else "#2e7d32",
        sections="\n".join(sections),
    )
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        f.write(doc)
    return out_path
