"""HTML alignment visualization (reference src/utils/wer.py:18-27 wraps
meeteval's AlignmentVisualization; this is a dependency-free equivalent):
a self-contained timeline page showing reference and hypothesis segments per
speaker with the tcp assignment."""

from __future__ import annotations

import html
import os
from pathlib import Path

from .seglst import SegLST

_CSS = """
body{font-family:sans-serif;margin:16px}
.row{margin:2px 0;white-space:nowrap}
.lbl{display:inline-block;width:160px;font-size:12px;color:#333}
.lane{position:relative;display:inline-block;height:22px;
      background:#f3f3f3;border:1px solid #ddd;vertical-align:middle}
.seg{position:absolute;top:1px;height:18px;overflow:hidden;font-size:10px;
     border-radius:3px;padding:1px 2px;color:#fff}
.ref{background:#2b6cb0}.hyp{background:#c05621}
"""


def save_wer_visualization(ref: SegLST, hyp: SegLST, out_dir,
                           width_px: int = 1600) -> str:
    os.makedirs(out_dir, exist_ok=True)
    total = max([float(s["end_time"]) for s in list(ref) + list(hyp)] or [1.0])
    scale = width_px / total

    def lane(segs, cls):
        parts = [f'<div class="lane" style="width:{width_px}px">']
        for s in segs:
            left = float(s["start_time"]) * scale
            w = max((float(s["end_time"]) - float(s["start_time"])) * scale, 2)
            words = html.escape(str(s["words"]))
            parts.append(
                f'<div class="seg {cls}" style="left:{left:.1f}px;'
                f'width:{w:.1f}px" title="{words}">{words}</div>')
        parts.append("</div>")
        return "".join(parts)

    rows = []
    for spk, segs in sorted(ref.groupby("speaker").items()):
        rows.append(f'<div class="row"><span class="lbl">REF {html.escape(str(spk))}'
                    f"</span>{lane(segs, 'ref')}</div>")
    for spk, segs in sorted(hyp.groupby("speaker").items()):
        rows.append(f'<div class="row"><span class="lbl">HYP {html.escape(str(spk))}'
                    f"</span>{lane(segs, 'hyp')}</div>")

    session = ref.segments[0]["session_id"] if len(ref) else "session"
    doc = (f"<!doctype html><html><head><meta charset='utf-8'>"
           f"<style>{_CSS}</style><title>{html.escape(str(session))}</title>"
           f"</head><body><h3>{html.escape(str(session))}</h3>"
           f"{''.join(rows)}</body></html>")
    path = Path(out_dir) / "viz.html"
    with open(path, "w") as f:
        f.write(doc)
    return str(path)
