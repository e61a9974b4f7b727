"""User-study CSV analysis and result-gallery builder.

Counterpart of `geodiffuser_tpu/evaluation/study.py`, which rebuilds the
reference's evaluation/evaluate_study.py (per-method preference counts from
study CSVs) and create_gallery.py (tiled comparison sheets over an
experiment tree).  Images are read, resized (Pillow's default bicubic) and
written with the port's `utils/png.py`.
"""

from __future__ import annotations

import csv
import os
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np


def analyze_study_csv(
    paths: List[str], method_names: Optional[List[str]] = None
) -> Dict[str, Dict[str, float]]:
    """Aggregate forced-choice study responses.

    Expects CSVs whose cells name the chosen method per question (the
    reference's google-form export format).  Returns per-method counts,
    preference rates, and a rough binomial stderr.
    """
    counts: Dict[str, int] = defaultdict(int)
    total = 0
    for path in paths:
        with open(path, newline="") as f:
            for row in csv.reader(f):
                for cell in row:
                    cell = cell.strip()
                    if not cell:
                        continue
                    if method_names is None or cell in method_names:
                        counts[cell] += 1
                        total += 1
    out = {}
    for m, c in sorted(counts.items(), key=lambda kv: -kv[1]):
        p = c / max(total, 1)
        out[m] = {
            "count": c,
            "rate": round(p, 4),
            "stderr": round(float(np.sqrt(p * (1 - p) / max(total, 1))), 4),
        }
    return out


def build_gallery(
    exp_root: str,
    out_path: str,
    columns: Optional[List[str]] = None,
    max_rows: int = 50,
) -> str:
    """Tile input / transformed / result images per experiment into one
    comparison sheet (create_gallery.py equivalent)."""
    from geodiffuser_tpu_torch.utils import attention_vis as av
    from geodiffuser_tpu_torch.utils import exp_io, png

    columns = columns or ["input_image.png", "transformed_image.png", "result_ls.png"]
    rows = []
    for _cat, folder in exp_io.list_experiments(exp_root):
        imgs = []
        for name in columns:
            p = os.path.join(folder, name)
            if os.path.exists(p):
                imgs.append(png.resize_bicubic(png.to_rgb(png.read_png(p)), 256, 256))
            else:
                imgs.append(np.full((256, 256, 3), 220, np.uint8))
        rows.extend(imgs)
        if len(rows) // len(columns) >= max_rows:
            break
    if not rows:
        raise ValueError(f"no experiments under {exp_root}")
    grid = av.view_images(rows, cols=len(columns))
    png.write_png(out_path, grid)
    return out_path
