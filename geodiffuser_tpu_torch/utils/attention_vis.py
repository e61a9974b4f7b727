"""Attention-map aggregation and visualization.

Counterpart of `geodiffuser_tpu/utils/attention_vis.py`, which rebuilds the
reference's attention storage/visualization stack:
  * AttentionStore (attention_sharing.py:158-207): per-placement capture of
    attention maps <= 16^2 tokens, averaged over steps;
  * aggregate/visualize helpers (ptp_utils.py:145-190, attention_utils.py,
    pallete.py).

`AttentionRecorder.update` takes one step's maps as a nested dict of arrays
(layer path -> "map"), the shape of the JAX package's 'attn_store'
collection.  Images are resized with the port's Pillow-exact resizes
(`utils/png.py`), without PIL.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

# 20-color qualitative palette (role of pallete.py)
PALETTE = np.array([
    [230, 25, 75], [60, 180, 75], [255, 225, 25], [0, 130, 200],
    [245, 130, 48], [145, 30, 180], [70, 240, 240], [240, 50, 230],
    [210, 245, 60], [250, 190, 190], [0, 128, 128], [230, 190, 255],
    [170, 110, 40], [255, 250, 200], [128, 0, 0], [170, 255, 195],
    [128, 128, 0], [255, 215, 180], [0, 0, 128], [128, 128, 128],
], np.uint8)


def _flatten(tree: Dict, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


class AttentionRecorder:
    """Accumulates per-layer attention maps across steps (the reference
    controller's step_store/attention_store aggregation,
    attention_sharing.py:181-196)."""

    def __init__(self):
        self.store: Dict[str, np.ndarray] = {}
        self.counts: Dict[str, int] = {}

    def update(self, aux_store: Dict) -> None:
        """Feed one step's maps: a nested dict whose leaves are arrays."""
        for key, val in _flatten(aux_store):
            name = "/".join(str(k) for k in key)
            arr = np.asarray(val, np.float32)
            if name in self.store:
                self.store[name] += arr
                self.counts[name] += 1
            else:
                self.store[name] = arr.copy()
                self.counts[name] = 1

    def averaged(self) -> Dict[str, np.ndarray]:
        return {k: v / max(self.counts[k], 1) for k, v in self.store.items()}


def aggregate_cross_attention(
    maps: Dict[str, np.ndarray], res: int = 16, token: Optional[int] = None
) -> np.ndarray:
    """Average cross-attention maps at a given resolution over layers/heads
    (ptp_utils.py:145-190's aggregation).  maps values: (heads, seq, Lk)."""
    acc = []
    for name, m in maps.items():
        if "attn2" not in name:
            continue
        heads, seq, lk = m.shape[-3:]
        if seq != res * res:
            continue
        m2 = m.reshape(-1, seq, lk).mean(0)  # (seq, Lk)
        acc.append(m2)
    if not acc:
        raise ValueError(f"no cross-attention maps at {res}^2")
    avg = np.stack(acc).mean(0)  # (seq, Lk)
    if token is not None:
        return avg[:, token].reshape(res, res)
    return avg.reshape(res, res, -1)


def colorize(map2d: np.ndarray, size: int = 256) -> np.ndarray:
    """Turbo-less simple heat map (viridis-like 3-stop ramp) as uint8 RGB,
    resized as PIL's NEAREST resize does."""
    from geodiffuser_tpu_torch.utils import png

    m = np.asarray(map2d, np.float64)
    m = (m - m.min()) / (m.max() - m.min() + 1e-12)
    stops = np.array([[68, 1, 84], [33, 145, 140], [253, 231, 37]], np.float64)
    idx = m * 2.0
    lo = np.clip(np.floor(idx).astype(int), 0, 1)
    frac = (idx - lo)[..., None]
    rgb = stops[lo] * (1 - frac) + stops[lo + 1] * frac
    return png.resize_nearest(rgb.astype(np.uint8), size, size)


def overlay_masks(image: np.ndarray, masks: Sequence[np.ndarray], alpha: float = 0.5) -> np.ndarray:
    """Blend colored masks over an image (attention/mask debug vis)."""
    out = np.asarray(image, np.float64).copy()
    if out.max() <= 1.5:
        out = out * 255.0
    for i, m in enumerate(masks):
        color = PALETTE[i % len(PALETTE)].astype(np.float64)
        mm = (np.asarray(m) > 0.5)[..., None]
        out = np.where(mm, out * (1 - alpha) + color * alpha, out)
    return out.astype(np.uint8)


def view_images(images: List[np.ndarray], cols: int = 4, pad: int = 4) -> np.ndarray:
    """Tile images into one grid (ptp_utils view_images equivalent)."""
    images = [np.asarray(im, np.uint8) for im in images]
    h = max(im.shape[0] for im in images)
    w = max(im.shape[1] for im in images)
    rows = (len(images) + cols - 1) // cols
    grid = np.full((rows * (h + pad) - pad, cols * (w + pad) - pad, 3), 255, np.uint8)
    for i, im in enumerate(images):
        r, c = divmod(i, cols)
        grid[r * (h + pad) : r * (h + pad) + im.shape[0],
             c * (w + pad) : c * (w + pad) + im.shape[1]] = im[..., :3]
    return grid
