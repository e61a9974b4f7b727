"""Experiment-folder IO: the on-disk format shared with the reference.

The port's own copy of `geodiffuser_tpu/utils/exp_io.py` (reference
ui_utils.py:52-159, large_scale_editor.py:133-177, 366-399).  An experiment
folder holds

    input_image.png, input_mask.png, depth.npy, depth.png, transform.npy,
    image_shape.npy, optional background_image.png / transformed_image.png /
    result.png; the batch driver adds result_ls.png, resized_result_ls.png
    (when the original aspect differs) and loss_log.json

and, once an edit has inverted its image, the DDIM inversion cache
`inversion.npz` (`key`, a string, and `all_latents`, float32
(T + 1, S0, h, w, 4)).  Either package reads what the other wrote.  PNGs go
through the port's own codec (`utils/png.py`), not PIL.
"""

from __future__ import annotations

import dataclasses
import json
import os
import zipfile
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from geodiffuser_tpu_torch.utils import png

CATEGORIES = (
    "Mix", "Rotation_3D", "Rotation_2D", "Translation_3D",
    "Scaling", "Removal", "Translation_2D",
)  # ui_utils.py:901-905


@dataclasses.dataclass
class Experiment:
    input_image: np.ndarray          # (H, W, 3) uint8
    input_mask: np.ndarray           # (H, W) float32 in [0, 1]
    depth: np.ndarray                # (H, W) float
    transform: np.ndarray            # (4, 4)
    image_shape: np.ndarray          # (2,) original aspect
    background_image: Optional[np.ndarray] = None
    transformed_image: Optional[np.ndarray] = None
    result: Optional[np.ndarray] = None
    path: str = ""


def _read_image(path: str) -> np.ndarray:
    return png.to_rgb(png.read_png(path))


def read_exp(folder: str) -> Experiment:
    """Load an experiment folder (read_exp, ui_utils.py:118-159)."""
    p = lambda n: os.path.join(folder, n)
    mask_img = png.read_png(p("input_mask.png"))
    if mask_img.ndim == 3:
        mask_img = mask_img[..., 0]
    opt_img = lambda n: _read_image(p(n)) if os.path.exists(p(n)) else None
    shape = (np.load(p("image_shape.npy")) if os.path.exists(p("image_shape.npy"))
             else np.array([512, 512]))
    return Experiment(
        input_image=_read_image(p("input_image.png")),
        input_mask=mask_img.astype(np.float32) / 255.0,
        depth=np.load(p("depth.npy")),
        transform=np.load(p("transform.npy")),
        image_shape=shape,
        background_image=opt_img("background_image.png"),
        transformed_image=opt_img("transformed_image.png"),
        result=opt_img("result.png"),
        path=folder,
    )


def save_exp(folder: str, input_image: np.ndarray, depth: np.ndarray, input_mask: np.ndarray,
             transform: np.ndarray, transformed_image: Optional[np.ndarray] = None,
             result: Optional[np.ndarray] = None, background_image: Optional[np.ndarray] = None,
             image_shape=(512, 512)) -> None:
    """Write an experiment folder (save_exp, ui_utils.py:52-109)."""
    os.makedirs(folder, exist_ok=True)
    p = lambda n: os.path.join(folder, n)
    png.write_png(p("input_image.png"), np.asarray(input_image, np.uint8))
    m = np.asarray(np.clip(input_mask, 0, 1) * 255, np.uint8)
    png.write_png(p("input_mask.png"), np.stack([m] * 3, -1))
    np.save(p("depth.npy"), np.asarray(depth))
    dvis = np.asarray(depth, np.float64)
    dvis = (dvis - dvis.min()) / (dvis.max() - dvis.min() + 1e-8)
    png.write_png(p("depth.png"), (np.stack([dvis] * 3, -1) * 255).astype(np.uint8))
    np.save(p("transform.npy"), np.asarray(transform))
    np.save(p("image_shape.npy"), np.asarray(image_shape))
    for name, img in (("transformed_image", transformed_image), ("result", result),
                      ("background_image", background_image)):
        if img is not None:
            png.write_png(p(name + ".png"), np.asarray(img, np.uint8))


def save_results(exp: Experiment, edited_image: np.ndarray, loss_log: Dict) -> None:
    """Write an edit's outputs next to its inputs (save_results,
    large_scale_editor.py:133-177): result_ls.png, resized_result_ls.png at
    the original aspect (Pillow's bicubic resize, `png.resize_bicubic`) and
    the loss log as JSON."""
    folder = exp.path
    edited = np.asarray(edited_image, np.uint8)
    png.write_png(os.path.join(folder, "result_ls.png"), edited)
    h, w = [int(v) for v in exp.image_shape[:2]]
    if (h, w) != edited.shape[:2]:
        png.write_png(os.path.join(folder, "resized_result_ls.png"),
                      png.resize_bicubic(edited, h, w))
    with open(os.path.join(folder, "loss_log.json"), "w") as f:
        json.dump({str(k): v for k, v in loss_log.items()}, f, indent=1)


def list_experiments(root: str) -> Iterator[Tuple[str, str]]:
    """Yield (category, folder) pairs under an experiment root (the sweep
    structure of large_scale_editor.py:366-399): every `<root>/<category>/<n>`
    holding an input_image.png, categories in name order, numbers by
    (length, name)."""
    for cat in sorted(os.listdir(root)):
        cat_dir = os.path.join(root, cat)
        if not os.path.isdir(cat_dir):
            continue
        for num in sorted(os.listdir(cat_dir), key=lambda s: (len(s), s)):
            exp_dir = os.path.join(cat_dir, num)
            if os.path.isdir(exp_dir) and os.path.exists(os.path.join(exp_dir, "input_image.png")):
                yield cat, exp_dir


def edit_type_for_category(category: str) -> Optional[str]:
    """Category -> edit type (large_scale_editor.py:377-386): Removal ->
    remover; Rotation_2D and Scaling are skipped (None); the stitch
    categories (the reference's ui_outputs/stitching tree,
    large_scale_editor.py:325-326) -> stitch; the rest -> editor."""
    if category in ("Rotation_2D", "Scaling"):
        return None
    if category == "Removal":
        return "geometry_remover"
    if category.lower() in ("stitch", "stitching", "geometry_stitch"):
        return "geometry_stitch"
    return "geometry_editor"


INVERSION_CACHE_FILE = "inversion.npz"


def load_inversion(folder: str, key: str) -> Optional[np.ndarray]:
    """The cached DDIM inversion trajectory for `key`, or None.

    `all_latents` is a pure function of (image, prompt, scheduler, model),
    so the experiment folder caches it for the iterate-on-transform-knobs
    workflow.  The file holds exactly one entry; a key mismatch (another
    prompt, config or model) or a file that cannot be read is a miss, and
    the next save overwrites it.
    """
    path = os.path.join(folder, INVERSION_CACHE_FILE)
    if not os.path.exists(path):
        return None
    try:
        with np.load(path, allow_pickle=False) as z:
            if str(z["key"]) != key:
                return None
            return z["all_latents"]
    except (OSError, KeyError, ValueError, EOFError, zipfile.BadZipFile):
        return None


def save_inversion(folder: str, key: str, all_latents: np.ndarray) -> None:
    """Write the trajectory for `key` into `folder` (an existing directory;
    nothing is written otherwise), replacing the file in one rename."""
    if not os.path.isdir(folder):
        return
    tmp = os.path.join(folder, INVERSION_CACHE_FILE + ".tmp.npz")
    np.savez(tmp, key=np.str_(key), all_latents=np.asarray(all_latents, np.float32))
    os.replace(tmp, os.path.join(folder, INVERSION_CACHE_FILE))
