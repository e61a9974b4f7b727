"""Depth prediction wrappers and post-processing rules.

Counterpart of `geodiffuser_tpu/utils/depth.py` (the reference's
depth_predictor.py wrapper layer and ui_utils' depth helpers):

  * relative -> edit depth: d = d.max() - d, then d += d.max() *
    translate_factor (depth_predictor.py:364-369; the UI's slider is 0.7,
    the wrapper's default 0.1);
  * constant depth 0.5 for 2D edits and the inpaint tab
    (depth_predictor.py:321);
  * median / Gaussian depth correction (depth_predictor.py:41-50);
  * disparity -> depth, depth scaling, the background's nearest-neighbour
    fill (ui_utils.py:383-401, 729-815).

The backends of the reference's dropdown: Depth Anything
(`models/depth_anything.py`), MiDaS DPT-Large, DPT-Hybrid with its KITTI /
NYU metric variants and MiDaS v2.1 (`models/midas_dpt.py`), ZoeDepth
(`models/zoedepth.py`) and ZoeDepth-NK (`models/zoedepth_nk.py`), each with
the JAX predictor's input size, normalization and output rule.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from geodiffuser_tpu_torch.core.pipeline import resolve_device
from geodiffuser_tpu_torch.models import weights as weights_lib
from geodiffuser_tpu_torch.models.depth_anything import DepthAnything, DepthAnythingConfig
from geodiffuser_tpu_torch.models.layers import seeded_init_
from geodiffuser_tpu_torch.models.midas_dpt import (
    DPTConfig, DPTHybrid, DPTHybridConfig, DPTLarge, MidasNetV21, MidasV21Config,
)
from geodiffuser_tpu_torch.models.zoedepth import ZoeDepth, ZoeDepthConfig
from geodiffuser_tpu_torch.models.zoedepth_nk import ZoeDepthNK, ZoeDepthNKConfig
from geodiffuser_tpu_torch.ops import image as image_ops

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def constant_depth(height: int, width: int) -> np.ndarray:
    """0.5 everywhere (get_constant_depth, depth_predictor.py:321-322); the
    transform field special-cases it (vis_utils.py:410-411)."""
    return np.full((height, width), 0.5, np.float32)


def postprocess_relative_depth(depth: np.ndarray, translate_factor: float = 0.1) -> np.ndarray:
    """Invert (the model emits larger = closer) and push the scene away from
    the camera to reduce rotation smearing (depth_predictor.py:364-369)."""
    d = np.asarray(depth, np.float32)
    d = d.max() - d
    return d + d.max() * translate_factor


def depth_corrector(depth: np.ndarray, filter_type: str = "gaussian") -> np.ndarray:
    """Median / Gaussian cleanup (depth_predictor.py:41-50)."""
    from scipy.ndimage import gaussian_filter, median_filter

    if filter_type == "median":
        return median_filter(np.asarray(depth), size=3)
    return gaussian_filter(np.asarray(depth), sigma=0.75)


def disparity_to_depth(disparity: np.ndarray, eps: float = 1e-6) -> np.ndarray:
    """(ui_utils.py:812-815)"""
    return 1.0 / (np.asarray(disparity, np.float64) + eps)


def depth_scaler(depth: np.ndarray) -> np.ndarray:
    """Normalize to [0, 1] (ui_utils.py:729-740)."""
    d = np.asarray(depth, np.float64)
    return ((d - d.min()) / (d.max() - d.min() + 1e-8)).astype(np.float32)


def fill_background_depth(depth: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Fill non-mask pixels with the nearest masked pixel's depth
    (fill_background_depth, vis_utils.py:383-401; KD-tree NN fill)."""
    from scipy.spatial import cKDTree

    d = np.asarray(depth).copy()
    good = np.asarray(mask) >= 0.5
    if good.all() or not good.any():
        return d
    ys, xs = np.mgrid[0:d.shape[0], 0:d.shape[1]]
    good_pts = np.stack([ys[good], xs[good]], -1)
    bad_pts = np.stack([ys[~good], xs[~good]], -1)
    _, idx = cKDTree(good_pts).query(bad_pts)
    d[~good] = d[good][idx]
    return d


def _abs(x: torch.Tensor) -> torch.Tensor:
    # |x| whose derivative at 0 is 1, as jax.grad(jnp.abs) gives (torch's
    # abs gives 0 there, which would leave flat regions unsmoothed)
    return torch.where(x >= 0, x, -x)


def depth_smoothing_tv(depth, steps: int = 10, lr: float = 0.1) -> torch.Tensor:
    """Total-variation smoothing of a depth map by gradient descent
    (depth_smoothing, ui_utils.py:769-809): `steps` autograd steps."""
    d = torch.as_tensor(depth, dtype=torch.float32)
    with torch.enable_grad():
        for _ in range(steps):
            d = d.detach().requires_grad_(True)
            tv = _abs(d[1:, :] - d[:-1, :]).mean() + _abs(d[:, 1:] - d[:, :-1]).mean()
            (grad,) = torch.autograd.grad(tv, d)
            d = d - lr * grad
    return d.detach()


def bilateral_depth_filter(depth: np.ndarray, image: np.ndarray, sigma_space: float = 3.0,
                           sigma_color: float = 0.1, radius: int = 5) -> np.ndarray:
    """Joint bilateral filter weighted by the RGB image, with wrap-around
    borders (depth_bilateral_filter, ui_utils.py:184-206)."""
    d = torch.as_tensor(np.asarray(depth, np.float32))
    g = torch.as_tensor(np.asarray(image, np.float32))
    if g.dim() == 3:
        g = g.mean(-1)
    if g.max() > 1.5:
        g = g / 255.0
    num = torch.zeros_like(d)
    den = torch.zeros_like(d)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            sd = torch.roll(d, (dy, dx), (0, 1))
            sg = torch.roll(g, (dy, dx), (0, 1))
            ws = float(np.exp(-(dy * dy + dx * dx) / (2 * sigma_space ** 2)))
            wgt = ws * torch.exp(-((sg - g) ** 2) / (2 * sigma_color ** 2))
            num = num + wgt * sd
            den = den + wgt
    return (num / (den + 1e-8)).numpy()


DEPTH_ANYTHING_CONFIGS = {
    "vitl": DepthAnythingConfig(encoder="vitl"),
    "vitb": DepthAnythingConfig(encoder="vitb", out_channels=(96, 192, 384, 768), features=128),
    "vits": DepthAnythingConfig(encoder="vits", out_channels=(48, 96, 192, 384), features=64),
    "tiny": DepthAnythingConfig.tiny(),
}


class DepthAnythingPredictor:
    """Depth Anything on `device` with the reference's preprocessing (the
    side resized to at least 518 and a multiple of 14, ImageNet
    normalization; depth_predictor.py:331-341) and postprocessing.  Weights:
    the published file at `checkpoint_path`, else `state_dict` (the port's
    names), else random from `seed`."""

    def __init__(self, encoder: str = "vitl", checkpoint_path: Optional[str] = None,
                 state_dict: Optional[Dict[str, torch.Tensor]] = None, device="cuda",
                 seed: int = 0):
        self.device = resolve_device(device)
        self.cfg = DEPTH_ANYTHING_CONFIGS[encoder]
        with self.device:
            self.model = DepthAnything(self.cfg).eval().requires_grad_(False)
        if checkpoint_path:
            state_dict = weights_lib.read_checkpoint(checkpoint_path,
                                                     "depth_anything_vitl14.json")
        if state_dict is None:
            seeded_init_(self.model, torch.Generator(self.device).manual_seed(seed))
        else:
            weights_lib.load_perception_model(self.model, state_dict, "depth_anything")
        self.mean = torch.from_numpy(IMAGENET_MEAN).to(self.device)
        self.std = torch.from_numpy(IMAGENET_STD).to(self.device)

    @staticmethod
    def _preprocess_size(h: int, w: int, lower_bound: int = 518, multiple: int = 14):
        scale = max(lower_bound / h, lower_bound / w)
        nh = int(round(h * scale / multiple) * multiple)
        nw = int(round(w * scale / multiple) * multiple)
        return max(nh, multiple), max(nw, multiple)

    def relative_depth(self, image: np.ndarray) -> torch.Tensor:
        """(H, W, 3) uint8 or float image -> (H, W) float32 relative depth
        (larger = closer) on the device."""
        img = np.asarray(image, np.float32)
        if img.max() > 1.5:
            img = img / 255.0
        h, w = img.shape[:2]
        patch = self.cfg.dino().patch_size
        lower = 518 if patch == 14 else 16 * patch
        nh, nw = self._preprocess_size(h, w, lower_bound=lower, multiple=patch)
        with torch.inference_mode():
            x = image_ops.resize_bilinear_hwc(torch.from_numpy(img).to(self.device), nh, nw)
            x = (x - self.mean) / self.std
            return image_ops.resize_bilinear(self.model(x[None])[0], h, w)

    def __call__(self, image: np.ndarray, translate_factor: float = 0.1) -> np.ndarray:
        """(H, W, 3) uint8 or float image -> (H, W) edit-ready depth."""
        d = self.relative_depth(image).cpu().numpy()
        return postprocess_relative_depth(d, translate_factor)


def _image01(image: np.ndarray) -> np.ndarray:
    img = np.asarray(image, np.float32)
    return img / 255.0 if img.max() > 1.5 else img


class _ResizedDepthPredictor:
    """A depth model behind the JAX predictors' common wrapper: the image
    resized (bilinear, no antialiasing) to `input_size()` (each side of
    `size` rounded down to a multiple of `multiple`, at least two),
    normalized with `mean` / `std`, the model's output resized back, times
    `out_scale`; relative depth is inverted and pushed back, `metric` depth
    only pushed back.  The model is built on the device; its weights are the
    published file at `checkpoint_path` (the keys its `manifest` marks
    unconsumed dropped), else `state_dict` (the port's names), else random
    from `seed`."""

    name = "depth"
    manifest = None
    mean, std = IMAGENET_MEAN, IMAGENET_STD
    multiple = 16
    metric = False
    out_scale = 1.0

    def _load(self, build, device, checkpoint_path, state_dict, seed: int):
        self.device = resolve_device(device)
        with self.device:
            self.model = build().eval().requires_grad_(False)
        if checkpoint_path:
            state_dict = weights_lib.read_checkpoint(checkpoint_path, self.manifest)
        if state_dict is None:
            seeded_init_(self.model, torch.Generator(self.device).manual_seed(seed))
        else:
            weights_lib.load_perception_model(self.model, state_dict, self.name)
        self._mean = torch.as_tensor(self.mean).to(self.device)
        self._std = torch.as_tensor(self.std).to(self.device)

    def input_size(self) -> Tuple[int, int]:
        size = self.size if isinstance(self.size, tuple) else (self.size, self.size)
        return tuple(max(s // self.multiple, 2) * self.multiple for s in size)

    def model_depth(self, image: np.ndarray) -> torch.Tensor:
        """(H, W, 3) uint8 or float image -> the model's (H, W) float32 output
        at the image's size, on the device."""
        img = _image01(image)
        h, w = img.shape[:2]
        with torch.inference_mode():
            x = image_ops.resize_bilinear_hwc(torch.from_numpy(img).to(self.device),
                                              *self.input_size())
            x = (x - self._mean) / self._std
            return image_ops.resize_bilinear(self.model(x[None])[0], h, w)

    def __call__(self, image: np.ndarray, translate_factor: float = 0.0) -> np.ndarray:
        d = self.model_depth(image).cpu().numpy() * self.out_scale
        if self.metric:
            return d + d.max() * translate_factor if translate_factor else d
        return postprocess_relative_depth(d, translate_factor)


class MidasDPTPredictor(_ResizedDepthPredictor):
    """dpt_large path of get_monocular_depth (depth_predictor.py:105-274): a
    side of `size` (with a config: half its 16-pixel position grid), the
    DPT's mean = std = 0.5 normalization (depth_predictor.py:128), inverse
    depth out, then the invert / push-back rule."""

    name = "dpt_large"
    manifest = "dpt_large.json"
    mean = std = np.full(3, 0.5, np.float32)

    def __init__(self, config: Optional[DPTConfig] = None, size: int = 384,
                 checkpoint_path: Optional[str] = None,
                 state_dict: Optional[Dict[str, torch.Tensor]] = None, device="cuda",
                 seed: int = 0):
        self.cfg = config or DPTConfig()
        self.size = size if config is None else 16 * self.cfg.pos_grid // 2
        self.multiple = self.cfg.patch_size
        self._load(lambda: DPTLarge(self.cfg), device, checkpoint_path, state_dict, seed)


class DPTHybridPredictor(_ResizedDepthPredictor):
    """dpt_hybrid / dpt_hybrid_kitti / dpt_hybrid_nyu (depth_predictor.py:
    130-168): 0.5 / 0.5 normalization, ViT-B over a ResNetV2-50 stem; the
    KITTI / NYU variants invert to metric depth with their published scale
    and shift, times 256 / 1000 (:244-248), and are only pushed back."""

    name = "dpt_hybrid"
    manifest = "dpt_hybrid.json"
    mean = std = np.full(3, 0.5, np.float32)
    VARIANTS = {
        "dpt_hybrid": dict(scale=1.0, shift=0.0, invert=False, out_scale=1.0),
        # depth_predictor.py:141-147 / :154-160, output scaling :244-248
        "dpt_hybrid_kitti": dict(scale=0.00006016, shift=0.00579, invert=True,
                                 out_scale=256.0),
        "dpt_hybrid_nyu": dict(scale=0.000305, shift=0.1378, invert=True,
                               out_scale=1000.0),
    }

    def __init__(self, config: Optional[DPTHybridConfig] = None, variant: str = "dpt_hybrid",
                 size: int = 384, checkpoint_path: Optional[str] = None,
                 state_dict: Optional[Dict[str, torch.Tensor]] = None, device="cuda",
                 seed: int = 0):
        v = self.VARIANTS[variant]
        self.variant = variant
        self.cfg = config or DPTHybridConfig(scale=v["scale"], shift=v["shift"],
                                             invert=v["invert"])
        self.out_scale = v["out_scale"]
        self.metric = self.cfg.invert
        self.size = size if config is None else 16 * self.cfg.pos_grid // 2
        self._load(lambda: DPTHybrid(self.cfg), device, checkpoint_path, state_dict, seed)


class MidasV21Predictor(_ResizedDepthPredictor):
    """midas_v21 path of get_monocular_depth (depth_predictor.py:169-175):
    ImageNet normalization, a side of `size` in multiples of 32, ResNeXt101
    MidasNet, inverse depth out."""

    name = "midas_v21"
    manifest = "midas_v21.json"
    multiple = 32

    def __init__(self, config: Optional[MidasV21Config] = None, size: int = 384,
                 checkpoint_path: Optional[str] = None,
                 state_dict: Optional[Dict[str, torch.Tensor]] = None, device="cuda",
                 seed: int = 0):
        self.cfg = config or MidasV21Config()
        self.size = size
        self._load(lambda: MidasNetV21(self.cfg), device, checkpoint_path, state_dict, seed)


class ZoeDepthPredictor(_ResizedDepthPredictor):
    """Metric depth (get_monocular_ZoeDepth, depth_predictor.py:277-319) from
    the single-head ZoeDepth over the ViT-L/16 DPT core, which no published
    file holds: weights from `state_dict` or `seed`.  The reference returns
    the metric depth raw: it is only pushed back."""

    name = "zoedepth"
    metric = True

    def __init__(self, config: Optional[ZoeDepthConfig] = None, size: int = 384,
                 state_dict: Optional[Dict[str, torch.Tensor]] = None, device="cuda",
                 seed: int = 0):
        self.cfg = config or ZoeDepthConfig()
        self.size = size
        self.multiple = self.cfg.core.patch_size
        self._load(lambda: ZoeDepth(self.cfg), device, None, state_dict, seed)


class ZoeDepthNKPredictor(_ResizedDepthPredictor):
    """The shipped ZoeD-M12-NK architecture (BEiT-384 core, two heads and the
    latitude router) at a (height, width) `size` of (384, 512); metric depth,
    only pushed back."""

    name = "zoedepth_nk"
    manifest = "zoedepth_nk.json"
    metric = True

    def __init__(self, config: Optional[ZoeDepthNKConfig] = None,
                 size: Tuple[int, int] = (384, 512), checkpoint_path: Optional[str] = None,
                 state_dict: Optional[Dict[str, torch.Tensor]] = None, device="cuda",
                 seed: int = 0):
        self.cfg = config or ZoeDepthNKConfig()
        self.size = tuple(size)
        self.multiple = self.cfg.core.patch_size
        self._load(lambda: ZoeDepthNK(self.cfg), device, checkpoint_path, state_dict, seed)


def get_depth_predictor(name: str = "depth_anything", **kw):
    """Depth-model registry (the reference's model dropdown,
    ui_utils.py:380-411), with the JAX registry's names and aliases."""
    if name == "depth_anything":
        return DepthAnythingPredictor(**kw)
    if name in ("dpt_large", "midas"):
        return MidasDPTPredictor(**kw)
    if name in ("dpt_hybrid", "dpt_hybrid_kitti", "dpt_hybrid_nyu"):
        return DPTHybridPredictor(variant=name, **kw)
    if name == "midas_v21":
        return MidasV21Predictor(**kw)
    if name == "zoedepth":
        return ZoeDepthPredictor(**kw)
    if name in ("zoedepth_nk", "zoe_nk"):
        return ZoeDepthNKPredictor(**kw)
    raise ValueError(f"unknown depth model {name}")
