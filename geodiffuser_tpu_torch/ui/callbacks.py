"""UI callback layer, independent of the front end.

Counterpart of `geodiffuser_tpu/ui/callbacks.py` (the reference Gradio
app's callbacks, ui_utils.py:322-995, wired in geo_diff_ui.py:62-1272):
plain functions over an explicit `UIState`, so that the HTTP server
(`ui/serve.py`), the gradio app (`ui/app.py`) and the tests drive the same
logic.  Images are numpy arrays; the depth and SAM predictors, the
transform preview and the edits run on `UIState.device`.  No PIL: the
upload is resized by the port's Pillow-exact bicubic (`utils/png.py`).
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Optional, Tuple

import numpy as np
import torch

from geodiffuser_tpu_torch.config import (EDITOR_LOSS_WEIGHTS, REMOVER_LOSS_WEIGHTS, EditConfig,
                                          SplatConfig)
from geodiffuser_tpu_torch.core.editor import EditSession
from geodiffuser_tpu_torch.ops import camera
from geodiffuser_tpu_torch.ops import splat as splat_ops
from geodiffuser_tpu_torch.ops import transform_field as tf_ops
from geodiffuser_tpu_torch.utils import depth as depth_utils
from geodiffuser_tpu_torch.utils import exp_io, png

# preview overlay colors (ui_utils.py:466-492): orange = removed region,
# olive = amodal ring
ORANGE = np.array([255, 165, 0], np.uint8)
OLIVE = np.array([128, 128, 0], np.uint8)

# experiment categories (ui_utils.py:901-905), re-exported for the app layer
CATEGORIES = exp_io.CATEGORIES


@dataclasses.dataclass
class UIState:
    """The state of one browser session (the reference keeps it in module
    globals, editor.py:52-56)."""

    image: Optional[np.ndarray] = None       # (S, S, 3) uint8
    mask: Optional[np.ndarray] = None        # (S, S) float32 in {0, 1}
    depth: Optional[np.ndarray] = None       # (S, S) float
    background: Optional[np.ndarray] = None
    transform: np.ndarray = dataclasses.field(default_factory=lambda: np.eye(4))
    image_shape: Tuple[int, int] = (512, 512)
    sam_predictor: object = None
    depth_predictor: object = None           # the default ("depth_anything") backend
    depth_predictors: dict = dataclasses.field(default_factory=dict)  # per-model cache
    pipeline: object = None
    sessions: dict = dataclasses.field(default_factory=dict)
    device: str = "cuda"                     # of the predictors built here and the preview
    # per-session scratch directory of the DDIM inversion cache: a knob
    # change makes a new EditSession (and loses its in-memory memo), but the
    # disk cache keeps the trajectory while (image, prompt, guidance, steps)
    # stay the same
    cache_dir: Optional[str] = None

    def inversion_cache_dir(self) -> str:
        if self.cache_dir is None:
            self.cache_dir = tempfile.mkdtemp(prefix="geodiffuser_ui_")
        return self.cache_dir


@dataclasses.dataclass
class AdvancedOptions:
    """The reference UI's advanced-accordion knobs (geo_diff_ui.py:291-527),
    mapped one to one onto EditConfig.  `diffusion_correction` maps to
    obj_edit_step = 1 - diffusion_correction (ui_utils.py:613).  A loss
    weight of None keeps the edit type's tuned default."""

    guidance_scale: float = 3.0
    cross_replace_steps: float = 0.97
    self_replace_steps: float = 0.97
    skip_steps: int = 2
    latent_replace: float = 0.1
    optimize_steps: float = 0.65
    fast_optim_steps: float = 0.0            # fast_start_steps fraction
    num_first_optim_steps: int = 1
    num_ddim_steps: int = 50
    lr: float = 0.03
    splatting_radius: float = 1.3
    splatting_tau: float = 1.0
    splatting_points_per_pixel: int = 15
    cam_focal_length: float = 550.0
    diffusion_correction: float = 0.1
    removal_loss_adaptive_value: float = -1.5
    # per-loss weights (geo_diff_ui.py:430-527); None -> tuned defaults
    sim_loss_self: Optional[float] = None        # background preservation
    sim_loss_cross: Optional[float] = None
    movement_loss_self: Optional[float] = None   # object placement
    movement_loss_cross: Optional[float] = None
    removal_loss_self: Optional[float] = None
    removal_loss_cross: Optional[float] = None
    amodal_loss_self: Optional[float] = None
    amodal_loss_cross: Optional[float] = None
    smoothness_loss_self: Optional[float] = None
    smoothness_loss_cross: Optional[float] = None

    def loss_weight_table(self, edit_type: str):
        base = REMOVER_LOSS_WEIGHTS if edit_type == "geometry_remover" else EDITOR_LOSS_WEIGHTS
        table = {b: dict(t) for b, t in base.items()}
        names = {
            "sim": (self.sim_loss_self, self.sim_loss_cross),
            "movement": (self.movement_loss_self, self.movement_loss_cross),
            "removal": (self.removal_loss_self, self.removal_loss_cross),
            "amodal": (self.amodal_loss_self, self.amodal_loss_cross),
            "smoothness": (self.smoothness_loss_self, self.smoothness_loss_cross),
        }
        overridden = False
        for key, (s, c) in names.items():
            if s is not None and key in table["self"]:
                table["self"][key] = float(s)
                overridden = True
            if c is not None and key in table["cross"]:
                table["cross"][key] = float(c)
                overridden = True
        return table if overridden else None

    def to_edit_config(self, edit_type: str = "geometry_editor") -> EditConfig:
        return EditConfig(
            edit_type=edit_type,
            guidance_scale=self.guidance_scale,
            cross_replace_steps=self.cross_replace_steps,
            self_replace_steps=self.self_replace_steps,
            skip_optim_steps=int(self.skip_steps),
            latent_replace=self.latent_replace,
            optimize_steps=self.optimize_steps,
            fast_start_steps=self.fast_optim_steps,
            num_first_optim_steps=int(self.num_first_optim_steps),
            num_ddim_steps=int(self.num_ddim_steps),
            lr=self.lr,
            focal_length=self.cam_focal_length,
            obj_edit_step=1.0 - self.diffusion_correction,
            removal_loss_value=self.removal_loss_adaptive_value,
            splat=SplatConfig(
                radius=self.splatting_radius,
                tau=self.splatting_tau,
                points_per_pixel=int(self.splatting_points_per_pixel),
            ),
            loss_weights=self.loss_weight_table(edit_type),
        )


def _binarize(mask: np.ndarray) -> np.ndarray:
    return (np.asarray(mask, np.float32) > 0.5).astype(np.float32)


def load_image(state: UIState, image: np.ndarray, size: int = 512) -> np.ndarray:
    """Resize the upload to the working square (Pillow's default bicubic,
    as the JAX package's PIL resize)."""
    state.image_shape = image.shape[:2]
    state.image = png.to_rgb(png.resize_bicubic(np.asarray(image, np.uint8), size, size))
    state.mask = None
    state.depth = None
    return state.image


def get_mask(state: UIState, x_frac: float, y_frac: float) -> np.ndarray:
    """Click-to-SAM-mask (ui_utils.py:322-360)."""
    if state.image is None:
        raise RuntimeError("load an image first")
    if state.sam_predictor is None:
        raise RuntimeError("no SAM predictor configured (weights unavailable?)")
    state.mask = state.sam_predictor.mask_from_click(state.image, x_frac, y_frac)
    return state.mask


def set_mask(state: UIState, mask: np.ndarray) -> np.ndarray:
    state.mask = _binarize(mask)
    return state.mask


# the reference dropdown's backends (ui_utils.py:380-411,
# depth_predictor.py:105-370), each served by `utils/depth.py`
DEPTH_MODELS = (
    "depth_anything", "dpt_large", "dpt_hybrid", "dpt_hybrid_kitti",
    "dpt_hybrid_nyu", "midas_v21", "zoedepth", "zoedepth_nk", "constant",
)


def get_depth(state: UIState, model: str = "depth_anything",
              translate_factor: float = 0.7) -> np.ndarray:
    """Depth button (ui_utils.py:380-411): model choice and push-back factor.
    Returns the depth scaled to [0, 1] for display."""
    if state.image is None:
        raise RuntimeError("load an image first")
    h, w = state.image.shape[:2]
    if model == "constant":
        state.depth = depth_utils.constant_depth(h, w)
        return depth_utils.depth_scaler(state.depth)
    if model not in DEPTH_MODELS:
        raise ValueError(f"unknown depth model {model}; options: {DEPTH_MODELS}")
    pred = state.depth_predictors.get(model)
    if pred is None:
        if model == "depth_anything" and state.depth_predictor is not None:
            pred = state.depth_predictor
        else:
            pred = depth_utils.get_depth_predictor(model, device=state.device)
        state.depth_predictors[model] = pred
    state.depth = pred(state.image, translate_factor=translate_factor)
    return depth_utils.depth_scaler(state.depth)


def compose_transform_from_sliders(
    state: UIState,
    tx: float = 0.0, ty: float = 0.0, tz: float = 0.0,
    rx: float = 0.0, ry: float = 0.0, rz: float = 0.0,
    sx: float = 1.0, sy: float = 1.0, sz: float = 1.0,
) -> np.ndarray:
    """Slider ranges tx, ty, tz in [-.5, .5]; r in [-90, 90] degrees; s in
    [.5, 1.5]; composed T @ S @ Rx @ Ry @ Rz (ui_utils.py:529-555)."""
    state.transform = camera.compose_transform(tx, ty, tz, rx, ry, rz, sx, sy, sz)
    return state.transform


def get_transformed_preview(state: UIState, focal_length: float = 550.0,
                            splat: SplatConfig = SplatConfig()) -> np.ndarray:
    """"Check Transformed Image" (project_image, ui_utils.py:414-503): the
    warped image, orange where the object left and an olive amodal ring.
    The transform field and the splats run on the device, through the plain
    ops as in the JAX package (not the fused splat kernel)."""
    if state.image is None or state.mask is None or state.depth is None:
        raise RuntimeError("the preview needs an image, a mask and a depth")
    f32 = dict(dtype=torch.float32, device=state.device)
    mask = torch.as_tensor(np.asarray(state.mask, np.float32), **f32)
    kw = dict(radius=splat.radius, tau=splat.tau, z_beta=splat.z_beta)
    with torch.inference_mode():
        tf = tf_ops.build_transform_field(
            torch.as_tensor(np.asarray(state.image, np.float32) / 255.0, **f32),
            torch.as_tensor(np.asarray(state.depth, np.float32), **f32), mask,
            torch.as_tensor(np.asarray(state.transform, np.float32), **f32),
            focal_length=focal_length, splat_radius=splat.radius, splat_tau=splat.tau,
            z_beta=splat.z_beta)
        preview = (torch.clamp(tf.warped_preview, 0, 1) * 255).to(torch.uint8).cpu().numpy()
        amodal = tf.amodal_mask.cpu().numpy()
        warped_mask = (splat_ops.splat_image(mask[..., None], tf.coords, **kw)[..., 0] > 0.5
                       ).float().cpu().numpy()
    removed = np.clip(state.mask - warped_mask, 0, 1)
    ring = np.clip(amodal - warped_mask, 0, 1)
    out = preview.copy()
    out[removed > 0.5] = ORANGE
    out[ring > 0.5] = OLIVE
    return out


def _get_session(state: UIState, cfg: EditConfig) -> EditSession:
    # keyed on the whole config, as the JAX package keys its compiled
    # programs; each session keeps its in-memory inversion memo
    key = repr(cfg)
    if key not in state.sessions:
        state.sessions[key] = EditSession(state.pipeline, cfg, device=state.pipeline.device)
    return state.sessions[key]


def get_edited_image(state: UIState, prompt: str = "", cfg: Optional[EditConfig] = None,
                     adv: Optional[AdvancedOptions] = None, progress=None) -> np.ndarray:
    """"Move Object" (ui_utils.py:589-616); the advanced-accordion knobs pass
    through `adv` (geo_diff_ui.py:291-527)."""
    if state.image is None or state.mask is None or state.depth is None:
        raise RuntimeError("the edit needs an image, a mask and a depth")
    if cfg is None:
        cfg = (adv or AdvancedOptions()).to_edit_config("geometry_editor")
    res = _get_session(state, cfg).run(state.image, state.depth, state.mask, state.transform,
                                       prompt=prompt, progress=progress,
                                       exp_folder=state.inversion_cache_dir())
    return res.edited_image


# remover knob defaults of the reference inpaint tab (geo_diff_ui.py inpaint
# accordion, ui_utils.py:619-651)
REMOVER_ADVANCED_DEFAULTS = dict(
    guidance_scale=5.0, optimize_steps=0.85, latent_replace=0.4,
    cross_replace_steps=0.9, self_replace_steps=0.9,
)


def inpaint_mask(state: UIState, prompt: str = "", cfg: Optional[EditConfig] = None,
                 adv: Optional[AdvancedOptions] = None, progress=None) -> np.ndarray:
    """"Inpaint Mask" (ui_utils.py:619-651): constant depth, identity
    transform, the remover; `adv` carries the accordion's knobs."""
    if state.image is None or state.mask is None:
        raise RuntimeError("inpainting needs an image and a mask")
    h, w = state.image.shape[:2]
    if cfg is None:
        if adv is None:
            adv = AdvancedOptions(**REMOVER_ADVANCED_DEFAULTS)
        cfg = adv.to_edit_config("geometry_remover")
    res = _get_session(state, cfg).run(
        state.image, depth_utils.constant_depth(h, w), state.mask, np.eye(4),
        prompt=prompt, progress=progress, exp_folder=state.inversion_cache_dir())
    return res.edited_image


def save_experiment(state: UIState, root: str, category: str = "Mix",
                    result: Optional[np.ndarray] = None) -> str:
    """save_exp flow (ui_utils.py:52-109): the next numbered folder under
    the category."""
    cat_dir = os.path.join(root, category)
    os.makedirs(cat_dir, exist_ok=True)
    nums = [int(d) for d in os.listdir(cat_dir) if d.isdigit()]
    folder = os.path.join(cat_dir, str(max(nums, default=0) + 1))
    exp_io.save_exp(folder, state.image, state.depth, state.mask, state.transform,
                    result=result, background_image=state.background,
                    image_shape=state.image_shape)
    return folder


def load_experiment(state: UIState, folder: str) -> exp_io.Experiment:
    """read_exp flow (ui_utils.py:118-159)."""
    exp = exp_io.read_exp(folder)
    state.image = exp.input_image
    state.mask = _binarize(exp.input_mask)
    state.depth = exp.depth
    state.transform = exp.transform
    state.background = exp.background_image
    state.image_shape = tuple(int(v) for v in exp.image_shape[:2])
    return exp
