"""Point-prompted segmentation around the port's SAM.

Counterpart of `geodiffuser_tpu/utils/segmentation.py` (the reference's
SamPredictor flow behind the UI's mask click, get_mask_prediction,
depth_predictor.py:53-102; ui_utils.py:322-360): scale the longer side to
the model's input size, SAM's pixel normalization, zero-pad to a square,
encode once, then a cheap decode a click; the last (largest-scale) mask is
the one used, as the reference takes `masks[-1]` (depth_predictor.py:73).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from geodiffuser_tpu_torch.core.pipeline import resolve_device
from geodiffuser_tpu_torch.models import weights as weights_lib
from geodiffuser_tpu_torch.models.layers import seeded_init_
from geodiffuser_tpu_torch.models.sam import Sam, SamConfig
from geodiffuser_tpu_torch.ops import image as image_ops

SAM_PIXEL_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
SAM_PIXEL_STD = np.array([58.395, 57.12, 57.375], np.float32)
# parameters and buffers drawn N(0, 1) by the random init (SAM initializes
# its point embeddings and Fourier matrix so)
UNIT_NORMAL = ("positional_encoding_gaussian_matrix", "embed.weight", "embeddings.0.weight",
               "embeddings.1.weight", "embeddings.2.weight", "embeddings.3.weight",
               "iou_token.weight", "mask_tokens.weight")


class SamPredictor:
    """SAM on `device`.  Weights: the published `.pth` at `checkpoint_path`,
    else `state_dict` (the port's names), else random from `seed`."""

    def __init__(self, config: Optional[SamConfig] = None, checkpoint_path: Optional[str] = None,
                 state_dict: Optional[Dict[str, torch.Tensor]] = None, device="cuda",
                 seed: int = 0):
        self.device = resolve_device(device)
        self.cfg = config or SamConfig.vit_h()
        with self.device:
            self.model = Sam(self.cfg).eval().requires_grad_(False)
        if checkpoint_path:
            state_dict = weights_lib.read_checkpoint(checkpoint_path, "sam_vit_h.json")
        if state_dict is None:
            seeded_init_(self.model, torch.Generator(self.device).manual_seed(seed), UNIT_NORMAL)
        else:
            weights_lib.load_perception_model(self.model, state_dict, "sam")
        self.mean = torch.from_numpy(SAM_PIXEL_MEAN).to(self.device)
        self.std = torch.from_numpy(SAM_PIXEL_STD).to(self.device)
        self._embedding: Optional[torch.Tensor] = None
        self._orig_hw: Tuple[int, int] = (0, 0)
        self._scale = 1.0

    def _resized_hw(self) -> Tuple[int, int]:
        h, w = self._orig_hw
        return int(round(h * self._scale)), int(round(w * self._scale))

    def set_image(self, image: np.ndarray) -> None:
        """(H, W, 3) uint8 (or float in [0, 1]) -> the cached image embedding."""
        img = np.asarray(image)
        if img.max() <= 1.5:
            img = img * 255.0
        h, w = img.shape[:2]
        size = self.cfg.img_size
        self._orig_hw = (h, w)
        self._scale = size / max(h, w)
        nh, nw = self._resized_hw()
        with torch.inference_mode():
            x = torch.as_tensor(np.asarray(img, np.float32), device=self.device)
            x = (image_ops.resize_bilinear_hwc(x, nh, nw) - self.mean) / self.std
            x = F.pad(x, (0, 0, 0, size - nw, 0, size - nh))
            self._embedding = self.model.encode_image(x[None])

    def predict_logits(self, points: np.ndarray, labels: np.ndarray
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """points (N, 2) xy in original-image pixels, labels (N,) in {0, 1}
        -> (mask logits (4, H, W), iou (4,)) on the device."""
        if self._embedding is None:
            raise RuntimeError("call set_image first")
        size = self.cfg.img_size
        with torch.inference_mode():
            pts = torch.as_tensor(np.asarray(points, np.float32)[None] * self._scale,
                                  device=self.device)
            lbl = torch.as_tensor(np.asarray(labels, np.int32)[None], device=self.device)
            low_res, iou = self.model.predict_masks(self._embedding, pts, lbl)
            nh, nw = self._resized_hw()
            masks = image_ops.resize_bilinear(low_res[0], size, size)[:, :nh, :nw]
            return image_ops.resize_bilinear(masks, *self._orig_hw), iou[0]

    def predict(self, points: np.ndarray, labels: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(masks (4, H, W) bool, iou (4,)); masks[-1] is the largest-scale
        mask the reference uses."""
        logits, iou = self.predict_logits(points, labels)
        return (logits > 0.0).cpu().numpy(), iou.cpu().numpy()

    def mask_from_click(self, image: np.ndarray, x_frac: float, y_frac: float) -> np.ndarray:
        """One normalized click -> (H, W) float32 binary mask
        (get_mask_prediction, depth_predictor.py:78-102)."""
        self.set_image(image)
        h, w = image.shape[:2]
        masks, _ = self.predict(np.array([[w * x_frac, h * y_frac]]), np.array([1]))
        return masks[-1].astype(np.float32)
