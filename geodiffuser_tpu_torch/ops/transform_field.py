"""Transform-field builder: image + depth + mask + 4x4 -> per-pixel targets.

Counterpart of `geodiffuser_tpu/ops/transform_field.py` (reference
vis_utils.get_transform_coordinates, vis_utils.py:404-479).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from geodiffuser_tpu_torch.ops import camera, splat
from geodiffuser_tpu_torch.ops import image as image_ops


class TransformField(NamedTuple):
    coords: torch.Tensor          # (H, W, 3) target (x_ndc, y_ndc, z)
    warped_preview: torch.Tensor  # (H, W, C) splat-warped input image
    amodal_mask: torch.Tensor     # (H, W) hole-free projected object mask
    valid: torch.Tensor           # (H, W) in-frustum mask


def preprocess_depth(depth: torch.Tensor, constant_tol: float = 1e-6) -> torch.Tensor:
    """Constant depth (0.5 everywhere) passes through; otherwise d / d.max()
    with far clip d > 0.95 -> 1.0 (vis_utils.py:409-423)."""
    d = depth.float()
    is_constant = torch.abs(torch.sum(d) - 0.5 * d.numel()) < constant_tol
    dn = d / (d.max() + 1e-8)
    dn = torch.where(dn > 0.95, torch.ones_like(dn), dn)
    return torch.where(is_constant, torch.full_like(d, 0.5), dn)


def build_transform_field(image: torch.Tensor, depth: torch.Tensor, obj_mask: torch.Tensor,
                          transform: torch.Tensor, focal_length: float = 550.0,
                          splat_radius: float = 1.3, splat_tau: float = 1.0,
                          z_beta: float = 20.0, amodal_upsample: int = 4) -> TransformField:
    """get_transform_coordinates + forward_splatting_pytorch3d_warp
    (vis_utils.py:404-479, warp_utils.py:407-492)."""
    h, w = depth.shape
    d = preprocess_depth(depth)
    center_mask = image_ops.binarize(obj_mask) * (d < 0.95).float()
    k = camera.camera_matrix(focal_length, h, w, depth.device)
    cam = camera.pixel2cam(d, torch.linalg.inv(k))
    t = camera.recenter_transform(transform.float(), cam, center_mask)
    coords = camera.cam2pixel(cam, t[:3, :3], t[:3, 3:4], k)
    preview = splat.splat_image(image.float(), coords, radius=splat_radius, tau=splat_tau,
                                z_beta=z_beta)
    valid = (torch.amax(torch.abs(coords[..., :2]), dim=-1) <= 1.0).float()
    preview = preview * valid[..., None]
    amodal = splat.densified_mask_splat(
        image_ops.binarize(obj_mask), coords, upsample=amodal_upsample,
        radius=splat_radius, tau=splat_tau, z_beta=z_beta,
    )
    return TransformField(coords=coords, warped_preview=preview, amodal_mask=amodal, valid=valid)
