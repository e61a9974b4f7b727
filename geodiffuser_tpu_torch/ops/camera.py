"""Pinhole camera geometry: counterpart of `geodiffuser_tpu/ops/camera.py`
(reference warp_utils.py:495-747, vis_utils.py:79-88, ui_utils.py:529-555).

Images are (H, W, C); camera frame x-right, y-down, z-forward; NDC in
[-1, 1] with align_corners=True semantics.
"""

from __future__ import annotations

import numpy as np
import torch


def camera_matrix(focal: float, height: int, width: int, device=None) -> torch.Tensor:
    """Intrinsics with the principal point at the image center."""
    return torch.tensor(
        [[focal, 0.0, width / 2.0], [0.0, focal, height / 2.0], [0.0, 0.0, 1.0]],
        dtype=torch.float32, device=device,
    )


def rotate_axis(degrees: float, axis: int) -> np.ndarray:
    """Homogeneous 4x4 rotation about axis 0=x, 1=y, 2=z (warp_utils.py:182-222)."""
    r = np.radians(degrees)
    c, s = np.cos(r), np.sin(r)
    m = np.eye(4)
    if axis == 0:
        m[1, 1], m[1, 2], m[2, 1], m[2, 2] = c, -s, s, c
    elif axis == 1:
        m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, s, -s, c
    elif axis == 2:
        m[0, 0], m[0, 1], m[1, 0], m[1, 1] = c, -s, s, c
    else:
        raise ValueError(f"axis must be 0, 1 or 2, got {axis}")
    return m


def translate_matrix(x: float, y: float, z: float) -> np.ndarray:
    m = np.eye(4)
    m[:3, 3] = [x, y, z]
    return m


def scale_matrix(sx: float, sy: float, sz: float) -> np.ndarray:
    m = np.eye(4)
    m[0, 0], m[1, 1], m[2, 2] = sx, sy, sz
    return m


def compose_transform(tx=0.0, ty=0.0, tz=0.0, rx=0.0, ry=0.0, rz=0.0,
                      sx=1.0, sy=1.0, sz=1.0) -> np.ndarray:
    """UI slider composition T @ S @ Rx @ Ry @ Rz (ui_utils.py:529-555)."""
    m = translate_matrix(tx, ty, tz)
    m = m @ scale_matrix(sx, sy, sz)
    m = m @ rotate_axis(rx, 0)
    m = m @ rotate_axis(ry, 1)
    m = m @ rotate_axis(rz, 2)
    return m


def pixel_grid(height: int, width: int, device=None) -> torch.Tensor:
    """Homogeneous pixel coordinates (3, H*W), rows (x, y, 1)."""
    y = torch.arange(height, dtype=torch.float32, device=device)
    x = torch.arange(width, dtype=torch.float32, device=device)
    yy, xx = torch.meshgrid(y, x, indexing="ij")
    return torch.stack([xx, yy, torch.ones_like(xx)], dim=0).reshape(3, -1)


def pixel2cam(depth: torch.Tensor, intrinsics_inv: torch.Tensor) -> torch.Tensor:
    """Unproject (H, W) depth to (3, H, W) camera points (warp_utils.py:738-747)."""
    h, w = depth.shape
    rays = intrinsics_inv.float() @ pixel_grid(h, w, depth.device)
    return rays.reshape(3, h, w) * depth[None].float()


def recenter_transform(transform: torch.Tensor, cam_coords: torch.Tensor,
                       obj_mask: torch.Tensor) -> torch.Tensor:
    """Tr(+c) @ transform @ Tr(-c), c = centroid of the masked points
    (warp_utils.py:421-435)."""
    m = (obj_mask >= 0.5).float().reshape(1, -1)
    pts = cam_coords.reshape(3, -1)
    denom = torch.clamp(m.sum(), min=1.0)
    center = (pts * m).sum(dim=-1) / denom
    t_neg = torch.eye(4, dtype=torch.float32, device=cam_coords.device)
    t_pos = t_neg.clone()
    t_neg[:3, 3] = -center
    t_pos[:3, 3] = center
    return t_pos @ transform.float() @ t_neg


def cam2pixel(cam_coords: torch.Tensor, rot: torch.Tensor, tr: torch.Tensor,
              intrinsics: torch.Tensor, z_min: float = 1e-3) -> torch.Tensor:
    """Transform + project camera points to (H, W, 3) (x_ndc, y_ndc, z),
    z clamped to >= z_min (cam2pixel_vanilla, warp_utils.py:599-645)."""
    _, h, w = cam_coords.shape
    flat = cam_coords.reshape(3, -1).float()
    p = rot.float() @ flat + tr.float().reshape(3, 1)
    p = intrinsics.float() @ p
    z = torch.clamp(p[2], min=z_min)
    x_ndc = 2.0 * (p[0] / z) / (w - 1) - 1.0
    y_ndc = 2.0 * (p[1] / z) / (h - 1) - 1.0
    return torch.stack([x_ndc, y_ndc, z], dim=-1).reshape(h, w, 3)


def transform_field(depth: torch.Tensor, intrinsics: torch.Tensor, transform: torch.Tensor,
                    obj_mask: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) target (x_ndc, y_ndc, z) of every pixel under a 4x4 edit
    transform: unproject with `depth`, recenter the transform about the
    masked object's centroid, reproject (forward_splatting_pytorch3d_warp,
    warp_utils.py:407-444, without the splat)."""
    cam = pixel2cam(depth, torch.linalg.inv(intrinsics.float()))
    t = recenter_transform(transform, cam, obj_mask)
    return cam2pixel(cam, t[:3, :3], t[:3, 3:4], intrinsics)


def identity_field(height: int, width: int, device=None) -> torch.Tensor:
    """Every pixel maps to itself at z=1."""
    y = torch.linspace(-1.0, 1.0, height, dtype=torch.float32, device=device)
    x = torch.linspace(-1.0, 1.0, width, dtype=torch.float32, device=device)
    yy, xx = torch.meshgrid(y, x, indexing="ij")
    return torch.stack([xx, yy, torch.ones_like(xx)], dim=-1)


def cam2pixel_occlusion(cam_coords: torch.Tensor, rot: torch.Tensor, tr: torch.Tensor,
                        intrinsics: torch.Tensor, far_clip: float = 100.0) -> torch.Tensor:
    """Occlusion-aware backward-sampling field (the reference's `cam2pixel`,
    warp_utils.py:495-595, used by `forward_warp` :768-795): each source
    pixel's forward delta is written at its rounded target cell, the
    nearest in z winning (ties to the lowest source index); cells no pixel
    reaches keep their own delta.  Returns (H, W, 2) NDC sampling
    coordinates src - delta (align_corners=True)."""
    _, h, w = cam_coords.shape
    flat = cam_coords.reshape(3, -1).float()
    p = rot.float() @ flat + tr.float().reshape(3, 1)
    far = p[2] > far_clip
    p = intrinsics.float() @ p
    z = torch.clamp(p[2], min=1e-8)
    x_ndc = 2.0 * (p[0] / z) / (w - 1) - 1.0
    y_ndc = 2.0 * (p[1] / z) / (h - 1) - 1.0

    grid = pixel_grid(h, w, cam_coords.device)
    src = torch.stack([2.0 * grid[0] / (w - 1) - 1.0, 2.0 * grid[1] / (h - 1) - 1.0], dim=-1)
    tgt = torch.stack([x_ndc, y_ndc], dim=-1)
    tgt = torch.where(far[:, None], src, tgt)            # far clip -> identity
    delta = tgt - src

    ty = torch.clamp(torch.round((tgt[:, 1] + 1.0) * 0.5 * (h - 1)), 0, h - 1)
    tx = torch.clamp(torch.round((tgt[:, 0] + 1.0) * 0.5 * (w - 1)), 0, w - 1)
    t_idx = (ty * w + tx).long()
    zmin = torch.full((h * w,), float("inf"), device=z.device).scatter_reduce(
        0, t_idx, z, reduce="amin")
    is_near = z <= zmin[t_idx]
    src_idx = torch.arange(h * w, device=z.device)
    first = torch.full((h * w,), 2 ** 30, dtype=torch.long, device=z.device).scatter_reduce(
        0, t_idx, torch.where(is_near, src_idx, torch.full_like(src_idx, 2 ** 30)), reduce="amin")
    winner = is_near & (src_idx == first[t_idx])
    delta_grid = delta.clone()
    delta_grid[t_idx[winner]] = delta[winner]
    return (src - delta_grid).reshape(h, w, 2)


def backward_warp(image: torch.Tensor, field: torch.Tensor) -> torch.Tensor:
    """Bilinear backward warp of (H, W, C) by an (H, W, 2) NDC field
    (align_corners=True, zero padding): the consumer of
    cam2pixel_occlusion (forward_warp, warp_utils.py:768-795)."""
    h, w, _ = image.shape
    x = (field[..., 0] + 1.0) * 0.5 * (w - 1)
    y = (field[..., 1] + 1.0) * 0.5 * (h - 1)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    out = torch.zeros_like(image)
    for dy in (0.0, 1.0):
        for dx in (0.0, 1.0):
            cx = x0 + dx
            cy = y0 + dy
            wgt = (1.0 - torch.abs(x - cx)) * (1.0 - torch.abs(y - cy))
            valid = (cx >= 0) & (cx < w) & (cy >= 0) & (cy < h)
            cxc = torch.clamp(cx, 0, w - 1).long()
            cyc = torch.clamp(cy, 0, h - 1).long()
            wgt = torch.where(valid, wgt, torch.zeros_like(wgt))
            out = out + image[cyc, cxc] * wgt[..., None]
    return out
