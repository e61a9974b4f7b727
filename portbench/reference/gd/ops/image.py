"""Image-space helpers: counterpart of `geodiffuser_tpu/ops/image.py`
(reference generic_torch.py and image_processing.py:24-97)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def binarize(x: torch.Tensor, thresh: float = 0.5) -> torch.Tensor:
    """(x > thresh) as float32 (generic_torch.py:122-124)."""
    return (x > thresh).float()


def resize_bilinear(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Bilinear resize of (..., H, W) without antialiasing, half-pixel
    sampling (torchvision Resize(antialias=False)); matches the JAX
    package's `jax.image.resize(method="linear", antialias=False)`."""
    lead = x.shape[:-2]
    flat = x.float().reshape((-1, 1) + tuple(x.shape[-2:]))
    out = F.interpolate(flat, size=(height, width), mode="bilinear",
                        align_corners=False, antialias=False)
    return out.reshape(lead + (height, width))


def resize_bilinear_hwc(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Bilinear resize of (H, W, C) arrays."""
    return resize_bilinear(x.permute(2, 0, 1), height, width).permute(1, 2, 0)


def _box_counts(mask: torch.Tensor, kernel: int) -> torch.Tensor:
    """Sum of a (kernel x kernel) box around each pixel, zero ("SAME") padding."""
    lo = (kernel - 1) // 2
    hi = kernel - 1 - lo
    x = F.pad(mask.float()[None, None], (lo, hi, lo, hi))
    k = torch.ones((1, 1, kernel, kernel), dtype=torch.float32, device=mask.device)
    return F.conv2d(x, k)[0, 0]


def erode(mask: torch.Tensor, kernel: int = 3) -> torch.Tensor:
    """Binary erosion via box-count == k^2 (generic_torch.py:210-221); the
    border erodes, as with the reference's zero padding."""
    return (_box_counts(mask, kernel) >= float(kernel * kernel) - 0.5).float()


def dilate(mask: torch.Tensor, kernel: int = 3) -> torch.Tensor:
    """Binary dilation via box-count >= 1 (generic_torch.py:223-235)."""
    return (_box_counts(mask, kernel) >= 0.5).float()


def closing(mask: torch.Tensor, kernel: int = 3) -> torch.Tensor:
    return erode(dilate(mask, kernel), kernel)


def gaussian_kernel_1d(size: int, sigma: float | None = None) -> torch.Tensor:
    if sigma is None:
        sigma = (size // 2) * 2 / 6.0
    x = torch.arange(size, dtype=torch.float32) - (size - 1) / 2.0
    # the reference's non-standard exponent, see geodiffuser_tpu/ops/image.py
    k = torch.exp(-((x / (2.0 * sigma)) ** 2)) / (sigma * np.sqrt(2 * np.pi))
    return k / k.sum()


def gaussian_smooth_2d(x: torch.Tensor, size: int = 3, sigma: float | None = None) -> torch.Tensor:
    """Separable depthwise Gaussian blur of (..., H, W) arrays, zero padding
    (GaussianSmoothing, generic_torch.py:13-84)."""
    k1 = gaussian_kernel_1d(size, sigma).to(x.device)
    lead = x.shape[:-2]
    h, w = x.shape[-2:]
    flat = x.float().reshape(-1, 1, h, w)
    p = size // 2
    out = F.conv2d(flat, k1.reshape(1, 1, size, 1), padding=(p, 0))
    out = F.conv2d(out, k1.reshape(1, 1, 1, size), padding=(0, p))
    return out.reshape(lead + (h, w))


# ---------------------------------------------------------------------------
# Host-side (numpy) post-processing, once per edit.
# ---------------------------------------------------------------------------
