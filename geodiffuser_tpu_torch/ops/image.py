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


def jax_resize_weights(in_size: int, out_size: int, kernel, device) -> torch.Tensor:
    """(in_size, out_size) float32 weights of JAX's `compute_weight_mat`
    (jax/_src/image/scale.py) with antialiasing, for `kernel` (a function of
    the distance in input pixels): half-pixel centres, the kernel widened by
    the reduction factor when the axis shrinks, the weights normalised per
    output position, zero where the sample lies outside the input."""
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    src = torch.arange(in_size, dtype=torch.float32, device=device)
    w = kernel((sample[None, :] - src[:, None]).abs() / kernel_scale)
    total = w.sum(0, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    w = torch.where(total.abs() > eps, w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - x.abs(), min=0.0)


def resize_linear_jax(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """`jax.image.resize(method="linear")` with its default antialiasing over
    the last two axes of a float32 array: one separable pass a resized axis,
    height first.  Equal to `resize_bilinear` where an axis grows; where it
    shrinks, the triangle is widened by the reduction factor (F.interpolate
    has no such kernel: its antialias option is another filter)."""
    h, w = x.shape[-2:]
    x = x.float()
    if height != h:
        x = torch.einsum("...hw,ho->...ow", x, jax_resize_weights(h, height, _triangle, x.device))
    if width != w:
        x = torch.einsum("...hw,wo->...ho", x, jax_resize_weights(w, width, _triangle, x.device))
    return x


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


def max_pool_same(mask: torch.Tensor, k: int = 1) -> torch.Tensor:
    """(2k+1)-window max pool of an (H, W) map at stride 1, same size
    (the reference's smooth_mask, attention_sharing.py:50-65)."""
    window = 2 * k + 1
    return F.max_pool2d(mask.float()[None, None], window, stride=1, padding=k)[0, 0]


def adain(feat: torch.Tensor, feat_ref: torch.Tensor, dim: int = -2, eps: float = 1e-5
          ) -> torch.Tensor:
    """Adaptive instance normalization along `dim` (generic_torch.py:237-253)."""
    mean = feat.mean(dim=dim, keepdim=True)
    std = torch.sqrt(feat.var(dim=dim, keepdim=True, unbiased=False) + eps)
    mean_r = feat_ref.mean(dim=dim, keepdim=True)
    std_r = torch.sqrt(feat_ref.var(dim=dim, keepdim=True, unbiased=False) + eps)
    return (feat - mean) / std * std_r + mean_r


def norm_tensor(a: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Frobenius norm (generic_torch.py:87-88)."""
    return torch.sqrt(torch.sum(a * a) + eps)


# ---------------------------------------------------------------------------
# Host-side (numpy) post-processing, once per edit.
# ---------------------------------------------------------------------------

def _match_cumulative_cdf(source, template, mask, mask_source) -> np.ndarray:
    """Masked CDF histogram matching of one uint8 channel
    (image_processing.py:24-64)."""
    if mask is None:
        mask = np.ones_like(source, dtype=np.float32)
    if mask_source is None:
        mask_source = mask
    src_vals = source[mask_source > 0.5].reshape(-1)
    tmpl_vals = template[mask > 0.5].reshape(-1)
    if src_vals.size == 0 or tmpl_vals.size == 0:
        return source.astype(np.float64)
    src_counts = np.bincount(src_vals, minlength=256)
    tmpl_counts = np.bincount(tmpl_vals, minlength=256)
    levels = np.linspace(0, 255, 256)
    src_quantiles = np.cumsum(src_counts) / src_vals.size
    tmpl_quantiles = np.cumsum(tmpl_counts) / tmpl_vals.size
    lut = np.interp(src_quantiles, tmpl_quantiles, levels)
    return lut[source.reshape(-1)].reshape(source.shape)


def masked_histogram_matching(source, template, mask=None, mask_source=None) -> np.ndarray:
    """Per-channel masked histogram matching of uint8 images
    (image_processing.py:67-77)."""
    source = np.asarray(source).astype(np.uint8)
    template = np.asarray(template).astype(np.uint8)
    out = [
        _match_cumulative_cdf(source[..., c], template[..., c], mask, mask_source)
        for c in range(source.shape[-1])
    ]
    return np.stack(out, axis=-1)
