"""Warping: soft z-buffer point splatting, backward sampling and summation
splatting, the counterpart of `geodiffuser_tpu/ops/splat.py` (replacing the
reference's PyTorch3D rasterizer, warp_utils.py:28-176, its `warp_grid_edit`
dispatcher, warp_utils.py:798-837, and softsplat.py).

The splat has two passes: a scatter-min of depth per target pixel
(`scatter_reduce_` "amin"), then a scatter-add (`index_add_`) of
weight * feature, weight and the alpha-over coverage term, with
    weight = alpha_spatial * exp(-z_beta * (z - zmin[pixel])),
    alpha_spatial = (1 - sqrt(clip(d^2 / r^2, 0, 1)))^tau.
Corners are bucketed with an fp32 `floor`, as in the JAX package.  On CUDA
`index_add_` adds with atomics in a run-dependent order, so results may
differ between runs by float32 rounding (a few ulp of the sums).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from geodiffuser_tpu_torch.ops import image as image_ops


def _corner_data(coords: torch.Tensor, height: int, width: int, radius: float,
                 tau: float, footprint: int):
    """Corner-major per-point splat targets: entry k*N + p is corner k of
    point p.  Returns flat target indices (H*W is the dump slot for dropped
    corners), spatial alphas and depths, each (F*F*N,)."""
    n = coords.shape[0]
    x = (coords[:, 0] + 1.0) * 0.5 * (width - 1)
    y = (coords[:, 1] + 1.0) * 0.5 * (height - 1)
    z = coords[:, 2]
    base_x = torch.floor(x).to(torch.int64)
    base_y = torch.floor(y).to(torch.int64)
    offs = torch.arange(footprint, dtype=torch.int64, device=coords.device) - (footprint - 1) // 2
    ox = offs.repeat_interleave(footprint)
    oy = offs.repeat(footprint)
    cx = base_x[None, :] + ox[:, None]
    cy = base_y[None, :] + oy[:, None]
    dx = cx.float() - x[None, :]
    dy = cy.float() - y[None, :]
    d2 = dx * dx + dy * dy
    # radius and tau in float32, as the JAX package traces them
    f32 = dict(dtype=torch.float32, device=coords.device)
    r = torch.tensor(float(radius), **f32)
    r2 = torch.clamp(r * r, min=1e-8)
    a = torch.pow(1.0 - torch.sqrt(torch.clamp(d2 / r2, 0.0, 1.0)), torch.tensor(float(tau), **f32))
    in_bounds = (cx >= 0) & (cx < width) & (cy >= 0) & (cy < height)
    valid = in_bounds & (a > 1e-6)
    flat_idx = torch.where(valid, cy * width + cx, torch.full_like(cx, height * width))
    zc = z[None, :].expand(footprint * footprint, n)
    return (flat_idx.reshape(-1), torch.where(valid, a, torch.zeros_like(a)).reshape(-1),
            zc.reshape(-1))


def _zref(idx, alpha, z, n_out):
    """Hard z-min per target pixel, read back per corner (the z-buffer)."""
    zmin = torch.full((n_out + 1,), float("inf"), dtype=torch.float32, device=z.device)
    zmin.scatter_reduce_(0, idx, torch.where(alpha > 0.0, z, torch.full_like(z, float("inf"))),
                         reduce="amin")
    zref = zmin[idx]
    return torch.where(torch.isfinite(zref), zref, torch.zeros_like(zref))


def _log_miss(alpha):
    return torch.log1p(-torch.clamp(alpha, 0.0, 1.0 - 1e-4))


def splat_image(src: torch.Tensor, coords: torch.Tensor, radius: float = 1.3,
                tau: float = 1.0, z_beta: float = 20.0, footprint: int = 2) -> torch.Tensor:
    """Forward-splat an (H, W, C) image along an (H, W, 3) coordinate field
    (the reference's SPLATTER, warp_utils.py:74-176); zero where nothing lands."""
    h, w, c = src.shape
    n = h * w
    idx, alpha, z = _corner_data(coords.reshape(n, 3).float(), h, w, radius, tau, footprint)
    wgt = alpha * torch.exp(-z_beta * torch.clamp(z - _zref(idx, alpha, z, n), min=0.0))
    feats = src.reshape(n, c).float().repeat(footprint * footprint, 1)
    stacked = torch.cat([wgt[:, None] * feats, wgt[:, None], _log_miss(alpha)[:, None]], dim=-1)
    acc = torch.zeros((n + 1, c + 2), dtype=torch.float32, device=src.device)
    acc.index_add_(0, idx, stacked)
    num, den, log_miss = acc[:-1, :c], acc[:-1, c], acc[:-1, c + 1]
    coverage = 1.0 - torch.exp(log_miss)
    out = num / torch.clamp(den[:, None], min=1e-8) * coverage[:, None]
    return out.reshape(h, w, c)


def densified_mask_splat(mask: torch.Tensor, coords: torch.Tensor, upsample: int = 2,
                         radius: float = 1.3, tau: float = 1.0, z_beta: float = 20.0,
                         close_kernel: int = 3) -> torch.Tensor:
    """Amodal (hole-free) projected object mask: densify the field
    `upsample`x, splat surface coverage, binarize, close (the TPU package's
    stand-in for the reference's mesh rasterization, warp_utils.py:235-399)."""
    h, w = mask.shape
    hh, ww = h * upsample, w * upsample
    coords_up = image_ops.resize_bilinear_hwc(coords, hh, ww)
    mask_up = image_ops.resize_bilinear(mask.float(), hh, ww)
    n = hh * ww
    idx, alpha, _ = _corner_data(coords_up.reshape(n, 3).float(), h, w, radius, tau, 2)
    m_rep = mask_up.reshape(n).repeat(4)
    stacked = torch.stack([alpha * m_rep, alpha, _log_miss(alpha)], dim=-1)
    acc = torch.zeros((h * w + 1, 3), dtype=torch.float32, device=mask.device)
    acc.index_add_(0, idx, stacked)
    coverage = 1.0 - torch.exp(acc[:-1, 2])
    out = acc[:-1, 0] / torch.clamp(acc[:-1, 1], min=1e-8) * coverage
    amodal = image_ops.binarize(out.reshape(h, w), 0.5)
    return image_ops.closing(amodal, close_kernel)


def warp_matrix(coords: torch.Tensor, radius: float = 1.3, tau: float = 1.0,
                z_beta: float = 20.0, footprint: int = 2) -> torch.Tensor:
    """The splat as a dense (L, L) operator W: splat_image(src) == W @ src.

    Each (target, source) entry receives at most one corner of one point,
    so the accumulating `index_put_` is exact on every device."""
    h, w = coords.shape[:2]
    n = h * w
    idx, alpha, z = _corner_data(coords.reshape(n, 3).float(), h, w, radius, tau, footprint)
    wgt = alpha * torch.exp(-z_beta * torch.clamp(z - _zref(idx, alpha, z, n), min=0.0))
    src_idx = torch.arange(n, device=coords.device).repeat(footprint * footprint)
    mat = torch.zeros((n + 1, n), dtype=torch.float32, device=coords.device)
    mat.index_put_((idx, src_idx), wgt, accumulate=True)
    den = mat.sum(dim=1, keepdim=True)
    log_miss = torch.zeros((n + 1,), dtype=torch.float32, device=coords.device)
    log_miss.index_add_(0, idx, _log_miss(alpha))
    coverage = 1.0 - torch.exp(log_miss)
    mat = mat / torch.clamp(den, min=1e-8) * coverage[:, None]
    return mat[:-1]


def apply_warp_matrix(mat: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """(..., L_out, L_in) @ (..., H, W, C) -> (..., H_out, W_out, C),
    accumulating in the operator's type; leading axes (a group's edits) pair
    each operator with its image."""
    *lead, h, w, c = src.shape
    side = int(mat.shape[-2] ** 0.5)
    out = mat @ src.reshape(*lead, h * w, c).to(mat.dtype)
    return out.reshape(*lead, side, side, c).to(src.dtype)


def splat_batch(src: torch.Tensor, coords: torch.Tensor, **kw) -> torch.Tensor:
    """`splat_image` over a leading batch axis of (B, H, W, C) / (B, H, W, 3)."""
    return torch.stack([splat_image(s, c, **kw) for s, c in zip(src, coords)])


def grid_sample(src: torch.Tensor, coords: torch.Tensor, padding: str = "zeros") -> torch.Tensor:
    """Backward warp (gather): sample (H, W, C) at (H', W', 2) NDC locations,
    bilinear with align_corners=True (the reference's fallback path,
    warp_utils.py:826-837, forward_warp warp_utils.py:768-795).  `padding`
    "zeros" or "reflection" (mirrored about the edge pixels)."""
    if padding not in ("zeros", "reflection"):
        raise ValueError(f"unknown grid_sample padding {padding!r}")
    x = src.float().permute(2, 0, 1)[None]
    out = F.grid_sample(x, coords[None, ..., :2].float(), mode="bilinear", padding_mode=padding,
                        align_corners=True)
    return out[0].permute(1, 2, 0)


def warp_field(src: torch.Tensor, coords: torch.Tensor, radius: float = 1.3, tau: float = 1.0,
               z_beta: float = 20.0, use_splat: bool = True, padding: str = "zeros"
               ) -> torch.Tensor:
    """The single warp entry point (role of warp_grid_edit,
    warp_utils.py:798-837).  src (H, W, C); coords (H, W, 3) for splatting
    or (..., 2/3) for sampling."""
    if use_splat:
        return splat_image(src, coords, radius=radius, tau=tau, z_beta=z_beta)
    return grid_sample(src, coords[..., :2], padding=padding)


# ---------------------------------------------------------------------------
# softsplat (summation splatting), reference softsplat.py:232-273: bilinear
# scatter-add of the input along a pixel-offset flow; the modes add a
# normalisation channel:
#   sum     raw scatter-add                       (metric unused)
#   avg     append a ones channel, divide by it
#   linear  splat (in*metric | metric), divide
#   soft    splat (in*e^metric | e^metric), divide
# autograd differentiates the scatter-add, as the reference's hand-written
# backward (softsplat.py:357-520) does.
# ---------------------------------------------------------------------------

def _bilinear_scatter(src: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """(H, W, C) src + (H, W, 2) pixel-offset flow -> (H, W, C) scatter-add;
    corners outside the image are dropped (softsplat.py:316-341)."""
    h, w, c = src.shape
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=src.device),
                            torch.arange(w, dtype=torch.float32, device=src.device),
                            indexing="ij")
    tx = xx + flow[..., 0]
    ty = yy + flow[..., 1]
    x0 = torch.floor(tx)
    y0 = torch.floor(ty)
    flat = src.reshape(h * w, c)
    out = torch.zeros((h * w + 1, c), dtype=src.dtype, device=src.device)
    for dy in (0.0, 1.0):
        for dx in (0.0, 1.0):
            cx = x0 + dx
            cy = y0 + dy
            # per-axis bounds: a flat index would let a column overflow into
            # the next row
            valid = (cx >= 0) & (cx < w) & (cy >= 0) & (cy < h)
            wgt = (1.0 - torch.abs(tx - cx)) * (1.0 - torch.abs(ty - cy))
            wgt = torch.where(valid, wgt, torch.zeros_like(wgt)).reshape(-1, 1)
            idx = torch.where(valid, cy * w + cx, torch.full_like(cx, h * w)).long().reshape(-1)
            out = out.index_add(0, idx, flat * wgt.to(src.dtype))
    return out[:-1].reshape(h, w, c)


def softsplat(src: torch.Tensor, flow: torch.Tensor, metric: torch.Tensor | None = None,
              mode: str = "soft") -> torch.Tensor:
    """Differentiable forward warping with the reference's mode semantics
    (softsplat.py:232-273).  src (H, W, C), flow (H, W, 2) in pixels, metric
    (H, W) or (H, W, 1); eps variants '<mode>-addeps' (the default of bare
    avg/linear/soft), '<mode>-zeroeps', '<mode>-clipeps'."""
    base, _, eps_kind = mode.partition("-")
    if base not in ("sum", "avg", "linear", "soft"):
        raise ValueError(f"unknown softsplat mode {mode!r}")
    if eps_kind not in ("", "addeps", "zeroeps", "clipeps"):
        raise ValueError(f"unknown softsplat eps variant {mode!r}")
    if base in ("sum", "avg") and metric is not None:
        raise ValueError(f"mode {base} takes no metric")
    if base in ("linear", "soft") and metric is None:
        raise ValueError(f"mode {base} needs a metric")
    if metric is not None and metric.ndim == 2:
        metric = metric[..., None]

    if base == "sum":
        return _bilinear_scatter(src, flow)
    if base == "avg":
        stacked = torch.cat([src, torch.ones_like(src[..., :1])], dim=-1)
    elif base == "linear":
        stacked = torch.cat([src * metric, metric], dim=-1)
    else:  # soft
        e = torch.exp(metric)
        stacked = torch.cat([src * e, e], dim=-1)

    out = _bilinear_scatter(stacked, flow)
    norm = out[..., -1:]
    if eps_kind in ("", "addeps"):
        norm = norm + 1e-7
    elif eps_kind == "zeroeps":
        norm = torch.where(norm == 0.0, torch.ones_like(norm), norm)
    else:  # clipeps
        norm = torch.clamp(norm, min=1e-7)
    return out[..., :-1] / norm
