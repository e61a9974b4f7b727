"""Fused soft-z-buffer point splat: a CUDA kernel and its plain version.

Counterpart of `geodiffuser_tpu/kernels/splat.py:splat_image_fused` (the
Pallas `_splat_kernel`); the kernel is `csrc/splat.cu`.  Each source point s
lands on the 2x2 floor corners of its target position, and each output cell
o takes

    l[o, s]     = log alpha(o, s) - z_beta * z[s]
    out[o]      = softmax_s(l[o, :]) @ v * coverage[o]
    coverage[o] = 1 - exp(sum_s log1p(-clip(alpha(o, s), 0, 1 - 1e-4)))

over the corners valid there (alpha > 1e-6), and 0 in a cell that no corner
reaches, with alpha = (1 - sqrt(clip(d^2 / r^2, 0, 1)))^tau.  This is the
normalized splat of `ops/splat.splat_image` written as a softmax, without its
z-min pass and its 1e-8 denominator clamp (the two agree to ~2e-6).  No
gradient: every splat of the reference runs without one.

On the H100 the splat moves 12 + 8C bytes and does a few dozen operations
per point: memory and the latency of its dependent passes bound it, not
arithmetic.  The kernel is a gather, in one cooperative launch: points are
binned by their base cell (integer counts, a prefix sum, each bin sorted by
point index, a long bin by a whole block in O(L log L)), and each output
cell sums the points of the four base cells whose corners reach it in a
fixed order (a cell reached by thousands of points by a whole block, its
partial sums merged by a fixed tree).  It has no float atomics, so its
result is deterministic: two launches on the same inputs give equal bits.
Channels are independent and the weights depend only on the coordinates,
so one call on concatenated channels gives, bit for bit, what separate
calls give.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from geodiffuser_tpu_torch.kernels import _build

# launches of the wrapper's kernel (chip_smoke.py reads and resets it)
LAUNCHES = {"splat_fused": 0}

MISS_CLIP = 1.0 - 1e-4


def _out_size(src, out_hw) -> Tuple[int, int]:
    h, w, _ = src.shape
    return tuple(out_hw) if out_hw is not None else (h, w)


def _cell_sums(idx: torch.Tensor, vals: torch.Tensor, n_cells: int) -> torch.Tensor:
    """Sums of the rows of vals (N, K) by cell idx (N,) -> (n_cells, K), in
    an order fixed by the inputs alone: the rows sorted by cell (ties in row
    order), then each cell's run summed as a binary tree over its ranks.
    Elementwise adds only, so two calls give equal bits on either device
    (`index_add_` sums by atomics on the card, in an order that varies)."""
    key, order = torch.sort(idx, stable=True)
    val = vals[order]
    n = key.numel()
    pos = torch.arange(n, device=idx.device)
    rank = pos - torch.searchsorted(key, key)   # place in the cell's run
    longest = int(rank.max()) + 1 if n else 0
    step = 1
    while step < longest:   # rank r adds rank r + step's subtree where r % 2 step == 0
        partner = torch.clamp(pos + step, max=n - 1)
        take = (rank % (2 * step) == 0) & (pos + step < n) & (key[partner] == key)
        val = torch.where(take[:, None], val + val[partner], val)
        step *= 2
    out = torch.zeros((n_cells, vals.shape[1]), dtype=vals.dtype, device=vals.device)
    head = rank == 0
    out[key[head]] = val[head]
    return out


def splat_fused_plain(src: torch.Tensor, coords: torch.Tensor, radius: float = 1.3,
                      tau: float = 1.0, z_beta: float = 20.0,
                      out_hw: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Plain version by scatter ops: the corners' logits, a scatter-max per
    cell, then per-cell sums (`_cell_sums`, a fixed order) of exp(l - max) *
    v, exp(l - max) and the log-miss term.  src (H, W, C), coords (H, W, 3)
    NDC + z -> (H_out, W_out, C)."""
    h, w, c = src.shape
    oh, ow = _out_size(src, out_hw)
    n_out = oh * ow
    cf = coords.reshape(h * w, 3).float()
    x = (cf[:, 0] + 1.0) * 0.5 * (ow - 1)
    y = (cf[:, 1] + 1.0) * 0.5 * (oh - 1)
    z = cf[:, 2]
    fx, fy = torch.floor(x), torch.floor(y)
    # radius and tau in float32, as the JAX kernel takes them
    f32 = dict(dtype=torch.float32, device=src.device)
    r = torch.tensor(float(radius), **f32)
    r2 = torch.clamp(r * r, min=1e-8)
    tau_t = torch.tensor(float(tau), **f32)
    cells, logits, alphas = [], [], []
    for oy in (0.0, 1.0):
        for ox in (0.0, 1.0):
            cx, cy = fx + ox, fy + oy
            dx, dy = cx - x, cy - y
            d2 = dx * dx + dy * dy
            a = torch.pow(1.0 - torch.sqrt(torch.clamp(d2 / r2, 0.0, 1.0)), tau_t)
            valid = (cx >= 0) & (cx < ow) & (cy >= 0) & (cy < oh) & (a > 1e-6)
            cell = (torch.where(valid, cy, 0.0).long() * ow + torch.where(valid, cx, 0.0).long())
            cells.append(torch.where(valid, cell, n_out))   # n_out: the dump slot
            a = torch.where(valid, a, 0.0)
            logits.append(torch.where(valid, torch.log(torch.clamp(a, min=1e-30)) - z_beta * z,
                                      -1e30))
            alphas.append(a)
    idx, lg, a = torch.cat(cells), torch.cat(logits), torch.cat(alphas)
    m = torch.full((n_out + 1,), -float("inf"), **f32)
    m.scatter_reduce_(0, idx, lg, reduce="amax")
    e = torch.exp(lg - m[idx])
    v = src.reshape(h * w, c).float().repeat(4, 1)
    miss = torch.log1p(-torch.clamp(a, 0.0, MISS_CLIP))
    acc = _cell_sums(idx, torch.cat([e[:, None] * v, e[:, None], miss[:, None]], dim=-1),
                     n_out + 1)
    num, den, log_miss = acc[:-1, :c], acc[:-1, c:c + 1], acc[:-1, c + 1:]
    out = num / torch.clamp(den, min=1e-30) * (1.0 - torch.exp(log_miss))
    return torch.where(den > 0.0, out, 0.0).reshape(oh, ow, c)


def splat_fused_cuda(src: torch.Tensor, coords: torch.Tensor, radius: float, tau: float,
                     z_beta: float, out_hw: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """The kernel on contiguous float32 CUDA tensors."""
    _build.require_cuda(src, coords)
    if src.dtype != torch.float32 or coords.dtype != torch.float32:
        raise TypeError("src and coords must be float32")
    h, w, c = src.shape
    if coords.shape != (h, w, 3):
        raise ValueError(f"coords {tuple(coords.shape)} must be ({h}, {w}, 3)")
    oh, ow = _out_size(src, out_hw)
    lib = _build.lib()
    words = lib.gd_splat_workspace(h * w, oh, ow, c)
    if words < 0:
        raise ValueError(f"splat of {h}x{w} points onto {oh}x{ow} is too large")
    work = torch.empty((words,), dtype=torch.float32, device=src.device)
    out = torch.empty((oh, ow, c), dtype=torch.float32, device=src.device)
    err = lib.gd_splat_fused(
        src.data_ptr(), coords.data_ptr(), work.data_ptr(), out.data_ptr(), h * w, oh, ow, c,
        float(radius), float(tau), float(z_beta), _build.stream_ptr(src))
    _build.check(err, "gd_splat_fused")
    LAUNCHES["splat_fused"] += 1
    return out


def splat_fused(src: torch.Tensor, coords: torch.Tensor, radius: float = 1.3, tau: float = 1.0,
                z_beta: float = 20.0, out_hw: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Fused splat (src (H, W, C), coords (H, W, 3) NDC + z -> (H_out,
    W_out, C), float32): the kernel for CUDA tensors, the plain version for
    CPU tensors."""
    if src.is_cuda:
        return splat_fused_cuda(src.float().contiguous(), coords.float().contiguous(), radius,
                                tau, z_beta, out_hw)
    return splat_fused_plain(src, coords, radius, tau, z_beta, out_hw)
