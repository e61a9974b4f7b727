"""GroupNorm (+ SiLU) on channels-last activations: CUDA kernels and their
plain version.

Replaces no Pallas kernel (the JAX package leaves GroupNorm to XLA); the
kernels are `csrc/group_norm.cu`.  The port's UNet and VAE keep every
activation channels-last, (N, C, H, W) with N, H, W, C in memory, because
cuDNN's bf16 Hopper convolutions are NHWC; ATen's CUDA GroupNorm takes only
NCHW-contiguous input.  `group_norm` computes

    y = act((x - mean) * rstd * weight + bias),  act = SiLU or identity,

mean and biased variance over each group's C/G channels and all pixels of
a sample, float32 statistics, the output in x's type and layout.  It launches
the kernels for CUDA tensors (differentiable in x: the backward is a pair of
kernels too; the models' norms are frozen, so weight and bias take no
gradient there) and takes the plain version only for CPU tensors.

GroupNorm is bound by bytes on the H100: the forward reads the activation
twice (statistics, then apply) and writes it once, the backward reads x and
dy twice and writes dx once.  `plan` cuts each sample into pixel tiles, a
block each: enough blocks to fill the card at batch 1, fewer, larger tiles
when the batch alone fills it, every tile at least `MIN_TILE_BYTES`.  With
the SiLU fused, the backward needs only x and the (N, G) statistics, not the
SiLU's input.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from geodiffuser_tpu_torch.kernels import _build

# launches of each wrapper's kernel pair (chip_smoke.py reads and resets it)
LAUNCHES = {"group_norm_fwd": 0, "group_norm_bwd": 0}

SMS = 132                    # streaming multiprocessors of the H100 SXM
THREADS = 256                # threads a block (csrc/group_norm.cu GN_NT)
BLOCKS_PER_SM = 4            # blocks the tiling aims at, over the whole grid
MAX_TILES = SMS              # tiles a sample at most (csrc GN_MAX_TILES 160): each apply
                             # block merges G * tiles partials
MIN_TILE_BYTES = 8 << 10     # bytes a tile at least
MAX_CHANNELS = 4096
MAX_GROUPS = 1024


def group_norm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int,
                     eps: float, silu: bool = False) -> torch.Tensor:
    """Plain version over the (N, H*W, G, C/G) view of a channels-last x,
    in float32, with the JAX package's (flax's) statistics: the variance as
    E[x^2] - E[x]^2, clipped at 0.  The output in x's type, channels-last.
    Differentiable by autograd."""
    n, c, h, w = x.shape
    xf = x.permute(0, 2, 3, 1).reshape(n, h * w, groups, c // groups).float()
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = (xf.square().mean(dim=(1, 3), keepdim=True) - mean.square()).clamp_min(0.0)
    y = ((xf - mean) * (torch.rsqrt(var + eps) * weight.float().view(groups, -1))
         + bias.float().view(groups, -1))
    if silu:
        y = F.silu(y)
    return y.to(x.dtype).reshape(n, h, w, c).permute(0, 3, 1, 2)


@functools.lru_cache(maxsize=None)
def plan(n: int, c: int, hw: int, elem_size: int) -> dict:
    """The kernels' tiling of an (n, c, hw) activation: `tiles` a sample of
    `tile` pixels each (the last may be shorter, none is empty), and the
    block's threads as `rows` of `cols` threads, each reading `per_thread`
    16-byte chunks of a pixel."""
    chunks = c * elem_size // 16
    cols = min(chunks, THREADS)
    want = min(MAX_TILES, -(-BLOCKS_PER_SM * SMS // n),
               max(1, hw * c * elem_size // MIN_TILE_BYTES), hw)
    tile = -(-hw // want)
    return dict(tiles=-(-hw // tile), tile=tile, rows=THREADS // cols, cols=cols,
                per_thread=-(-chunks // cols))


@functools.lru_cache(maxsize=None)
def _geometry(shape: torch.Size, dtype: torch.dtype, groups: int) -> Tuple[int, ...]:
    """(N, C, HW, tiles, tile, dtype code) of a launch, the shape checked
    once a shape."""
    if len(shape) != 4:
        raise ValueError("x must be 4-D (N, C, H, W)")
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the kernels take float32 or bfloat16, not {dtype}")
    n, c, h, w = shape
    elem = 4 if dtype == torch.float32 else 2
    if c % groups or c % (16 // elem) or c > MAX_CHANNELS or groups > MAX_GROUPS:
        raise ValueError(f"{c} channels in {groups} groups: the kernels take C divisible by G "
                         f"and by {16 // elem}, C <= {MAX_CHANNELS}, G <= {MAX_GROUPS}")
    p = plan(n, c, h * w, elem)
    return n, c, h * w, p["tiles"], p["tile"], int(dtype == torch.bfloat16)


def _check(t: torch.Tensor, x: torch.Tensor, what: str) -> None:
    """`t` (x itself, or dy) channels-last on a 16-byte boundary, of x's
    shape, dtype and device."""
    if (not t.is_cuda or not t.is_contiguous(memory_format=torch.channels_last)
            or t.data_ptr() % 16 or t.shape != x.shape or t.dtype != x.dtype
            or t.device != x.device):
        raise ValueError(f"{what} must be a channels-last CUDA tensor on a 16-byte boundary"
                         + (", of x's shape, dtype and device" if t is not x else ""))


def _check_affine(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> None:
    c = x.shape[1]
    for t in (weight, bias):
        if (t.shape != (c,) or t.dtype != x.dtype or t.device != x.device
                or not t.is_contiguous()):
            raise ValueError(f"weight and bias must be contiguous ({c},) tensors of x's dtype "
                             "and device")


def group_norm_fwd_cuda(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int,
                        eps: float, silu: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernels on a channels-last CUDA x (float32 or bf16):
    (y like x, (N, G, 2) float32 (mean, rstd))."""
    _check(x, x, "x")
    _check_affine(x, weight, bias)
    n, c, hw, tiles, tile, code = _geometry(x.shape, x.dtype, groups)
    # one float32 scratch: the statistics, then the tiles' partials
    buf = torch.empty(n * groups * (tiles + 1) * 2, dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    err = _build.lib().gd_group_norm_fwd(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), buf.data_ptr() + 8 * n * groups,
        buf.data_ptr(), y.data_ptr(), n, c, hw, groups, tiles, tile, eps, silu, code,
        _build.stream_ptr(x))
    _build.check(err, "gd_group_norm_fwd")
    LAUNCHES["group_norm_fwd"] += 1
    return y, buf[:n * groups * 2].view(n, groups, 2)


def group_norm_bwd_cuda(dy: torch.Tensor, x: torch.Tensor, weight: torch.Tensor,
                        bias: torch.Tensor, stats: torch.Tensor, groups: int,
                        silu: bool) -> torch.Tensor:
    """The backward kernels: dx like x (weight and bias are constants)."""
    _check(x, x, "x")
    _check(dy, x, "dy")
    _check_affine(x, weight, bias)
    n, c, hw, tiles, tile, code = _geometry(x.shape, x.dtype, groups)
    part = torch.empty(n * groups * tiles * 2, dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    err = _build.lib().gd_group_norm_bwd(
        x.data_ptr(), dy.data_ptr(), weight.data_ptr(), bias.data_ptr(), stats.data_ptr(),
        part.data_ptr(), dx.data_ptr(), n, c, hw, groups, tiles, tile, silu, code,
        _build.stream_ptr(x))
    _build.check(err, "gd_group_norm_bwd")
    LAUNCHES["group_norm_bwd"] += 1
    return dx


class GroupNormFn(torch.autograd.Function):
    """Kernel forward with the kernel backward, x's gradient alone; saves x
    and the statistics."""

    @staticmethod
    def forward(ctx, x, weight, bias, groups, eps, silu):
        y, stats = group_norm_fwd_cuda(x, weight, bias, groups, eps, silu)
        ctx.save_for_backward(x, weight, bias, stats)
        ctx.groups, ctx.silu = groups, silu
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, bias, stats = ctx.saved_tensors
        dx = group_norm_bwd_cuda(dy.contiguous(memory_format=torch.channels_last), x, weight,
                                 bias, stats, ctx.groups, ctx.silu)
        return dx, None, None, None, None, None


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int,
               eps: float, silu: bool = False) -> torch.Tensor:
    """GroupNorm with affine, then SiLU when `silu`, of an (N, C, H, W) x:
    the kernels for CUDA tensors (x channels-last; differentiable in x, with
    weight and bias frozen), the plain version for CPU tensors.  The output
    is channels-last."""
    if not x.is_cuda:
        return group_norm_plain(x, weight, bias, groups, eps, silu)
    if torch.is_grad_enabled():
        if weight.requires_grad or bias.requires_grad:
            raise NotImplementedError("the CUDA GroupNorm differentiates x alone: freeze its "
                                      "weight and bias (requires_grad_(False))")
        if x.requires_grad:
            return GroupNormFn.apply(x, weight, bias, groups, eps, silu)
    return group_norm_fwd_cuda(x, weight, bias, groups, eps, silu)[0]
