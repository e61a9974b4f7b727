"""Shared building blocks of the SD-1.x models, diffusers parameter names.

Counterpart of `geodiffuser_tpu/models/layers.py`.  Modules take
(N, C, H, W) tensors stored channels-last (N, H, W, C in memory) from the
first convolution to the last, so that cuDNN's NHWC convolutions need no
layout transposes; the models' public functions keep the JAX package's NHWC
layout, whose permuted view is that channels-last tensor.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from geodiffuser_tpu_torch.kernels.group_norm import group_norm


def timestep_embedding(timesteps: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embedding, SD-1.x convention (flip_sin_to_cos=True,
    downscale_freq_shift=0): [cos | sin], float32."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                                     device=timesteps.device) / half
    args = timesteps.float()[..., None] * torch.exp(exponent)[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def channels_last(x_nhwc: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> the (N, C, H, W) channels-last view of the same
    memory (a copy only where x is not contiguous)."""
    return x_nhwc.contiguous().permute(0, 3, 1, 2)


class GroupNorm(nn.GroupNorm):
    """`nn.GroupNorm` (same parameters, no buffers) through
    `kernels/group_norm.group_norm`: channels-last in and out, and with
    `silu=True` the SiLU after it in the same pass."""

    def forward(self, x: torch.Tensor, silu: bool = False) -> torch.Tensor:
        return group_norm(x, self.weight, self.bias, self.num_groups, self.eps, silu)


class TimestepEmbedding(nn.Module):
    def __init__(self, in_dim: int, time_embed_dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, time_embed_dim)
        self.linear_2 = nn.Linear(time_embed_dim, time_embed_dim)

    def forward(self, sample: torch.Tensor) -> torch.Tensor:
        x = self.linear_1(sample.to(self.linear_1.weight.dtype))
        return self.linear_2(F.silu(x))


class ResnetBlock2D(nn.Module):
    """GN -> silu -> conv -> +time -> GN -> silu -> conv -> +shortcut.
    GroupNorm eps is 1e-5 in both the UNet and the VAE, as in the JAX package."""

    def __init__(self, in_channels: int, out_channels: int, groups: int = 32,
                 temb_channels: Optional[int] = None):
        super().__init__()
        self.norm1 = GroupNorm(groups, in_channels, eps=1e-5)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb_channels, out_channels) if temb_channels else None
        self.norm2 = GroupNorm(groups, out_channels, eps=1e-5)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (nn.Conv2d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.conv1(self.norm1(x, silu=True))
        if temb is not None and self.time_emb_proj is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(self.norm2(h, silu=True))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Downsample2D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2, padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # diffusers' asymmetric (0, 1) padding for the stride-2 conv
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample2D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # `F.interpolate` keeps channels-last, except for a 1 x 1 input,
        # whose layout is ambiguous (there the copy is not a no-op)
        up = F.interpolate(x, scale_factor=2.0, mode="nearest")
        return self.conv(up.contiguous(memory_format=torch.channels_last))


class GEGLU(nn.Module):
    """x W1 * gelu(x W2) (diffusers GEGLU, 'proj' layout)."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = nn.Linear(dim_in, dim_out * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(nn.Module):
    """diffusers names: net.0 (GEGLU), net.2 (Linear); net.1 is dropout."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Identity(), nn.Linear(dim * mult, dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.net:
            x = layer(x)
        return x


def seeded_init_(module: nn.Module, generator: torch.Generator, unit_normal: tuple = ()) -> None:
    """Random weights from `generator` for a model built without a checkpoint
    (the perception models): a weight of two or more dimensions
    N(0, 1/fan_in), fan_in the product of all but its first dimension; a
    norm's scale (LayerNorm, GroupNorm, FrozenBatchNorm) 1 + N(0, 0.02^2);
    the parameters and buffers whose
    names end with one of `unit_normal` N(0, 1); every other parameter
    N(0, 0.02^2).  The generator lives on the module's device."""
    norms = {f"{name}.weight" for name, m in module.named_modules()
             if "Norm" in type(m).__name__}
    tensors = dict(module.named_parameters())
    if unit_normal:
        tensors.update((k, v) for k, v in module.named_buffers() if k.endswith(unit_normal))
    with torch.no_grad():
        for name, t in tensors.items():
            if unit_normal and name.endswith(unit_normal):
                t.normal_(0.0, 1.0, generator=generator)
            elif name in norms:
                t.normal_(1.0, 0.02, generator=generator)
            elif name.endswith("weight") and t.dim() >= 2:
                t.normal_(0.0, math.prod(t.shape[1:]) ** -0.5, generator=generator)
            else:
                t.normal_(0.0, 0.02, generator=generator)
