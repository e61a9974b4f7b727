"""DINOv2 ViT backbone in PyTorch (Depth Anything's encoder), published names.

Counterpart of `geodiffuser_tpu/models/dinov2.py` (the reference vendors it
at Depth-Anything/torchhub/facebookresearch_dinov2_main, loaded in
depth_anything/dpt.py:146): a patch-14 ViT with a class token, interpolated
position embeddings, LayerScale blocks and `get_intermediate_layers`-style
taps.  Parameter names are the published checkpoint's (`pretrained.` in
Depth Anything's files); its `mask_token` is not consumed
(`models/weights.py`).  The attention is the plain softmax product, as in
the JAX package.

The position grid is resized as `jax.image.resize(..., method="cubic")`
resizes it: Keys' cubic (a = -0.5) at half-pixel centres, the kernel
widened by the reduction factor when the grid shrinks, weights normalised
per output position (`resize_cubic_jax`).  `F.interpolate(mode="bicubic")`
is another function (a = -0.75, no widening).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from geodiffuser_tpu_torch.ops.image import jax_resize_weights


@dataclasses.dataclass(frozen=True)
class DinoConfig:
    patch_size: int = 14
    embed_dim: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_ratio: int = 4
    pos_grid: int = 37            # pretraining grid (518/14)

    @staticmethod
    def vit_large() -> "DinoConfig":
        return DinoConfig()

    @staticmethod
    def vit_base() -> "DinoConfig":
        return DinoConfig(embed_dim=768, depth=12, num_heads=12)

    @staticmethod
    def vit_small() -> "DinoConfig":
        return DinoConfig(embed_dim=384, depth=12, num_heads=6)

    @staticmethod
    def tiny() -> "DinoConfig":
        return DinoConfig(embed_dim=32, depth=4, num_heads=2, pos_grid=8, patch_size=4)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    x = x.abs()
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def resize_cubic_jax(grid: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """`jax.image.resize(grid, (height, width, C), method="cubic")` of an
    (H, W, C) float32 grid, one separable pass a resized axis."""
    h, w, _ = grid.shape
    x = grid.float()
    if height != h:
        x = torch.einsum("hwc,ho->owc", x, jax_resize_weights(h, height, _keys_cubic, x.device))
    if width != w:
        x = torch.einsum("hwc,wo->hoc", x, jax_resize_weights(w, width, _keys_cubic, x.device))
    return x


class _Attention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, l, d = x.shape
        hd = d // self.heads
        q, k, v = self.qkv(x).reshape(b, l, 3, self.heads, hd).permute(2, 0, 3, 1, 4)
        probs = torch.softmax((q @ k.transpose(-1, -2)).float() * hd ** -0.5, dim=-1)
        att = (probs.to(v.dtype) @ v).transpose(1, 2).reshape(b, l, d)
        return self.proj(att)


class _Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class _LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))


class DinoBlock(nn.Module):
    def __init__(self, c: DinoConfig):
        super().__init__()
        d = c.embed_dim
        self.norm1 = nn.LayerNorm(d, eps=1e-6)
        self.attn = _Attention(d, c.num_heads)
        self.norm2 = nn.LayerNorm(d, eps=1e-6)
        self.mlp = _Mlp(d, d * c.mlp_ratio)
        self.ls1 = _LayerScale(d)
        self.ls2 = _LayerScale(d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x)) * self.ls1.gamma
        return x + self.mlp(self.norm2(x)) * self.ls2.gamma


class _PatchEmbed(nn.Module):
    def __init__(self, c: DinoConfig):
        super().__init__()
        self.proj = nn.Conv2d(3, c.embed_dim, c.patch_size, stride=c.patch_size)


class DinoViT(nn.Module):
    def __init__(self, cfg: DinoConfig):
        super().__init__()
        c = self.cfg = cfg
        self.patch_embed = _PatchEmbed(c)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, c.embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, c.pos_grid * c.pos_grid + 1, c.embed_dim))
        self.blocks = nn.ModuleList([DinoBlock(c) for _ in range(c.depth)])
        self.norm = nn.LayerNorm(c.embed_dim, eps=1e-6)

    def forward(self, x: torch.Tensor, n_last: int = 4) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """(B, H, W, 3) normalized image (H, W multiples of the patch) ->
        [(patch tokens (B, hw, D), cls (B, D))] of the last `n_last` blocks,
        each after the final LayerNorm (DINOv2's get_intermediate_layers(n,
        return_class_token=True, norm=True), the tap Depth Anything uses,
        dpt.py:155)."""
        c = self.cfg
        b, h, w, _ = x.shape
        ph, pw = h // c.patch_size, w // c.patch_size
        dtype = self.patch_embed.proj.weight.dtype
        x = self.patch_embed.proj(x.to(dtype).permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
        pos_cls, pos_patch = self.pos_embed[:, :1], self.pos_embed[:, 1:]
        if (ph, pw) != (c.pos_grid, c.pos_grid):
            grid = pos_patch.reshape(c.pos_grid, c.pos_grid, c.embed_dim)
            pos_patch = resize_cubic_jax(grid, ph, pw).reshape(1, ph * pw, c.embed_dim)
        x = x + pos_patch.to(dtype)
        cls_tok = (self.cls_token + pos_cls).to(dtype)
        x = torch.cat([cls_tok.expand(b, 1, -1), x], dim=1)
        taps = []
        for i, block in enumerate(self.blocks):
            x = block(x)
            if i >= c.depth - n_last:
                taps.append(x)
        out = []
        for t in taps:
            t = self.norm(t)
            out.append((t[:, 1:], t[:, 0]))
        return out
