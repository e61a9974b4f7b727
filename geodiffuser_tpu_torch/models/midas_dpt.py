"""MiDaS / DPT monocular depth in PyTorch, published names.

Counterpart of `geodiffuser_tpu/models/midas_dpt.py` (the reference's
`get_monocular_depth` model types, depth_predictor.py:105-274; model code
vendored under GeoDiffuser/dpt/ and midas_repo/):

  * `DPTLarge`: ViT-L/16 (384^2 position grid, class token), taps after
    blocks (5, 11, 17, 23) with the 'project' readout (the class token
    concatenated to every patch token, Linear, exact GELU), reassembled to
    four scales, RefineNet fusion, the monocular head;
  * `DPTHybrid` (and its KITTI / NYU metric variants): ViT-B/16 over a
    ResNetV2-50 stem (weight-standardized convs, GroupNorm, pre-activation
    bottlenecks), taps 1-2 from the ResNet stages 0-1, taps 3-4 from the
    ViT;
  * `MidasNetV21`: ResNeXt101 32x8d with frozen BatchNorm, the original
    MiDaS fusion blocks (no 1x1 out conv) and head.

The modules carry the published checkpoints' names (intel-isl DPT / MiDaS:
`pretrained.model.…`, `pretrained.act_postprocessN.…`, `pretrained.layerN.…`,
`scratch.…`), so a published state_dict loads as it is once its unconsumed
keys are dropped (`models/weights.py`, the manifests).  `refinenet4`'s first
fusion unit, which the published models build and never call, is not built.
Images are NHWC at the public functions, (B, H, W) depth out.

The position grid is resized as `jax.image.resize(method="linear")` resizes
it (`ops/image.resize_linear_jax`: antialiased where it shrinks), and so are
MiDaS v2.1's head and output; the attention is the plain softmax product,
as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from geodiffuser_tpu_torch.models.depth_anything import (
    FeatureFusionBlock, ResidualConvUnit, resize_align_corners,
)
from geodiffuser_tpu_torch.models.dinov2 import _Attention, _Mlp
from geodiffuser_tpu_torch.ops.image import resize_linear_jax


@dataclasses.dataclass(frozen=True)
class DPTConfig:
    patch_size: int = 16
    embed_dim: int = 1024
    depth: int = 24
    num_heads: int = 16
    pos_grid: int = 24            # 384 / 16
    hooks: Tuple[int, ...] = (5, 11, 17, 23)
    post_channels: Tuple[int, ...] = (256, 512, 1024, 1024)
    features: int = 256

    @staticmethod
    def tiny() -> "DPTConfig":
        return DPTConfig(patch_size=4, embed_dim=32, depth=4, num_heads=2,
                         pos_grid=8, hooks=(0, 1, 2, 3),
                         post_channels=(8, 16, 32, 32), features=16)


class ViTBlock(nn.Module):
    """timm ViT block: pre-norm attention and MLP (LayerNorm eps 1e-6)."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = _Attention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = _Mlp(dim, dim * 4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


def position_grid(pos_embed: torch.Tensor, grid: int, ph: int, pw: int):
    """(class position (1, 1, D), patch positions (1, ph * pw, D)) of a
    learned (1, grid^2 + 1, D) table, the grid resized as JAX resizes it."""
    pos_cls, pos_patch = pos_embed[:, :1], pos_embed[:, 1:]
    if (ph, pw) != (grid, grid):
        d = pos_embed.shape[-1]
        g = pos_patch.reshape(grid, grid, d).permute(2, 0, 1)
        pos_patch = resize_linear_jax(g, ph, pw).permute(1, 2, 0).reshape(1, ph * pw, d)
    return pos_cls, pos_patch


class _PatchEmbed(nn.Module):
    def __init__(self, cin: int, dim: int, patch: int, backbone: Optional[nn.Module] = None):
        super().__init__()
        if backbone is not None:
            self.backbone = backbone
        self.proj = nn.Conv2d(cin, dim, patch, stride=patch)


class VisionTransformer(nn.Module):
    """timm's ViT as DPT holds it (`pretrained.model`): patch embedding,
    class token, learned positions, blocks.  Its final norm and classifier
    are never run and not built."""

    def __init__(self, dim: int, depth: int, heads: int, pos_grid: int,
                 patch_embed: nn.Module):
        super().__init__()
        self.pos_grid = pos_grid
        self.patch_embed = patch_embed
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, pos_grid * pos_grid + 1, dim))
        self.blocks = nn.ModuleList([ViTBlock(dim, heads) for _ in range(depth)])

    def tokens(self, x: torch.Tensor, hooks: Tuple[int, ...]) -> List[torch.Tensor]:
        """(B, C, H, W) input of the patch embedding -> the (B, 1 + ph * pw, D)
        tokens after each block in `hooks`."""
        x = self.patch_embed.proj(x)
        b, _, ph, pw = x.shape
        x = x.flatten(2).transpose(1, 2)
        pos_cls, pos_patch = position_grid(self.pos_embed, self.pos_grid, ph, pw)
        x = torch.cat([(self.cls_token + pos_cls).expand(b, -1, -1), x + pos_patch], dim=1)
        taps = []
        for i, block in enumerate(self.blocks):
            x = block(x)
            if i in hooks:
                taps.append(x)
        return taps


class ProjectReadout(nn.Module):
    """DPT's 'project' readout: the class token concatenated to every patch
    token, Linear, exact GELU (`act_postprocessN.0`)."""

    def __init__(self, dim: int):
        super().__init__()
        self.project = nn.Sequential(nn.Linear(2 * dim, dim), nn.GELU())

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        patch = t[:, 1:]
        return self.project(torch.cat([patch, t[:, :1].expand_as(patch)], dim=-1))


def act_postprocess(dim: int, out: int, resize: Optional[nn.Module] = None) -> nn.ModuleList:
    """The published `act_postprocessN` Sequential: readout (0), the two
    reshapes (1, 2: no parameters), 1x1 conv (3), the resize (4)."""
    mods = [ProjectReadout(dim), nn.Identity(), nn.Identity(), nn.Conv2d(dim, out, 1)]
    return nn.ModuleList(mods + ([resize] if resize is not None else []))


def reassemble(post: nn.ModuleList, tap: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """ViT tokens (B, 1 + ph * pw, D) -> a (B, C, H, W) feature map."""
    y = post[0](tap)
    y = y.transpose(1, 2).reshape(y.shape[0], -1, ph, pw)
    for m in post[3:]:
        y = m(y)
    return y


def vit_postprocess(dim: int, post: Tuple[int, ...]) -> List[nn.ModuleList]:
    """act_postprocess1..4 of the four-tap ViT DPTs: x4 and x2 transposed
    convs, nothing, a stride-2 conv."""
    return [
        act_postprocess(dim, post[0], nn.ConvTranspose2d(post[0], post[0], 4, stride=4)),
        act_postprocess(dim, post[1], nn.ConvTranspose2d(post[1], post[1], 2, stride=2)),
        act_postprocess(dim, post[2]),
        act_postprocess(dim, post[3], nn.Conv2d(post[3], post[3], 3, stride=2, padding=1)),
    ]


class MidasFusionBlock(nn.Module):
    """The original MiDaS FeatureFusionBlock (midas_repo/blocks.py): residual
    units, a fixed x2 bilinear (align_corners=True) upsample, no out conv."""

    def __init__(self, features: int, with_skip: bool = True):
        super().__init__()
        if with_skip:
            self.resConfUnit1 = ResidualConvUnit(features)
        self.resConfUnit2 = ResidualConvUnit(features)

    def forward(self, x, skip=None):
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        x = self.resConfUnit2(x)
        return resize_align_corners(x, x.shape[2] * 2, x.shape[3] * 2)


class Scratch(nn.Module):
    """The published `scratch`: layerN_rn (3x3, no bias), refinenet1..4 and
    output_conv.{0, 2, 4} (1 and 3 are the upsample and a ReLU)."""

    def __init__(self, in_channels: Tuple[int, ...], features: int, head: int,
                 midas: bool = False):
        super().__init__()
        self.midas = midas
        for i, c in enumerate(in_channels):
            setattr(self, f"layer{i + 1}_rn", nn.Conv2d(c, features, 3, padding=1, bias=False))
        fusion = MidasFusionBlock if midas else FeatureFusionBlock
        for i in (1, 2, 3, 4):
            setattr(self, f"refinenet{i}", fusion(features, with_skip=i != 4))
        self.output_conv = nn.ModuleList([
            nn.Conv2d(features, head, 3, padding=1), nn.Identity(),
            nn.Conv2d(head, 32, 3, padding=1), nn.Identity(), nn.Conv2d(32, 1, 1)])

    def fuse(self, feats: List[torch.Tensor]):
        """Four feature maps -> (layer4_rn's output, [r4, r3, r2, r1])."""
        rn = [getattr(self, f"layer{i + 1}_rn")(f) for i, f in enumerate(feats)]
        if self.midas:
            p4 = self.refinenet4(rn[3])
            p3 = self.refinenet3(p4, rn[2])
            p2 = self.refinenet2(p3, rn[1])
            p1 = self.refinenet1(p2, rn[0])
        else:
            p4 = self.refinenet4(rn[3], size=rn[2].shape[2:])
            p3 = self.refinenet3(p4, rn[2], size=rn[1].shape[2:])
            p2 = self.refinenet2(p3, rn[1], size=rn[0].shape[2:])
            p1 = self.refinenet1(p2, rn[0])
        return rn[3], [p4, p3, p2, p1]

    def head(self, p1: torch.Tensor):
        """r1 -> (the 32-channel activation, relative depth (B, 1, H, W)).
        DPT upsamples x2 with align_corners=True, MiDaS v2.1 with JAX's
        half-pixel linear resize (blocks.py Interpolate's default)."""
        out = self.output_conv[0](p1)
        h, w = out.shape[2] * 2, out.shape[3] * 2
        out = resize_linear_jax(out, h, w) if self.midas else resize_align_corners(out, h, w)
        feat32 = F.relu(self.output_conv[2](out))
        return feat32, F.relu(self.output_conv[4](feat32))


class _DPTPretrained(nn.Module):
    def __init__(self, model: nn.Module, posts: dict):
        super().__init__()
        self.model = model
        for n, post in posts.items():
            setattr(self, f"act_postprocess{n}", post)


class DPTLarge(nn.Module):
    """(B, H, W, 3) normalized image (H, W multiples of the patch) -> (B, H, W)
    relative inverse depth (larger = closer)."""

    def __init__(self, cfg: DPTConfig = DPTConfig()):
        super().__init__()
        c = self.cfg = cfg
        vit = VisionTransformer(c.embed_dim, c.depth, c.num_heads, c.pos_grid,
                                _PatchEmbed(3, c.embed_dim, c.patch_size))
        posts = vit_postprocess(c.embed_dim, c.post_channels)
        self.pretrained = _DPTPretrained(vit, {i + 1: p for i, p in enumerate(posts)})
        self.scratch = Scratch(c.post_channels, c.features, c.features // 2)

    def taps(self, x: torch.Tensor):
        """The MidasCore taps ZoeDepth reads (zoedepth/models/base_models/
        midas.py): (relative depth (B, H, W), the 32-channel head activation,
        layer4_rn's output, [r4, r3, r2, r1])."""
        c = self.cfg
        ph, pw = x.shape[1] // c.patch_size, x.shape[2] // c.patch_size
        tokens = self.pretrained.model.tokens(x.permute(0, 3, 1, 2), c.hooks)
        feats = [reassemble(getattr(self.pretrained, f"act_postprocess{i + 1}"), t, ph, pw)
                 for i, t in enumerate(tokens)]
        btlnck, blocks = self.scratch.fuse(feats)
        feat32, rel = self.scratch.head(blocks[3])
        return rel[:, 0], feat32, btlnck, blocks

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        rel = self.taps(x)[0]
        return resize_align_corners(rel[:, None], x.shape[1], x.shape[2])[:, 0]


# ---------------------------------------------------------------------------
# dpt_hybrid: ViT-B/16 over a ResNetV2-50 stem (timm vit_base_resnet50_384)
# ---------------------------------------------------------------------------


def std_conv(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
             stride: int = 1, padding: int = 0) -> torch.Tensor:
    """Weight-standardized conv (timm StdConv2d, eps 1e-6): each output
    channel's kernel normalized over (cin, kh, kw), population variance."""
    mean = weight.mean(dim=(1, 2, 3), keepdim=True)
    var = weight.var(dim=(1, 2, 3), unbiased=False, keepdim=True)
    return F.conv2d(x, (weight - mean) / torch.sqrt(var + 1e-6), bias, stride, padding)


class StdConv(nn.Conv2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return std_conv(x, self.weight, self.bias, self.stride, self.padding)


def _group_norm(ch: int) -> nn.GroupNorm:
    # 32 groups as in timm, clamped so that tiny configurations stay valid
    return nn.GroupNorm(math.gcd(32, ch), ch, eps=1e-5)


class _Downsample(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__()
        self.conv = StdConv(cin, cout, 1, stride=stride, bias=False)


class PreActBottleneck(nn.Module):
    """timm ResNetV2 pre-activation bottleneck: GN+ReLU -> 1x1 -> GN+ReLU ->
    3x3 (stride) -> GN+ReLU -> 1x1; the shortcut a 1x1 std-conv of the
    pre-activated input where the shape changes."""

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        mid = cout // 4
        self.norm1 = _group_norm(cin)
        self.conv1 = StdConv(cin, mid, 1, bias=False)
        self.norm2 = _group_norm(mid)
        self.conv2 = StdConv(mid, mid, 3, stride=stride, padding=1, bias=False)
        self.norm3 = _group_norm(mid)
        self.conv3 = StdConv(mid, cout, 1, bias=False)
        if cin != cout or stride != 1:
            self.downsample = _Downsample(cin, cout, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pre = F.relu(self.norm1(x))
        shortcut = self.downsample.conv(pre) if hasattr(self, "downsample") else x
        h = F.relu(self.norm2(self.conv1(pre)))
        h = F.relu(self.norm3(self.conv2(h)))
        return shortcut + self.conv3(h)


@dataclasses.dataclass(frozen=True)
class DPTHybridConfig:
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    pos_grid: int = 24                     # 384 / 16
    hooks: Tuple[int, ...] = (8, 11)       # ViT taps (dpt/models.py:44)
    stage_blocks: Tuple[int, ...] = (3, 4, 9)
    stage_channels: Tuple[int, ...] = (256, 512, 1024)
    post_channels: Tuple[int, ...] = (256, 512, 768, 768)
    features: int = 256
    # metric variants (dpt_hybrid_kitti / _nyu, depth_predictor.py:141-168)
    scale: float = 1.0
    shift: float = 0.0
    invert: bool = False

    @staticmethod
    def tiny() -> "DPTHybridConfig":
        return DPTHybridConfig(embed_dim=32, depth=2, num_heads=2, pos_grid=4,
                               hooks=(0, 1), stage_blocks=(1, 1, 1),
                               stage_channels=(8, 16, 32),
                               post_channels=(8, 16, 32, 32), features=16)


class _Stem(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = StdConv(3, 64, 7, stride=2, padding=3, bias=False)


class _Stage(nn.Module):
    def __init__(self, blocks: List[nn.Module]):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)


class ResNetV2(nn.Module):
    """The hybrid's ResNetV2-50 stem (`pretrained.model.patch_embed.
    backbone`): std-conv 7x7/2, max pool 3x3/2, three pre-activation
    stages, a final GroupNorm."""

    def __init__(self, c: DPTHybridConfig):
        super().__init__()
        self.stem = _Stem()
        stages, cin = [], 64
        for s, (n, ch) in enumerate(zip(c.stage_blocks, c.stage_channels)):
            blocks = []
            for j in range(n):
                blocks.append(PreActBottleneck(cin, ch, 2 if (j == 0 and s > 0) else 1))
                cin = ch
            stages.append(_Stage(blocks))
        self.stages = nn.ModuleList(stages)
        self.norm = _group_norm(cin)

    def forward(self, x: torch.Tensor):
        """(B, 3, H, W) -> (the stride-16 map, [stage 0's, stage 1's output])."""
        y = F.max_pool2d(self.stem.conv(x), 3, stride=2, padding=1)
        taps = []
        for s, stage in enumerate(self.stages):
            for block in stage.blocks:
                y = block(y)
            if s < 2:
                taps.append(y)
        return F.relu(self.norm(y)), taps


class DPTHybrid(nn.Module):
    """(B, H, W, 3) [-1, 1]-normalized image -> (B, H, W) inverse depth, or
    metric depth 1 / max(scale * d + shift, 1e-8) for the KITTI / NYU
    variants (dpt/models.py:116-121).

    Taps 1-2 come straight from the ResNet stages 0-1 (dpt/vit.py:370-376);
    taps 3-4 from ViT blocks hooks[0], hooks[1] with the 'project' readout."""

    def __init__(self, cfg: DPTHybridConfig = DPTHybridConfig()):
        super().__init__()
        c = self.cfg = cfg
        vit = VisionTransformer(c.embed_dim, c.depth, c.num_heads, c.pos_grid,
                                _PatchEmbed(c.stage_channels[-1], c.embed_dim, 1, ResNetV2(c)))
        posts = vit_postprocess(c.embed_dim, c.post_channels)
        self.pretrained = _DPTPretrained(vit, {3: posts[2], 4: posts[3]})
        self.scratch = Scratch(c.post_channels, c.features, c.features // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        b, h, w, _ = x.shape
        vit = self.pretrained.model
        y, feats = vit.patch_embed.backbone(x.permute(0, 3, 1, 2))
        ph, pw = y.shape[2:]
        for n, t in zip((3, 4), vit.tokens(y, c.hooks)):
            feats.append(reassemble(getattr(self.pretrained, f"act_postprocess{n}"), t, ph, pw))
        _, blocks = self.scratch.fuse(feats)
        inv_depth = resize_align_corners(self.scratch.head(blocks[3])[1], h, w)[:, 0]
        if c.invert:
            return 1.0 / torch.clamp(c.scale * inv_depth + c.shift, min=1e-8)
        return inv_depth


# ---------------------------------------------------------------------------
# midas_v21: MidasNet over ResNeXt101_32x8d (midas_repo/midas_net.py:12-80)
# ---------------------------------------------------------------------------


class FrozenBatchNorm(nn.Module):
    """Inference BatchNorm: (x - mean) / sqrt(var + eps) * weight + bias,
    the statistics as buffers under BatchNorm2d's names."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        view = lambda t: t[:, None, None]
        return ((x - view(self.running_mean)) * view(torch.rsqrt(self.running_var + self.eps))
                * view(self.weight) + view(self.bias))


class ResNeXtBottleneck(nn.Module):
    """torchvision Bottleneck with groups=32, width_per_group=8 (post-act)."""

    def __init__(self, cin: int, planes: int, stride: int = 1, groups: int = 32,
                 base_width: int = 8):
        super().__init__()
        width = int(planes * base_width / 64.0) * groups
        out = planes * 4
        self.conv1 = nn.Conv2d(cin, width, 1, bias=False)
        self.bn1 = FrozenBatchNorm(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride=stride, padding=1, groups=groups,
                               bias=False)
        self.bn2 = FrozenBatchNorm(width)
        self.conv3 = nn.Conv2d(width, out, 1, bias=False)
        self.bn3 = FrozenBatchNorm(out)
        if cin != out or stride != 1:
            self.downsample = nn.Sequential(nn.Conv2d(cin, out, 1, stride=stride, bias=False),
                                            FrozenBatchNorm(out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        if hasattr(self, "downsample"):
            x = self.downsample(x)
        return F.relu(x + h)


@dataclasses.dataclass(frozen=True)
class MidasV21Config:
    layers: Tuple[int, ...] = (3, 4, 23, 3)     # ResNeXt101
    planes: Tuple[int, ...] = (64, 128, 256, 512)
    features: int = 256
    stem_channels: int = 64

    @staticmethod
    def tiny() -> "MidasV21Config":
        # planes >= 8 keeps the ResNeXt width rule int(p * 8 / 64) * 32 nonzero
        return MidasV21Config(layers=(1, 1, 1, 1), planes=(8, 16, 32, 64),
                              features=16, stem_channels=8)


class _ResNeXt(nn.Module):
    """`pretrained`: layer1 is the stem and ResNet layer1 in one Sequential
    (conv1, bn1, ReLU, max pool, blocks; dpt/blocks.py:120-130)."""

    def __init__(self, c: MidasV21Config):
        super().__init__()
        cin = c.stem_channels
        for s, (n, planes) in enumerate(zip(c.layers, c.planes)):
            blocks = []
            for j in range(n):
                blocks.append(ResNeXtBottleneck(cin, planes, 2 if (j == 0 and s > 0) else 1))
                cin = planes * 4
            layer = nn.Sequential(*blocks)
            if s == 0:
                layer = nn.Sequential(
                    nn.Conv2d(3, c.stem_channels, 7, stride=2, padding=3, bias=False),
                    FrozenBatchNorm(c.stem_channels), nn.ReLU(), nn.MaxPool2d(3, 2, 1), layer)
            setattr(self, f"layer{s + 1}", layer)


class MidasNetV21(nn.Module):
    """(B, H, W, 3) ImageNet-normalized image -> (B, H, W) inverse depth."""

    def __init__(self, cfg: MidasV21Config = MidasV21Config()):
        super().__init__()
        self.cfg = cfg
        self.pretrained = _ResNeXt(cfg)
        self.scratch = Scratch(tuple(p * 4 for p in cfg.planes), cfg.features, 128, midas=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = x.shape
        y, feats = x.permute(0, 3, 1, 2), []
        for i in (1, 2, 3, 4):
            y = getattr(self.pretrained, f"layer{i}")(y)
            feats.append(y)
        _, blocks = self.scratch.fuse(feats)
        return resize_linear_jax(self.scratch.head(blocks[3])[1], h, w)[:, 0]
