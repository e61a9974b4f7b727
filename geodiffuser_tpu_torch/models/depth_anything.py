"""Depth Anything (DINOv2 + DPT head) in PyTorch, published names.

Counterpart of `geodiffuser_tpu/models/depth_anything.py` (the reference's
default depth predictor, depth_anything/dpt.py: DPT_DINOv2, used through
get_monocular_depth_anything, depth_predictor.py:325-370): projections
and resize layers over the last four DINOv2 taps, RefineNet fusion, a
two-conv output head.  The modules carry the published checkpoint's names
(`pretrained.…`, `depth_head.projects.…`, `depth_head.scratch.…`);
`refinenet4.resConfUnit1`, which the published model builds and never
calls (dpt.py:127), is not built here and not consumed from a checkpoint
(`models/weights.py`).  Images are NHWC at the public functions.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from geodiffuser_tpu_torch.models.dinov2 import DinoConfig, DinoViT


def resize_align_corners(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Bilinear align_corners=True resize of (B, C, H, W)."""
    return F.interpolate(x, size=(h, w), mode="bilinear", align_corners=True)


class ResidualConvUnit(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv2(F.relu(self.conv1(F.relu(x))))


class FeatureFusionBlock(nn.Module):
    """DPT RefineNet fusion (depth_anything/blocks.py:95-150): the skip
    through a residual unit, refine, bilinear (align_corners=True)
    upsample, 1x1 out conv."""

    def __init__(self, features: int, with_skip: bool = True):
        super().__init__()
        if with_skip:
            self.resConfUnit1 = ResidualConvUnit(features)
        self.resConfUnit2 = ResidualConvUnit(features)
        self.out_conv = nn.Conv2d(features, features, 1)

    def forward(self, x, skip=None, size: Optional[Tuple[int, int]] = None):
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        x = self.resConfUnit2(x)
        if size is None:
            size = (x.shape[2] * 2, x.shape[3] * 2)
        return self.out_conv(resize_align_corners(x, *size))


@dataclasses.dataclass(frozen=True)
class DepthAnythingConfig:
    encoder: str = "vitl"
    features: int = 256
    out_channels: Tuple[int, ...] = (256, 512, 1024, 1024)

    def dino(self) -> DinoConfig:
        return {
            "vitl": DinoConfig.vit_large(),
            "vitb": DinoConfig.vit_base(),
            "vits": DinoConfig.vit_small(),
            "tiny": DinoConfig.tiny(),
        }[self.encoder]

    @staticmethod
    def tiny() -> "DepthAnythingConfig":
        return DepthAnythingConfig(encoder="tiny", features=16, out_channels=(8, 16, 32, 32))


class _Scratch(nn.Module):
    def __init__(self, c: DepthAnythingConfig):
        super().__init__()
        for i, oc in enumerate(c.out_channels):
            setattr(self, f"layer{i + 1}_rn", nn.Conv2d(oc, c.features, 3, padding=1, bias=False))
        for i in (1, 2, 3, 4):
            setattr(self, f"refinenet{i}", FeatureFusionBlock(c.features, with_skip=i != 4))
        self.output_conv1 = nn.Conv2d(c.features, c.features // 2, 3, padding=1)
        self.output_conv2 = nn.Sequential(
            nn.Conv2d(c.features // 2, 32, 3, padding=1), nn.ReLU(), nn.Conv2d(32, 1, 1))


class DPTHead(nn.Module):
    def __init__(self, cfg: DepthAnythingConfig):
        super().__init__()
        c = self.cfg = cfg
        oc = c.out_channels
        d = c.dino().embed_dim
        self.projects = nn.ModuleList([nn.Conv2d(d, o, 1) for o in oc])
        self.resize_layers = nn.ModuleList([
            nn.ConvTranspose2d(oc[0], oc[0], 4, stride=4),
            nn.ConvTranspose2d(oc[1], oc[1], 2, stride=2),
            nn.Identity(),
            nn.Conv2d(oc[3], oc[3], 3, stride=2, padding=1),
        ])
        self.scratch = _Scratch(c)

    def forward(self, taps: List[Tuple[torch.Tensor, torch.Tensor]], ph: int, pw: int):
        """DINOv2 taps -> (B, 1, ph * patch, pw * patch) relative depth."""
        s = self.scratch
        feats = []
        for i, (tokens, _cls) in enumerate(taps):
            b, _, d = tokens.shape
            x = tokens.transpose(1, 2).reshape(b, d, ph, pw)
            feats.append(self.resize_layers[i](self.projects[i](x)))
        rn = [getattr(s, f"layer{i + 1}_rn")(f) for i, f in enumerate(feats)]
        p4 = s.refinenet4(rn[3], size=rn[2].shape[2:])
        p3 = s.refinenet3(p4, rn[2], size=rn[1].shape[2:])
        p2 = s.refinenet2(p3, rn[1], size=rn[0].shape[2:])
        p1 = s.refinenet1(p2, rn[0])
        out = s.output_conv1(p1)
        patch = 14 if self.cfg.encoder != "tiny" else 4
        out = resize_align_corners(out, ph * patch, pw * patch)
        return F.relu(s.output_conv2(out))


class DepthAnything(nn.Module):
    """(B, H, W, 3) ImageNet-normalized image -> (B, H, W) relative depth
    (larger = closer, as the model emits; `utils/depth.py` inverts it, as
    depth_predictor.py:364-369 does)."""

    def __init__(self, cfg: DepthAnythingConfig = DepthAnythingConfig()):
        super().__init__()
        self.cfg = cfg
        self.pretrained = DinoViT(cfg.dino())
        self.depth_head = DPTHead(cfg)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        patch = self.pretrained.cfg.patch_size
        b, h, w, _ = x.shape
        taps = self.pretrained(x, n_last=4)
        depth = self.depth_head(taps, h // patch, w // patch)
        return F.relu(resize_align_corners(depth, h, w)[:, 0])
