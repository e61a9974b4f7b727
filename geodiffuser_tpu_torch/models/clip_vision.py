"""CLIP vision tower (ViT-B/32) in PyTorch, HF CLIPVisionModelWithProjection names.

Counterpart of `geodiffuser_tpu/models/clip_vision.py`: backs the CLIP
similarity metric (the reference's image_fidelity.py:183-206 takes ViT-B/32
image embeddings' cosine) and the CLIP-feature FID (evaluation/fid.py).
Pre-LN ViT with a class token, quick_gelu, a final LayerNorm on the class
token and a linear projection to the shared space.  Its attention is the
plain softmax product of the text tower (`clip_text.CLIPAttention`), as in
the JAX package: 50 tokens a image.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn as nn

from geodiffuser_tpu_torch.models.clip_text import CLIPEncoderLayer
from geodiffuser_tpu_torch.ops import image as image_ops

CLIP_IMAGE_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_IMAGE_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 32
    hidden_size: int = 768
    layers: int = 12
    heads: int = 12
    projection_dim: int = 512
    dtype: torch.dtype = torch.float32

    @staticmethod
    def tiny() -> "CLIPVisionConfig":
        return CLIPVisionConfig(image_size=32, patch_size=8, hidden_size=32,
                                layers=2, heads=2, projection_dim=16)


class _Embeddings(nn.Module):
    def __init__(self, c: CLIPVisionConfig):
        super().__init__()
        grid = c.image_size // c.patch_size
        self.class_embedding = nn.Parameter(torch.randn(c.hidden_size) * 0.02)
        self.patch_embedding = nn.Conv2d(3, c.hidden_size, c.patch_size, stride=c.patch_size,
                                         bias=False)
        self.position_embedding = nn.Embedding(grid * grid + 1, c.hidden_size)


class _Encoder(nn.Module):
    def __init__(self, c: CLIPVisionConfig):
        super().__init__()
        self.layers = nn.ModuleList([CLIPEncoderLayer(c.hidden_size, c.heads)
                                     for _ in range(c.layers)])


class _VisionTransformer(nn.Module):
    def __init__(self, c: CLIPVisionConfig):
        super().__init__()
        self.embeddings = _Embeddings(c)
        self.pre_layrnorm = nn.LayerNorm(c.hidden_size, eps=1e-5)   # HF's spelling
        self.encoder = _Encoder(c)
        self.post_layernorm = nn.LayerNorm(c.hidden_size, eps=1e-5)


class CLIPVisionEncoder(nn.Module):
    def __init__(self, config: CLIPVisionConfig = CLIPVisionConfig()):
        super().__init__()
        self.config = config
        self.vision_model = _VisionTransformer(config)
        self.visual_projection = nn.Linear(config.hidden_size, config.projection_dim, bias=False)

    def forward(self, pixels: torch.Tensor, project: bool = True) -> torch.Tensor:
        """(B, S, S, 3) CLIP-normalized pixels (NHWC) -> (B, projection_dim)
        float32 image embeddings, or the (B, hidden) pooled class token
        before the projection when not `project`."""
        vm = self.vision_model
        emb = vm.embeddings
        dtype = emb.patch_embedding.weight.dtype
        x = emb.patch_embedding(pixels.to(dtype).permute(0, 3, 1, 2))
        x = x.flatten(2).transpose(1, 2)                      # (B, grid^2, hidden), row-major
        cls = emb.class_embedding.to(dtype).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + emb.position_embedding.weight[None]
        x = vm.pre_layrnorm(x)
        no_mask = torch.zeros((x.shape[1], x.shape[1]), device=x.device)
        for layer in vm.encoder.layers:
            x = layer(x, no_mask)
        pooled = vm.post_layernorm(x[:, 0])
        if not project:
            return pooled.float()
        return self.visual_projection(pooled).float()


def preprocess_clip_image(image: np.ndarray, size: int = 224, device="cpu") -> torch.Tensor:
    """uint8 or float (H, W, 3) image -> CLIP-normalized (1, size, size, 3)
    float32 on `device` (half-pixel bilinear resize, no antialiasing)."""
    img = np.asarray(image, np.float32)
    if img.max() > 1.5:
        img = img / 255.0
    x = image_ops.resize_bilinear_hwc(torch.from_numpy(img).to(device), size, size)
    mean = torch.from_numpy(CLIP_IMAGE_MEAN).to(x.device)
    std = torch.from_numpy(CLIP_IMAGE_STD).to(x.device)
    return ((x - mean) / std)[None]
