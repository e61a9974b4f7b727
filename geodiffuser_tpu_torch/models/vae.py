"""AutoencoderKL (SD VAE) in PyTorch, diffusers parameter names.

Counterpart of `geodiffuser_tpu/models/vae.py`.  `encode` returns the
posterior mean (the reference always uses latent_dist.mean, diffusion.py:95);
the 0.18215 scaling is applied by callers.  Public functions are NHWC;
inside, activations are channels-last (models/layers.py).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from geodiffuser_tpu_torch.config import ModelConfig
from geodiffuser_tpu_torch.models.layers import (
    Downsample2D,
    GroupNorm,
    ResnetBlock2D,
    Upsample2D,
    channels_last,
)


class VaeAttentionBlock(nn.Module):
    """Single-head self-attention over the spatial grid, its tokens a view
    of the channels-last input."""

    def __init__(self, channels: int, groups: int):
        super().__init__()
        self.group_norm = GroupNorm(groups, channels, eps=1e-6)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        y = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        q, k, v = self.to_q(y), self.to_k(y), self.to_v(y)
        logits = torch.matmul(q.float(), k.float().transpose(1, 2))
        probs = torch.softmax(logits * (c ** -0.5), dim=-1).to(v.dtype)
        y = self.to_out[0](torch.matmul(probs, v))
        return x + channels_last(y.reshape(b, h, w, c))


class _Block(nn.Module):
    def __init__(self, resnets, attentions=None, downsamplers=None, upsamplers=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if attentions:
            self.attentions = nn.ModuleList(attentions)
        if downsamplers:
            self.downsamplers = nn.ModuleList(downsamplers)
        if upsamplers:
            self.upsamplers = nn.ModuleList(upsamplers)


def _mid(ch, g):
    return _Block([ResnetBlock2D(ch, ch, g), ResnetBlock2D(ch, ch, g)], [VaeAttentionBlock(ch, g)])


def _run_mid(mid, x):
    return mid.resnets[1](mid.attentions[0](mid.resnets[0](x)))


class Encoder(nn.Module):
    def __init__(self, config: ModelConfig):
        super().__init__()
        chans = config.vae_block_out_channels
        g = 32 if chans[0] >= 32 else 8
        self.conv_in = nn.Conv2d(3, chans[0], 3, padding=1)
        blocks, x_ch = [], chans[0]
        for i, ch in enumerate(chans):
            resnets = []
            for _ in range(config.vae_layers_per_block):
                resnets.append(ResnetBlock2D(x_ch, ch, g))
                x_ch = ch
            blocks.append(_Block(resnets, downsamplers=[Downsample2D(ch)] if i < len(chans) - 1 else None))
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = _mid(chans[-1], g)
        self.conv_norm_out = GroupNorm(g, chans[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(chans[-1], 2 * config.vae_latent_channels, 3, padding=1)

    def forward(self, x):
        x = self.conv_in(x)
        for block in self.down_blocks:
            for resnet in block.resnets:
                x = resnet(x)
            if hasattr(block, "downsamplers"):
                x = block.downsamplers[0](x)
        x = _run_mid(self.mid_block, x)
        return self.conv_out(self.conv_norm_out(x, silu=True))


class Decoder(nn.Module):
    def __init__(self, config: ModelConfig):
        super().__init__()
        chans = list(reversed(config.vae_block_out_channels))
        g = 32 if chans[-1] >= 32 else 8
        self.conv_in = nn.Conv2d(config.vae_latent_channels, chans[0], 3, padding=1)
        self.mid_block = _mid(chans[0], g)
        blocks, x_ch = [], chans[0]
        for i, ch in enumerate(chans):
            resnets = []
            for _ in range(config.vae_layers_per_block + 1):
                resnets.append(ResnetBlock2D(x_ch, ch, g))
                x_ch = ch
            blocks.append(_Block(resnets, upsamplers=[Upsample2D(ch)] if i < len(chans) - 1 else None))
        self.up_blocks = nn.ModuleList(blocks)
        self.conv_norm_out = GroupNorm(g, chans[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(chans[-1], 3, 3, padding=1)

    def forward(self, z):
        x = _run_mid(self.mid_block, self.conv_in(z))
        for block in self.up_blocks:
            for resnet in block.resnets:
                x = resnet(x)
            if hasattr(block, "upsamplers"):
                x = block.upsamplers[0](x)
        return self.conv_out(self.conv_norm_out(x, silu=True))


class AutoencoderKL(nn.Module):
    def __init__(self, config: ModelConfig):
        super().__init__()
        self.config = config
        self.encoder = Encoder(config)
        self.decoder = Decoder(config)
        lc = config.vae_latent_channels
        self.quant_conv = nn.Conv2d(2 * lc, 2 * lc, 1)
        self.post_quant_conv = nn.Conv2d(lc, lc, 1)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """(S, H, W, 3) in [-1, 1] -> (S, H/8, W/8, 4) posterior mean (unscaled)."""
        dtype = self.quant_conv.weight.dtype
        moments = self.quant_conv(self.encoder(channels_last(x.to(dtype))))
        mean = moments[:, : self.config.vae_latent_channels]
        return mean.permute(0, 2, 3, 1).float()

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """(S, h, w, 4) unscaled latents -> (S, H, W, 3) float32 in [-1, 1]."""
        dtype = self.post_quant_conv.weight.dtype
        x = self.decoder(self.post_quant_conv(channels_last(z.to(dtype))))
        return x.permute(0, 2, 3, 1).float()
