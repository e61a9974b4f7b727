"""SD-1.x / SD-2.x UNet2DConditionModel in PyTorch, diffusers parameter names.

Counterpart of `geodiffuser_tpu/models/unet.py` (the model the reference
drives through diffusers, diffusion.py:99-150): conv_in; down
CrossAttnDownBlock2D x3 + DownBlock2D; mid UNetMidBlock2DCrossAttn; up
UpBlock2D + CrossAttnUpBlock2D x3; conv_norm_out/conv_out; 16 transformer
blocks = 32 attention layers.  SD-2.x takes its heads per block
(`ModelConfig.heads_for_block`) and Linear transformer projections.  The
public forward keeps the JAX package's NHWC layout: (S, H, W, 4) in,
(S, H, W, 4) float32 out; with `features=True` also each up block's output
before its upsampler (the JAX package's `features` collection, the DIFT
featurizer's taps).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from geodiffuser_tpu_torch.config import ModelConfig
from geodiffuser_tpu_torch.models.attention import Attention, Transformer2DModel
from geodiffuser_tpu_torch.models.layers import (
    Downsample2D,
    ResnetBlock2D,
    TimestepEmbedding,
    Upsample2D,
    timestep_embedding,
)
from geodiffuser_tpu_torch.utils.profiling import annotate


class _Block(nn.Module):
    """A down, mid or up block: resnets, optional attentions, optional resampler."""

    def __init__(self, resnets, attentions=None, downsamplers=None, upsamplers=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if attentions:
            self.attentions = nn.ModuleList(attentions)
        if downsamplers:
            self.downsamplers = nn.ModuleList(downsamplers)
        if upsamplers:
            self.upsamplers = nn.ModuleList(upsamplers)


class UNet2DCondition(nn.Module):
    def __init__(self, config: ModelConfig):
        super().__init__()
        self.config = config
        chans = config.block_out_channels
        n = len(chans)
        g = config.norm_num_groups
        temb_ch = chans[0] * 4

        def attn(ch, block_idx):
            return Transformer2DModel(ch, config.heads_for_block(block_idx),
                                      config.cross_attention_dim,
                                      config.transformer_layers_per_block, g,
                                      config.use_linear_projection)

        self.time_embedding = TimestepEmbedding(chans[0], temb_ch)
        self.conv_in = nn.Conv2d(config.in_channels, chans[0], 3, padding=1)
        x_ch, skip_chs = chans[0], [chans[0]]
        down = []
        for i, ch in enumerate(chans):
            resnets, attns = [], []
            for _ in range(config.layers_per_block):
                resnets.append(ResnetBlock2D(x_ch, ch, g, temb_ch))
                if i < n - 1:
                    attns.append(attn(ch, i))
                x_ch = ch
                skip_chs.append(ch)
            ds = [Downsample2D(ch)] if i < n - 1 else None
            if ds:
                skip_chs.append(ch)
            down.append(_Block(resnets, attns, downsamplers=ds))
        self.down_blocks = nn.ModuleList(down)
        self.mid_block = _Block([ResnetBlock2D(chans[-1], chans[-1], g, temb_ch),
                                 ResnetBlock2D(chans[-1], chans[-1], g, temb_ch)],
                                [attn(chans[-1], n - 1)])
        up = []
        for i, ch in enumerate(reversed(chans)):
            resnets, attns = [], []
            for _ in range(config.layers_per_block + 1):
                resnets.append(ResnetBlock2D(x_ch + skip_chs.pop(), ch, g, temb_ch))
                if i > 0:
                    attns.append(attn(ch, n - 1 - i))
                x_ch = ch
            us = [Upsample2D(ch)] if i < n - 1 else None
            up.append(_Block(resnets, attns, upsamplers=us))
        self.up_blocks = nn.ModuleList(up)
        self.conv_norm_out = nn.GroupNorm(g, chans[0], eps=1e-5)
        self.conv_out = nn.Conv2d(chans[0], config.out_channels, 3, padding=1)
        for name, module in self.named_modules():
            if isinstance(module, Attention):
                module.tap_key = name
        # each block's span in a trace (utils/profiling.annotate)
        self.down_spans = tuple(f"gd.unet.down_blocks.{i}" for i in range(n))
        self.up_spans = tuple(f"gd.unet.up_blocks.{i}" for i in range(n))

    def forward(self, sample: torch.Tensor, timestep, encoder_hidden_states: torch.Tensor,
                edit=None, acc=None, features: bool = False):
        """sample (S, H, W, 4) NHWC, timestep int or (S,), context (S, 77, C);
        `edit`/`acc` as in models/attention.py.  With `features`, returns
        (eps, {"up_block_i": (S, h, w, C) NHWC}) where up_block_i is up block
        i's output before its upsampler."""
        with annotate("gd.unet"):
            dtype = self.conv_in.weight.dtype
            s = sample.shape[0]
            t = torch.as_tensor(timestep, device=sample.device).expand(s)
            temb = self.time_embedding(timestep_embedding(t, self.config.block_out_channels[0]))
            context = encoder_hidden_states.to(dtype)
            x = self.conv_in(sample.to(dtype).permute(0, 3, 1, 2))

            skips = [x]
            for block, span in zip(self.down_blocks, self.down_spans):
                with annotate(span):
                    for j, resnet in enumerate(block.resnets):
                        x = resnet(x, temb)
                        if hasattr(block, "attentions"):
                            x = block.attentions[j](x, context, edit, acc)
                        skips.append(x)
                    if hasattr(block, "downsamplers"):
                        x = block.downsamplers[0](x)
                        skips.append(x)

            mid = self.mid_block
            with annotate("gd.unet.mid_block"):
                x = mid.resnets[0](x, temb)
                x = mid.attentions[0](x, context, edit, acc)
                x = mid.resnets[1](x, temb)

            taps = {}
            for i, (block, span) in enumerate(zip(self.up_blocks, self.up_spans)):
                with annotate(span):
                    for j, resnet in enumerate(block.resnets):
                        x = resnet(torch.cat([x, skips.pop()], dim=1), temb)
                        if hasattr(block, "attentions"):
                            x = block.attentions[j](x, context, edit, acc)
                    if features:
                        taps[f"up_block_{i}"] = x.permute(0, 2, 3, 1)
                    if hasattr(block, "upsamplers"):
                        x = block.upsamplers[0](x)

            x = self.conv_out(F.silu(self.conv_norm_out(x)))
            eps = x.permute(0, 2, 3, 1).float()
        return (eps, taps) if features else eps
