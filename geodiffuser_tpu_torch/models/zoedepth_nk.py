"""ZoeDepth-NK: a BEiT-384 MiDaS core and two latitude-routed metric heads,
in PyTorch.

Counterpart of `geodiffuser_tpu/models/zoedepth_nk.py`, the architecture of
the reference's shipped metric-depth checkpoint (ZoeD-M12-NK:
zoedepth/models/zoedepth_nk/zoedepth_nk_v1.py, loaded by
get_monocular_ZoeDepth, depth_predictor.py:277-319):

  * BEiT-L/16 (midas_repo/backbones/beit.py): a relative-position bias table
    a block, resized linearly for windows other than the training one with
    the reference's (width, height) reshape quirk, layer-scale gamma_1 and
    gamma_2, learned q and v biases with a zero k bias, no absolute
    positions;
  * the MiDaS DPT scratch with the MidasCore taps (`models/midas_dpt.py`);
  * a patch-transformer domain router (patch_transformer.py:29-91: a 4-layer
    post-norm transformer encoder over 1x1-patch embeddings, a zero class
    token, concatenated sin / cos positions) voting nyu against kitti over
    the batch (zoedepth_nk_v1.py:188-199);
  * one seed bin regressor, attractor stack and conditional log-binomial
    head a domain (`models/zoedepth.py`).

The JAX model evaluates both heads and selects one with `jnp.where`; here
the vote (argmax of the domain logits summed over the batch) is read on the
host and only the head it picks runs, which gives the same depth.  Module
names are ZoeD-M12-NK's (`core.core.pretrained.model.blocks.N.attn.…`,
`patch_transformer.transformer_encoder.layers.N.self_attn.…`,
`seed_bin_regressors.{nyu,kitti}._net.N`, …); the checkpoint's
`relative_position_index` buffers and final norm are not consumed.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from geodiffuser_tpu_torch.models.depth_anything import resize_align_corners
from geodiffuser_tpu_torch.models.dinov2 import _Mlp
from geodiffuser_tpu_torch.models.midas_dpt import (
    Scratch, _DPTPretrained, _PatchEmbed, reassemble, vit_postprocess,
)
from geodiffuser_tpu_torch.models.zoedepth import (
    ConditionalLogBinomial, MidasCore, Projector, SeedBinRegressorUnnormed, attractor_stack,
    expected_depth, refine_bins,
)
from geodiffuser_tpu_torch.ops.image import resize_linear_jax


@dataclasses.dataclass(frozen=True)
class BEiTConfig:
    """beit_large_patch16_384 geometry (timm), MiDaS dpt_beit_large_384 hook
    set (midas_repo/backbones/beit.py:174-182)."""

    patch_size: int = 16
    embed_dim: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_ratio: int = 4
    train_window: Tuple[int, int] = (24, 24)   # 384 / 16
    hooks: Tuple[int, ...] = (5, 11, 17, 23)
    post_channels: Tuple[int, ...] = (256, 512, 1024, 1024)
    features: int = 256

    @staticmethod
    def tiny() -> "BEiTConfig":
        return BEiTConfig(patch_size=4, embed_dim=32, depth=4, num_heads=2,
                          train_window=(8, 8), hooks=(0, 1, 2, 3),
                          post_channels=(8, 16, 32, 32), features=16)


@functools.lru_cache(maxsize=16)
def gen_relative_position_index(window: Tuple[int, int]) -> np.ndarray:
    """timm.models.beit.gen_relative_position_index: (wh * ww + 1)^2 int32
    indices into the bias table, whose last three rows are cls-to-token,
    token-to-cls and cls-to-cls."""
    wh, ww = window
    num_rel = (2 * wh - 1) * (2 * ww - 1) + 3
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    n = wh * ww
    idx = np.zeros((n + 1, n + 1), np.int64)
    idx[1:, 1:] = rel.sum(-1)
    idx[0, 0:] = num_rel - 3
    idx[0:, 0] = num_rel - 2
    idx[0, 0] = num_rel - 1
    return idx.astype(np.int32)


def relative_position_bias(table: torch.Tensor, train_window: Tuple[int, int],
                           window: Tuple[int, int]) -> torch.Tensor:
    """(heads, N + 1, N + 1) bias of a window from a block's table, the table
    resized when the window is not the training one (beit.py:29-62): its
    rows are read as a (2 tw - 1, 2 th - 1) grid and resized to
    (2 wh - 1, 2 ww - 1), the reference's quirk, kept for its checkpoints."""
    th, tw = train_window
    wh, ww = window
    n_train = (2 * th - 1) * (2 * tw - 1)
    heads = table.shape[1]
    if (wh, ww) != (th, tw):
        grid = table[:n_train].reshape(2 * tw - 1, 2 * th - 1, heads).permute(2, 0, 1)
        sub = resize_linear_jax(grid, 2 * wh - 1, 2 * ww - 1).permute(1, 2, 0)
        table = torch.cat([sub.reshape(-1, heads), table[n_train:]], dim=0)
    idx = torch.from_numpy(gen_relative_position_index((wh, ww))).to(table.device).long()
    n = wh * ww + 1
    return table[idx.reshape(-1)].reshape(n, n, heads).permute(2, 0, 1)


class BEiTAttention(nn.Module):
    def __init__(self, cfg: BEiTConfig):
        super().__init__()
        d = cfg.embed_dim
        th, tw = self.train_window = cfg.train_window
        self.heads = cfg.num_heads
        self.qkv = nn.Linear(d, 3 * d, bias=False)
        self.q_bias = nn.Parameter(torch.zeros(d))
        self.v_bias = nn.Parameter(torch.zeros(d))
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * th - 1) * (2 * tw - 1) + 3, cfg.num_heads))
        self.proj = nn.Linear(d, d)

    def forward(self, x: torch.Tensor, window: Tuple[int, int]) -> torch.Tensor:
        b, l, d = x.shape
        hd = d // self.heads
        bias = torch.cat([self.q_bias, torch.zeros_like(self.q_bias), self.v_bias])
        qkv = F.linear(x, self.qkv.weight, bias)
        q, k, v = qkv.reshape(b, l, 3, self.heads, hd).permute(2, 0, 3, 1, 4)
        logits = (q * hd ** -0.5) @ k.transpose(-1, -2)
        logits = logits + relative_position_bias(self.relative_position_bias_table,
                                                 self.train_window, window)[None]
        att = (torch.softmax(logits, dim=-1) @ v).transpose(1, 2).reshape(b, l, d)
        return self.proj(att)


class BEiTBlock(nn.Module):
    def __init__(self, cfg: BEiTConfig):
        super().__init__()
        d = cfg.embed_dim
        self.norm1 = nn.LayerNorm(d, eps=1e-6)
        self.attn = BEiTAttention(cfg)
        self.norm2 = nn.LayerNorm(d, eps=1e-6)
        self.mlp = _Mlp(d, d * cfg.mlp_ratio)
        self.gamma_1 = nn.Parameter(torch.full((d,), 0.1))
        self.gamma_2 = nn.Parameter(torch.full((d,), 0.1))

    def forward(self, x: torch.Tensor, window: Tuple[int, int]) -> torch.Tensor:
        x = x + self.gamma_1 * self.attn(self.norm1(x), window)
        return x + self.gamma_2 * self.mlp(self.norm2(x))


class BEiT(nn.Module):
    """timm's BEiT as MiDaS holds it (`pretrained.model`): patch embedding,
    class token, blocks; no absolute positions."""

    def __init__(self, c: BEiTConfig):
        super().__init__()
        self.patch_embed = _PatchEmbed(3, c.embed_dim, c.patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, c.embed_dim))
        self.blocks = nn.ModuleList([BEiTBlock(c) for _ in range(c.depth)])

    def tokens(self, x: torch.Tensor, hooks: Tuple[int, ...]):
        x = self.patch_embed.proj(x)
        b, _, ph, pw = x.shape
        x = torch.cat([self.cls_token.expand(b, -1, -1), x.flatten(2).transpose(1, 2)], dim=1)
        taps = []
        for i, block in enumerate(self.blocks):
            x = block(x, (ph, pw))
            if i in hooks:
                taps.append(x)
        return taps


class BEiTCore(nn.Module):
    """BEiT and the MiDaS DPT scratch, returning the MidasCore taps:
    (relative depth, the 32-channel head activation, layer4_rn's output,
    [r4, r3, r2, r1])."""

    def __init__(self, cfg: BEiTConfig = BEiTConfig()):
        super().__init__()
        c = self.cfg = cfg
        posts = vit_postprocess(c.embed_dim, c.post_channels)
        self.pretrained = _DPTPretrained(BEiT(c), {i + 1: p for i, p in enumerate(posts)})
        self.scratch = Scratch(c.post_channels, c.features, c.features // 2)

    def forward(self, x: torch.Tensor):
        c = self.cfg
        ph, pw = x.shape[1] // c.patch_size, x.shape[2] // c.patch_size
        tokens = self.pretrained.model.tokens(x.permute(0, 3, 1, 2), c.hooks)
        feats = [reassemble(getattr(self.pretrained, f"act_postprocess{i + 1}"), t, ph, pw)
                 for i, t in enumerate(tokens)]
        btlnck, blocks = self.scratch.fuse(feats)
        feat32, rel = self.scratch.head(blocks[3])
        return rel[:, 0], feat32, btlnck, blocks


def sinusoidal_encoding_1d(seq_len: int, dim: int) -> np.ndarray:
    """patch_transformer.py:52-69: concatenated (not interleaved) sin, cos."""
    pos = np.arange(seq_len, dtype=np.float32)[:, None]
    idx = np.arange(0, dim, 2, dtype=np.float32)[None, :]
    div = np.exp(idx * (-math.log(10000.0) / dim))
    enc = pos * div
    return np.concatenate([np.sin(enc), np.cos(enc)], axis=1).astype(np.float32)


class _SelfAttention(nn.Module):
    """nn.MultiheadAttention's parameters: in_proj_weight / in_proj_bias and
    out_proj."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape
        hd = d // self.heads
        qkv = F.linear(x, self.in_proj_weight, self.in_proj_bias)
        q, k, v = qkv.reshape(b, s, 3, self.heads, hd).permute(2, 0, 3, 1, 4)
        p = torch.softmax((q * hd ** -0.5) @ k.transpose(-1, -2), dim=-1)
        return self.out_proj((p @ v).transpose(1, 2).reshape(b, s, d))


class TorchTransformerEncoderLayer(nn.Module):
    """Post-norm nn.TransformerEncoderLayer at inference: ReLU feed-forward,
    LayerNorm eps 1e-5."""

    def __init__(self, dim: int = 128, heads: int = 4, ff: int = 1024):
        super().__init__()
        self.self_attn = _SelfAttention(dim, heads)
        self.linear1 = nn.Linear(dim, ff)
        self.linear2 = nn.Linear(ff, dim)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.norm1(x + self.self_attn(x))
        return self.norm2(x + self.linear2(F.relu(self.linear1(x))))


class _Encoder(nn.Module):
    def __init__(self, dim: int, num_layers: int, heads: int):
        super().__init__()
        self.layers = nn.ModuleList([TorchTransformerEncoderLayer(dim, heads)
                                     for _ in range(num_layers)])


class PatchTransformerEncoder(nn.Module):
    """zoedepth layers/patch_transformer.py with patch_size 1 and a class
    token (the NK router's configuration, zoedepth_nk_v1.py:101-103)."""

    def __init__(self, cin: int, embedding_dim: int = 128, num_layers: int = 4, heads: int = 4):
        super().__init__()
        self.embedding_convPxP = nn.Conv2d(cin, embedding_dim, 1)
        self.transformer_encoder = _Encoder(embedding_dim, num_layers, heads)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, C, H, W) -> (B, 1 + H * W, E); [:, 0] is the class token."""
        e = self.embedding_convPxP(x).flatten(2).transpose(1, 2)
        e = torch.cat([torch.zeros_like(e[:, :1]), e], dim=1)
        pos = sinusoidal_encoding_1d(e.shape[1], e.shape[2])
        e = e + torch.from_numpy(pos).to(e.device)[None]
        for layer in self.transformer_encoder.layers:
            e = layer(e)
        return e


@dataclasses.dataclass(frozen=True)
class BinConf:
    name: str
    n_bins: int
    min_depth: float
    max_depth: float


@dataclasses.dataclass(frozen=True)
class ZoeDepthNKConfig:
    """config_zoedepth_nk.json values."""

    core: BEiTConfig = BEiTConfig()
    bin_conf: Tuple[BinConf, ...] = (
        BinConf("nyu", 64, 1e-3, 10.0),
        BinConf("kitti", 64, 1e-3, 80.0),
    )
    bin_embedding_dim: int = 128
    n_attractors: Tuple[int, ...] = (16, 8, 4, 1)
    # the attractors apply the reference's default alpha and gamma (300, 2),
    # not the published configuration's 1000 (models/zoedepth.py)
    attractor_kind: str = "mean"
    attractor_type: str = "inv"
    min_temp: float = 0.0212
    max_temp: float = 50.0

    @staticmethod
    def tiny() -> "ZoeDepthNKConfig":
        return ZoeDepthNKConfig(
            core=BEiTConfig.tiny(),
            bin_conf=(BinConf("nyu", 8, 1e-3, 10.0), BinConf("kitti", 8, 1e-3, 80.0)),
            bin_embedding_dim=16, n_attractors=(4, 2, 2, 1),
        )


class ZoeDepthNK(nn.Module):
    """(B, H, W, 3) normalized image -> (B, H, W) metric depth
    (ZoeDepthNK.forward, zoedepth_nk_v1.py:160-243); with
    `return_domain_logits`, also the router's (B, 2) logits."""

    def __init__(self, cfg: ZoeDepthNKConfig = ZoeDepthNKConfig()):
        super().__init__()
        c = self.cfg = cfg
        f, e = c.core.features, c.bin_embedding_dim
        self.core = MidasCore(BEiTCore(c.core))
        self.conv2 = nn.Conv2d(f, f, 1)
        self.patch_transformer = PatchTransformerEncoder(f, 128)
        self.mlp_classifier = nn.Sequential(nn.Linear(128, 128), nn.ReLU(), nn.Linear(128, 2))
        self.seed_projector = Projector(f, e)
        self.projectors = nn.ModuleList([Projector(f, e) for _ in c.n_attractors])
        self.seed_bin_regressors = nn.ModuleDict(
            {b.name: SeedBinRegressorUnnormed(f, b.n_bins) for b in c.bin_conf})
        self.attractors = nn.ModuleDict({b.name: attractor_stack(c, b.n_bins) for b in c.bin_conf})
        # NK conditions the log-binomial on the 32-channel head activation
        # alone (zoedepth_nk_v1.py:223-231), unlike the single-head model
        self.conditional_log_binomial = nn.ModuleDict({
            b.name: ConditionalLogBinomial(32, e, b.n_bins, bottleneck_factor=4,
                                           min_temp=c.min_temp, max_temp=c.max_temp)
            for b in c.bin_conf})

    def forward(self, x: torch.Tensor, return_domain_logits: bool = False):
        rel, feat32, btlnck, blocks = self.core(x)
        z = self.conv2(btlnck)
        domain_logits = self.mlp_classifier(self.patch_transformer(z)[:, 0])   # (B, 2)
        vote = int(torch.argmax(domain_logits.sum(0)))
        name = self.cfg.bin_conf[vote].name
        embs = [p(xb) for p, xb in zip(self.projectors, blocks)]
        b_centers, prev_emb = refine_bins(self.attractors[name], embs,
                                          self.seed_bin_regressors[name](z),
                                          self.seed_projector(z))
        emb_up = resize_align_corners(prev_emb, feat32.shape[2], feat32.shape[3])
        probs = self.conditional_log_binomial[name](feat32, emb_up)
        depth = expected_depth(probs, b_centers, x.shape[1:3])
        if return_domain_logits:
            return depth, domain_logits
        return depth
