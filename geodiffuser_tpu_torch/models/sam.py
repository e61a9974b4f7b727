"""Segment Anything (SAM) in PyTorch, published names.

Counterpart of `geodiffuser_tpu/models/sam.py` (the reference vendors
segment_anything and uses it for point-prompted object masks,
depth_predictor.py:53-102):

  * ImageEncoderViT: a patch-16 ViT with windowed attention (windows of
    14, the 64-token grid padded to 70), decomposed relative position
    biases, global-attention blocks and a conv neck to 256 channels;
  * PromptEncoder: random-Fourier positional encoding (the
    `positional_encoding_gaussian_matrix` buffer), learned point-type
    embeddings;
  * MaskDecoder: a two-way transformer over the IoU and 4 mask tokens and
    the image embedding, transposed-conv upscaling, per-token hypernetwork
    MLPs, an IoU head.

The modules carry the published checkpoint's names (`sam_vit_h_4b8939.pth`);
the mask-prompt path (`prompt_encoder.mask_downscaling`) is not built, as in
the JAX package, and its keys are not consumed (`models/weights.py`).  Every
attention is the plain softmax product in float32, as in the JAX package: a
global block at 1024^2 holds 16 x 4096^2 float32 logits (1 GiB).  GELU is
exact everywhere; the decoder's LayerNorms take the JAX package's epsilon
(flax's 1e-6; the published decoder's torch LayerNorms use 1e-5).  Maps are
NHWC at the public functions.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class SamConfig:
    img_size: int = 1024
    patch_size: int = 16
    embed_dim: int = 1280
    depth: int = 32
    num_heads: int = 16
    global_attn_indexes: Tuple[int, ...] = (7, 15, 23, 31)
    window_size: int = 14
    out_chans: int = 256
    decoder_dim: int = 256
    decoder_heads: int = 8
    decoder_mlp_dim: int = 2048
    num_multimask: int = 3

    @staticmethod
    def vit_h() -> "SamConfig":
        return SamConfig()

    @staticmethod
    def vit_l() -> "SamConfig":
        return SamConfig(embed_dim=1024, depth=24, num_heads=16,
                         global_attn_indexes=(5, 11, 17, 23))

    @staticmethod
    def vit_b() -> "SamConfig":
        return SamConfig(embed_dim=768, depth=12, num_heads=12,
                         global_attn_indexes=(2, 5, 8, 11))

    @staticmethod
    def tiny() -> "SamConfig":
        return SamConfig(
            img_size=64, patch_size=8, embed_dim=32, depth=2, num_heads=2,
            global_attn_indexes=(1,), window_size=4, out_chans=16,
            decoder_dim=16, decoder_heads=2, decoder_mlp_dim=32,
        )


class LayerNorm2d(nn.Module):
    """Channel LayerNorm of an NHWC map (SAM's LayerNorm2d, eps 1e-6)."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) / torch.sqrt(var + 1e-6) * self.weight + self.bias


def _rel_table(table: torch.Tensor, q_size: int, k_size: int) -> torch.Tensor:
    """(q_size, k_size, dim) rows of a relative-position table, indexed by
    the integer cast of SAM's scaled coordinates (get_rel_pos)."""
    dev = table.device
    coords_q = torch.arange(q_size, dtype=torch.float32, device=dev)[:, None] * max(k_size / q_size, 1.0)
    coords_k = torch.arange(k_size, dtype=torch.float32, device=dev)[None, :] * max(q_size / k_size, 1.0)
    rel = coords_q - coords_k + (k_size - 1) * max(q_size / k_size, 1.0)
    return table[rel.long()]


def rel_pos_bias(q: torch.Tensor, rel_h: torch.Tensor, rel_w: torch.Tensor,
                 qh: int, qw: int, kh: int, kw: int) -> torch.Tensor:
    """Decomposed relative position bias, q (B, qh*qw, dim), tables
    (2*size-1, dim) -> (B, qh*qw, kh*kw), as the JAX package computes it
    (`geodiffuser_tpu/models/sam.py:_rel_pos_bias`): the width term of
    query (i, j) and key (k, l) is taken at query column k, not j, because
    the JAX package broadcasts it as (B, qh, 1, qw, kw).  The published
    add_decomposed_rel_pos takes it at j (ROADMAP.md, Queue 3); the two
    agree only where the width table is zero."""
    b = q.shape[0]
    r_q = q.reshape(b, qh, qw, -1)
    bias_h = torch.einsum("bhwc,hkc->bhwk", r_q, _rel_table(rel_h, qh, kh))
    bias_w = torch.einsum("bhwc,wkc->bhwk", r_q, _rel_table(rel_w, qw, kw))
    return (bias_h[..., :, None] + bias_w[:, :, None]).reshape(b, qh * qw, kh * kw)


class WindowedAttention(nn.Module):
    def __init__(self, c: SamConfig, input_size: Tuple[int, int]):
        super().__init__()
        d = c.embed_dim
        self.heads = c.num_heads
        hd = d // c.num_heads
        self.qkv = nn.Linear(d, 3 * d)
        self.proj = nn.Linear(d, d)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size[0] - 1, hd))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size[1] - 1, hd))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, d = x.shape
        nh, hd = self.heads, d // self.heads
        qkv = self.qkv(x.reshape(b, h * w, d)).reshape(b, h * w, 3, nh, hd).permute(2, 0, 3, 1, 4)
        q, k, v = (t.reshape(b * nh, h * w, hd) for t in qkv)
        q_s = q * hd ** -0.5
        logits = (q_s @ k.transpose(-1, -2)).float()
        logits += rel_pos_bias(q_s * hd ** 0.5, self.rel_pos_h, self.rel_pos_w, h, w, h, w)
        out = torch.softmax(logits, dim=-1).to(v.dtype) @ v
        out = out.reshape(b, nh, h * w, hd).transpose(1, 2).reshape(b, h, w, d)
        return self.proj(out)


def window_partition(x: torch.Tensor, ws: int):
    """(B, H, W, C) -> (B * windows, ws, ws, C), zero-padded to multiples of ws."""
    b, h, w, c = x.shape
    pad_h, pad_w = (ws - h % ws) % ws, (ws - w % ws) % ws
    x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    hp, wp = h + pad_h, w + pad_w
    x = x.reshape(b, hp // ws, ws, wp // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws, ws, c), (hp, wp)


def window_unpartition(wins: torch.Tensor, ws: int, pad_hw, hw) -> torch.Tensor:
    hp, wp = pad_hw
    h, w = hw
    b = wins.shape[0] // (hp * wp // ws // ws)
    x = wins.reshape(b, hp // ws, wp // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, hp, wp, -1)[:, :h, :w]


class _EncoderMlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.lin1 = nn.Linear(dim, hidden)
        self.lin2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.lin2(F.gelu(self.lin1(x)))


class SamEncoderBlock(nn.Module):
    def __init__(self, c: SamConfig, window_size: int):
        super().__init__()
        self.window_size = window_size        # 0: global attention
        grid = c.img_size // c.patch_size
        size = (window_size, window_size) if window_size > 0 else (grid, grid)
        self.norm1 = nn.LayerNorm(c.embed_dim, eps=1e-6)
        self.attn = WindowedAttention(c, size)
        self.norm2 = nn.LayerNorm(c.embed_dim, eps=1e-6)
        self.mlp = _EncoderMlp(c.embed_dim, c.embed_dim * 4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        x = self.norm1(x)
        if self.window_size > 0:
            wins, pad_hw = window_partition(x, self.window_size)
            x = window_unpartition(self.attn(wins), self.window_size, pad_hw, x.shape[1:3])
        else:
            x = self.attn(x)
        x = shortcut + x
        return x + self.mlp(self.norm2(x))


class _PatchEmbed(nn.Module):
    def __init__(self, c: SamConfig):
        super().__init__()
        self.proj = nn.Conv2d(3, c.embed_dim, c.patch_size, stride=c.patch_size)


class ImageEncoderViT(nn.Module):
    def __init__(self, c: SamConfig):
        super().__init__()
        grid = c.img_size // c.patch_size
        self.patch_embed = _PatchEmbed(c)
        self.pos_embed = nn.Parameter(torch.zeros(1, grid, grid, c.embed_dim))
        self.blocks = nn.ModuleList([
            SamEncoderBlock(c, 0 if i in c.global_attn_indexes else c.window_size)
            for i in range(c.depth)])
        self.neck = nn.ModuleList([
            nn.Conv2d(c.embed_dim, c.out_chans, 1, bias=False), LayerNorm2d(c.out_chans),
            nn.Conv2d(c.out_chans, c.out_chans, 3, padding=1, bias=False),
            LayerNorm2d(c.out_chans)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, img, img, 3) preprocessed pixels -> (B, grid, grid, out_chans)."""
        dtype = self.patch_embed.proj.weight.dtype
        x = self.patch_embed.proj(x.to(dtype).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        x = x + self.pos_embed.to(dtype)
        for block in self.blocks:
            x = block(x)
        conv0, ln1, conv2, ln3 = self.neck
        x = ln1(conv0(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1))
        return ln3(conv2(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1))


class _PositionEmbeddingRandom(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix", torch.zeros(2, dim // 2))

    def forward(self, coords: torch.Tensor) -> torch.Tensor:
        """coords in [0, 1] (..., 2) -> (..., dim) Fourier features."""
        c = (2.0 * coords - 1.0) @ self.positional_encoding_gaussian_matrix
        c = 2.0 * math.pi * c
        return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)


class PromptEncoder(nn.Module):
    def __init__(self, c: SamConfig):
        super().__init__()
        self.img_size = c.img_size
        self.pe_layer = _PositionEmbeddingRandom(c.decoder_dim)
        # 0: negative point, 1: positive point, 2 / 3: box corners
        self.point_embeddings = nn.ModuleList([nn.Embedding(1, c.decoder_dim) for _ in range(4)])
        self.not_a_point_embed = nn.Embedding(1, c.decoder_dim)
        self.no_mask_embed = nn.Embedding(1, c.decoder_dim)

    def dense_pe(self, grid: int) -> torch.Tensor:
        """(grid, grid, dim) positional grid of the image embedding."""
        dev = self.pe_layer.positional_encoding_gaussian_matrix.device
        t = (torch.arange(grid, dtype=torch.float32, device=dev) + 0.5) / grid
        yy, xx = torch.meshgrid(t, t, indexing="ij")
        return self.pe_layer(torch.stack([xx, yy], dim=-1))

    def forward(self, points: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """points (B, N, 2) in [0, img_size], labels (B, N) in {-1, 0, 1}
        (-1: padding) -> sparse embeddings (B, N + 1, dim): a padding point
        is appended, as SAM does when no box is given."""
        b = points.shape[0]
        points = torch.cat([points + 0.5, torch.zeros_like(points[:, :1])], dim=1) / self.img_size
        labels = torch.cat([labels, -torch.ones_like(labels[:, :1])], dim=1)[..., None]
        pe = self.pe_layer(points)
        emb = torch.where(labels == -1, self.not_a_point_embed.weight[0], pe)
        emb = torch.where(labels == 0, emb + self.point_embeddings[0].weight[0], emb)
        return torch.where(labels == 1, emb + self.point_embeddings[1].weight[0], emb)


class _DecoderAttention(nn.Module):
    def __init__(self, dim: int, heads: int, downsample: int = 1):
        super().__init__()
        d = dim // downsample
        self.heads = heads
        self.q_proj = nn.Linear(dim, d)
        self.k_proj = nn.Linear(dim, d)
        self.v_proj = nn.Linear(dim, d)
        self.out_proj = nn.Linear(d, dim)

    def forward(self, q, k, v):
        qp, kp, vp = self.q_proj(q), self.k_proj(k), self.v_proj(v)
        b, lq, d = qp.shape
        hd = d // self.heads
        split = lambda t: t.reshape(b, t.shape[1], self.heads, hd).transpose(1, 2)
        qp, kp, vp = split(qp), split(kp), split(vp)
        probs = torch.softmax((qp @ kp.transpose(-1, -2)) * hd ** -0.5, dim=-1)
        return self.out_proj((probs @ vp).transpose(1, 2).reshape(b, lq, d))


class _DecoderMlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.lin1 = nn.Linear(dim, hidden)
        self.lin2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.lin2(F.relu(self.lin1(x)))


class TwoWayBlock(nn.Module):
    def __init__(self, c: SamConfig, skip_first_pe: bool = False):
        super().__init__()
        d, nh = c.decoder_dim, c.decoder_heads
        self.skip_first_pe = skip_first_pe
        self.self_attn = _DecoderAttention(d, nh)
        self.norm1 = nn.LayerNorm(d, eps=1e-6)
        self.cross_attn_token_to_image = _DecoderAttention(d, nh, downsample=2)
        self.norm2 = nn.LayerNorm(d, eps=1e-6)
        self.mlp = _DecoderMlp(d, c.decoder_mlp_dim)
        self.norm3 = nn.LayerNorm(d, eps=1e-6)
        self.norm4 = nn.LayerNorm(d, eps=1e-6)
        self.cross_attn_image_to_token = _DecoderAttention(d, nh, downsample=2)

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_pe:
            # the first block replaces the queries by the self-attention
            # output (no residual, no pe): TwoWayAttentionBlock
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)
        q, k = queries + query_pe, keys + key_pe
        queries = self.norm2(queries + self.cross_attn_token_to_image(q, k, keys))
        queries = self.norm3(queries + self.mlp(queries))
        q, k = queries + query_pe, keys + key_pe
        keys = self.norm4(keys + self.cross_attn_image_to_token(k, q, queries))
        return queries, keys


class _TwoWayTransformer(nn.Module):
    def __init__(self, c: SamConfig):
        super().__init__()
        self.layers = nn.ModuleList([TwoWayBlock(c, skip_first_pe=i == 0) for i in range(2)])
        self.final_attn_token_to_image = _DecoderAttention(c.decoder_dim, c.decoder_heads, 2)
        self.norm_final_attn = nn.LayerNorm(c.decoder_dim, eps=1e-6)


class _Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, out: int, n: int = 3):
        super().__init__()
        sizes = [dim] + [hidden] * (n - 1) + [out]
        self.layers = nn.ModuleList([nn.Linear(a, b) for a, b in zip(sizes[:-1], sizes[1:])])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class MaskDecoder(nn.Module):
    def __init__(self, c: SamConfig):
        super().__init__()
        dim = c.decoder_dim
        self.n_mask_tokens = c.num_multimask + 1
        self.transformer = _TwoWayTransformer(c)
        self.iou_token = nn.Embedding(1, dim)
        self.mask_tokens = nn.Embedding(self.n_mask_tokens, dim)
        self.output_upscaling = nn.ModuleList([
            nn.ConvTranspose2d(dim, dim // 4, 2, stride=2), LayerNorm2d(dim // 4), nn.GELU(),
            nn.ConvTranspose2d(dim // 4, dim // 8, 2, stride=2), nn.GELU()])
        self.output_hypernetworks_mlps = nn.ModuleList([
            _Mlp(dim, dim, dim // 8) for _ in range(self.n_mask_tokens)])
        self.iou_prediction_head = _Mlp(dim, dim, self.n_mask_tokens)

    def forward(self, image_embedding, image_pe, sparse_prompts):
        """image_embedding (B, g, g, dim), image_pe (g, g, dim), sparse
        prompts (B, N, dim) -> (masks (B, 4, 4g, 4g), iou (B, 4))."""
        b, g, _, dim = image_embedding.shape
        out_tokens = torch.cat([self.iou_token.weight, self.mask_tokens.weight], dim=0)
        tokens = torch.cat([out_tokens[None].expand(b, -1, -1), sparse_prompts], dim=1)
        keys = image_embedding.reshape(b, g * g, dim)
        key_pe = image_pe.reshape(1, g * g, dim)
        queries = tokens
        tf = self.transformer
        for layer in tf.layers:
            queries, keys = layer(queries, keys, tokens, key_pe)
        q, k = queries + tokens, keys + key_pe
        queries = tf.norm_final_attn(queries + tf.final_attn_token_to_image(q, k, keys))
        iou_out = queries[:, 0]
        mask_toks = queries[:, 1:1 + self.n_mask_tokens]

        up0, ln1, _, up3, _ = self.output_upscaling
        img = keys.reshape(b, g, g, dim).permute(0, 3, 1, 2)
        up = F.gelu(ln1(up0(img).permute(0, 2, 3, 1)))
        up = F.gelu(up3(up.permute(0, 3, 1, 2))).permute(0, 2, 3, 1)
        hyper = torch.stack([mlp(mask_toks[:, i])
                             for i, mlp in enumerate(self.output_hypernetworks_mlps)], dim=1)
        masks = torch.einsum("bnc,bhwc->bnhw", hyper, up)
        return masks, self.iou_prediction_head(iou_out)


class Sam(nn.Module):
    def __init__(self, cfg: SamConfig = SamConfig()):
        super().__init__()
        self.cfg = cfg
        self.image_encoder = ImageEncoderViT(cfg)
        self.prompt_encoder = PromptEncoder(cfg)
        self.mask_decoder = MaskDecoder(cfg)

    def encode_image(self, x: torch.Tensor) -> torch.Tensor:
        return self.image_encoder(x)

    def predict_masks(self, image_embedding, points, labels):
        grid = self.cfg.img_size // self.cfg.patch_size
        sparse = self.prompt_encoder(points, labels)
        pe = self.prompt_encoder.dense_pe(grid)
        # no mask prompt: no_mask_embed over the grid, added to the image
        # embedding (SAM's dense prompt embedding)
        dense = self.prompt_encoder.no_mask_embed.weight[0]
        return self.mask_decoder(image_embedding + dense, pe, sparse)

    def forward(self, x, points, labels):
        return self.predict_masks(self.encode_image(x), points, labels)
