"""UNet attention modules with the GeoDiffuser edit hook.

Counterpart of `geodiffuser_tpu/models/attention.py`.  Where the JAX package
sows into flax collections, the port passes two explicit objects down the
forward: `edit` (None for vanilla attention, a `RecordTaps` that records
each layer's base-stream q/k/v, or an `EditState`, whose `taps` dict feeds
the one-stream edit pass) and `acc`, a `LossAccumulator` that sums the
per-layer losses and logs.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from portbench.reference.gd.core import edit_attention
from portbench.reference.gd.core.edit_state import EditState, LossAccumulator, RecordTaps
from portbench.reference.gd.models.layers import FeedForward


class Attention(nn.Module):
    """Multi-head attention, diffusers layout (to_q/to_k/to_v/to_out.0) on
    (S, L, C) inputs; heads are an explicit axis inside: (S, H, L, D)."""

    def __init__(self, query_dim: int, heads: int, cross_attention_dim: Optional[int] = None):
        super().__init__()
        self.heads = heads
        kv_dim = cross_attention_dim or query_dim
        self.to_q = nn.Linear(query_dim, query_dim, bias=False)
        self.to_k = nn.Linear(kv_dim, query_dim, bias=False)
        self.to_v = nn.Linear(kv_dim, query_dim, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(query_dim, query_dim)])
        self.tap_key = ""   # the layer's name in the UNet, set by the UNet

    def forward(self, x, context=None, edit=None, acc: Optional[LossAccumulator] = None):
        is_cross = context is not None
        ctx = context if is_cross else x
        s, lq, inner = x.shape
        lk = ctx.shape[1]
        d = inner // self.heads
        scale = d ** -0.5
        # contiguous heads: the base and edit streams of the two passes of an
        # optimize step then take one matmul path whatever the group size
        q, k, v = (proj(y).reshape(s, n, self.heads, d).transpose(1, 2).contiguous()
                   for proj, y, n in ((self.to_q, x, lq), (self.to_k, ctx, lk),
                                      (self.to_v, ctx, lk)))

        if isinstance(edit, RecordTaps):
            # base-stream pass: vanilla attention + record q/k/v for the
            # one-stream differentiated edit pass
            edit.taps[self.tap_key] = (q, k, v)
            out = edit_attention.fast_attention(q, k, v, scale)
        elif edit is None:
            out = edit_attention.fast_attention(q, k, v, scale)
        else:
            e = edit.n_edits
            if edit.consume_taps:
                # rebuild each edit's [base, edit...] streams at the
                # attention boundary only: the taps pass ran one base stream
                # an edit
                q, k, v = (_join_tap(tap.detach(), x, e) for tap, x in
                           zip(edit.taps[self.tap_key], (q, k, v)))
            out, loss, logs = edit_attention.edited_attention(
                q, k, v, is_cross=is_cross, state=edit, scale=scale)
            if edit.consume_taps:
                out = out.reshape(e, -1, *out.shape[1:])[:, 1:].reshape(
                    s, *out.shape[1:]).contiguous()
            if acc is not None:
                acc.add(loss, logs)
        out = out.transpose(1, 2).reshape(s, lq, inner)
        return self.to_out[0](out)


def _join_tap(tap, x, e: int):
    """Each of e edits' tap stream (e, H, L, D) put before its streams of x
    (e*S, H, L, D) -> (e*(1+S), H, L, D)."""
    return torch.cat([tap.reshape(e, 1, *tap.shape[1:]), x.reshape(e, -1, *x.shape[1:])],
                     dim=1).reshape(-1, *x.shape[1:])


class BasicTransformerBlock(nn.Module):
    """LN -> self-attn -> LN -> cross-attn -> LN -> GEGLU feed-forward."""

    def __init__(self, dim: int, heads: int, cross_attention_dim: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = Attention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = Attention(dim, heads, cross_attention_dim)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim)

    def forward(self, x, context, edit=None, acc=None):
        x = x + self.attn1(self.norm1(x), None, edit, acc)
        x = x + self.attn2(self.norm2(x), context, edit, acc)
        return x + self.ff(self.norm3(x))


class Transformer2DModel(nn.Module):
    """GN -> proj_in -> transformer blocks -> proj_out + residual on NCHW
    tensors (diffusers Transformer2DModel).  SD-1.x projects with 1x1
    convs before the reshape to tokens; SD-2.x (`use_linear_projection`)
    reshapes to tokens first and projects with Linear layers."""

    def __init__(self, channels: int, heads: int, cross_attention_dim: int,
                 num_layers: int = 1, groups: int = 32, use_linear_projection: bool = False):
        super().__init__()
        self.use_linear_projection = use_linear_projection
        self.norm = nn.GroupNorm(groups, channels, eps=1e-6)
        proj = (lambda: nn.Linear(channels, channels)) if use_linear_projection else \
            (lambda: nn.Conv2d(channels, channels, 1))
        self.proj_in = proj()
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(channels, heads, cross_attention_dim) for _ in range(num_layers)])
        self.proj_out = proj()

    def forward(self, x, context, edit: Optional[EditState] = None, acc=None):
        b, c, h, w = x.shape
        y = self.norm(x)
        if self.use_linear_projection:
            y = self.proj_in(y.permute(0, 2, 3, 1).reshape(b, h * w, c))
        else:
            y = self.proj_in(y).permute(0, 2, 3, 1).reshape(b, h * w, c)
        for block in self.transformer_blocks:
            y = block(y, context, edit, acc)
        if self.use_linear_projection:
            return self.proj_out(y).reshape(b, h, w, c).permute(0, 3, 1, 2) + x
        return self.proj_out(y.reshape(b, h, w, c).permute(0, 3, 1, 2)) + x
