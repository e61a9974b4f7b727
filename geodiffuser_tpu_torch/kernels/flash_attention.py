"""Flash attention, forward and backward: CUDA kernels and their plain
versions.

Counterpart of `geodiffuser_tpu/kernels/flash_attention.py`; the kernels are
`csrc/flash_attention.cu`.  `flash_attention` launches them for CUDA tensors
and takes the plain version only for CPU tensors.  Operands are
(..., L, D) with any leading batch dims and D at its native width.
"""

from __future__ import annotations

import math

import torch

from geodiffuser_tpu_torch.kernels import _build

# launches of each wrapper's kernel (chip_smoke.py reads and resets them)
LAUNCHES = {"flash_fwd": 0, "flash_bwd": 0}


def use_flash(lq: int, lk: int) -> bool:
    """Flash pays off when the key sequence is large (self-attention at
    >= 32^2); cross attention (Lk=77) has no L^2 term to save.  Rectangular
    maps (the warped-row blend) qualify whenever both axes tile."""
    return lk >= 1024 and lk % 256 == 0 and lq >= 256 and lq % 256 == 0


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def attention_plain(q, k, v, scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v with float32 logits and softmax, the
    probabilities cast to v's type before the product (the JAX package's
    vanilla_attention).  Differentiable by autograd."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(probs.float(), v.float()).to(v.dtype)


def flash_fwd_plain(q, k, v, scale: float):
    """Plain counterpart of the forward kernel on (B, L, D) operands:
    returns (o, lse) with lse the natural-log row LSE in float32 (B, Lq)."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    lse = torch.logsumexp(logits, dim=-1)
    p = torch.exp(logits - lse[..., None])
    o = torch.matmul(p.to(v.dtype).float(), v.float()).to(q.dtype)
    return o, lse


def flash_bwd_plain(q, k, v, o, lse, do, scale: float):
    """Plain counterpart of the backward kernels on (B, L, D) operands:
    from the saved LSE and delta = rowsum(dO * O),
    dq = scale * (P (dP - delta)) K, dk = scale * (P (dP - delta))^T Q,
    dv = P^T dO, with P and dS cast to the input type before their product."""
    f = torch.float32
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    p = torch.exp(torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale - lse[..., None])
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = (p * (dp - delta)).to(q.dtype).to(f)
    dq = (torch.matmul(ds, k.float()) * scale).to(q.dtype)
    dk = (torch.matmul(ds.transpose(-1, -2), q.float()) * scale).to(k.dtype)
    dv = torch.matmul(p.to(do.dtype).to(f).transpose(-1, -2), do.float()).to(v.dtype)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check(q, k, v):
    _build.require_cuda(q, k, v)
    if q.dtype != k.dtype or q.dtype != v.dtype:
        raise TypeError("q, k, v must share one dtype")
    if q.dim() != 3 or k.shape != v.shape or q.shape[0] != k.shape[0] or q.shape[2] != k.shape[2]:
        raise ValueError(f"bad shapes q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)}")
    if not 1 <= q.shape[2] <= 80:
        raise ValueError(f"head dim {q.shape[2]} outside 1..80")


def flash_fwd_cuda(q, k, v, scale: float):
    """Forward kernel on contiguous (B, L, D) CUDA tensors -> (o, lse)."""
    _check(q, k, v)
    b, lq, d = q.shape
    lk = k.shape[1]
    o = torch.empty_like(q)
    lse = torch.empty((b, lq), dtype=torch.float32, device=q.device)
    err = _build.lib().gd_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        b, lq, lk, d, float(scale), _build.dtype_code(q), _build.stream_ptr(q))
    _build.check(err, "gd_flash_fwd")
    LAUNCHES["flash_fwd"] += 1
    return o, lse


def flash_bwd_cuda(q, k, v, o, lse, do, scale: float):
    """Backward kernels on contiguous (B, L, D) CUDA tensors -> (dq, dk, dv)."""
    _check(q, k, v)
    _build.require_cuda(q, o, lse, do)
    b, lq, d = q.shape
    lk = k.shape[1]
    if o.shape != q.shape or do.shape != q.shape or lse.shape != (b, lq) \
            or lse.dtype != torch.float32 or do.dtype != q.dtype or o.dtype != q.dtype:
        raise ValueError("o, dO must match q and lse must be float32 (B, Lq)")
    delta = torch.empty((b, lq), dtype=torch.float32, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    err = _build.lib().gd_flash_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, lq, lk, d, float(scale), _build.dtype_code(q), _build.stream_ptr(q))
    _build.check(err, "gd_flash_bwd")
    LAUNCHES["flash_bwd"] += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Kernel forward with the kernel backward (no L x L map in either pass)."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        o, lse = flash_fwd_cuda(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd_cuda(q, k, v, o, lse, do.contiguous(), ctx.scale)
        return dq, dk, dv, None


def flash_attention(q, k, v, scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v without materializing the map on the card.

    CUDA tensors go through the kernels (differentiable: the backward is a
    kernel too); CPU tensors through `attention_plain`."""
    if not q.is_cuda:
        return attention_plain(q, k, v, scale)
    lead = q.shape[:-2]
    b = math.prod(lead)
    flat = lambda x: x.reshape((b,) + tuple(x.shape[-2:])).contiguous()
    o = FlashAttention.apply(flat(q), flat(k), flat(v), float(scale))
    return o.reshape(q.shape)
