"""Fused removal-correlation loss: CUDA kernels and their plain versions.

Counterpart of `geodiffuser_tpu/kernels/removal_corr.py`; the kernels are
`csrc/removal_corr.cu`.  For each budgeted inpaint row i of the edit stream,

    corr[h, i, j] = sum_k softmax(qe ke^T s)[i, k] * softmax(qb kb^T s)[j, k]
    p_in, j_in = max/argmax_j corr over inpaint columns  (MASKED elsewhere)
    p_bg, j_bg = max/argmax_j corr over background columns

with probabilities rounded to bf16 and sums in float32, ties to the lowest
j, and rows whose row_mask is 0 returning NEG_INF with index 0.  The
backward is the sparse analytic VJP: only the two argmax base rows per
inpaint row carry gradient, and qb, kb and the masks get none.
"""

from __future__ import annotations

import torch

from geodiffuser_tpu_torch.kernels import _build

NEG_INF = -1e30
MASKED = -1e9

LAUNCHES = {"corr_fwd": 0, "corr_bwd": 0}


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _probs(q, k, scale):
    """softmax(q k^T * scale) in float32, rounded to bf16 (the XLA loss
    path's materialization cast)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    return torch.softmax(s, dim=-1).to(torch.bfloat16)


def corr_fwd_plain(qe, ke, qb, kb, inpaint, background, row_mask, scale):
    """Plain forward (materializes both maps and corr): (p_in, p_bg, j_in, j_bg)."""
    pe = _probs(qe, ke, scale).float()
    pb = _probs(qb, kb, scale).float()
    corr = torch.matmul(pe, pb.transpose(-1, -2))
    masked = torch.tensor(MASKED, dtype=torch.float32, device=corr.device)
    c_in = torch.where(inpaint[None, None, :] > 0.5, corr, masked)
    c_bg = torch.where(background[None, None, :] > 0.5, corr, masked)
    # torch.max returns the first maximal index, as jnp.argmax
    p_in, j_in = torch.max(c_in, dim=-1)
    p_bg, j_bg = torch.max(c_bg, dim=-1)
    j_in, j_bg = j_in.int(), j_bg.int()
    dead = row_mask[None, :] < 0.5
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=corr.device)
    zero = torch.zeros((), dtype=torch.int32, device=corr.device)
    return (torch.where(dead, neg, p_in), torch.where(dead, neg, p_bg),
            torch.where(dead, zero, j_in), torch.where(dead, zero, j_bg))


def _gather_rows(qb, j):
    return torch.gather(qb, 1, j.long()[..., None].expand(-1, -1, qb.shape[-1]))


def corr_bwd_plain(qe, ke, kb, q_in, q_bg, g_in, g_bg, scale):
    """Plain sparse backward from the gathered argmax base rows q_in, q_bg
    (H, K, D) and cotangents g_in, g_bg (already zeroed where the max was
    mask-excluded): returns (d_qe, d_ke) in the input types."""
    d_pe = (g_in[..., None] * _probs(q_in, kb, scale).float()
            + g_bg[..., None] * _probs(q_bg, kb, scale).float())
    s = torch.matmul(qe.float(), ke.float().transpose(-1, -2)) * scale
    pe = torch.softmax(s, dim=-1)
    t = pe * (d_pe - torch.sum(d_pe * pe, dim=-1, keepdim=True))
    d_qe = torch.matmul(t, ke.float()).to(qe.dtype) * scale
    d_ke = torch.matmul(t.transpose(-1, -2), qe.float()).to(ke.dtype) * scale
    return d_qe, d_ke


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check(qe, ke, qb, kb):
    _build.require_cuda(qe, ke, qb, kb)
    if len({t.dtype for t in (qe, ke, qb, kb)}) != 1:
        raise TypeError("qe, ke, qb, kb must share one dtype")
    h, _, d = qe.shape
    if ke.shape != kb.shape or ke.shape[0] != h or qb.shape[0] != h \
            or ke.shape[2] != d or qb.shape[2] != d:
        raise ValueError("bad shapes: qe (H,K,D), ke/kb (H,Lk,D), qb (H,L,D)")
    if not 1 <= d <= 80:
        raise ValueError(f"head dim {d} outside 1..80")


def corr_fwd_cuda(qe, ke, qb, kb, inpaint, background, row_mask, scale):
    """Forward kernels on contiguous CUDA tensors -> (p_in, p_bg, j_in, j_bg)."""
    _check(qe, ke, qb, kb)
    h, k_rows, d = qe.shape
    l, lk = qb.shape[1], ke.shape[1]
    masks = [m.float().contiguous() for m in (inpaint, background, row_mask)]
    _build.require_cuda(qe, *masks)
    if masks[0].shape != (l,) or masks[1].shape != (l,) or masks[2].shape != (k_rows,):
        raise ValueError("inpaint/background must be (L,) and row_mask (K,)")
    lib = _build.lib()
    spans = lib.gd_corr_spans(l)
    f32 = dict(dtype=torch.float32, device=qe.device)
    lse_e = torch.empty((h, k_rows), **f32)
    lse_b = torch.empty((h, l), **f32)
    part_val = torch.empty((h, k_rows, spans, 2), **f32)
    part_idx = torch.empty((h, k_rows, spans, 2), dtype=torch.int32, device=qe.device)
    p_in, p_bg = torch.empty((h, k_rows), **f32), torch.empty((h, k_rows), **f32)
    j_in = torch.empty((h, k_rows), dtype=torch.int32, device=qe.device)
    j_bg = torch.empty_like(j_in)
    err = lib.gd_corr_fwd(
        qe.data_ptr(), ke.data_ptr(), qb.data_ptr(), kb.data_ptr(),
        masks[0].data_ptr(), masks[1].data_ptr(), masks[2].data_ptr(),
        lse_e.data_ptr(), lse_b.data_ptr(), part_val.data_ptr(), part_idx.data_ptr(),
        p_in.data_ptr(), p_bg.data_ptr(), j_in.data_ptr(), j_bg.data_ptr(),
        h, k_rows, l, lk, d, float(scale), _build.dtype_code(qe), _build.stream_ptr(qe))
    _build.check(err, "gd_corr_fwd")
    LAUNCHES["corr_fwd"] += 1
    return p_in, p_bg, j_in, j_bg


def corr_bwd_cuda(qe, ke, kb, q_in, q_bg, g_in, g_bg, row_mask, scale):
    """Backward kernels on contiguous CUDA tensors -> (d_qe, d_ke)."""
    _check(qe, ke, q_in, kb)
    _check(qe, ke, q_bg, kb)
    h, k_rows, d = qe.shape
    lk = ke.shape[1]
    g_in, g_bg, row_mask = (x.float().contiguous() for x in (g_in, g_bg, row_mask))
    _build.require_cuda(qe, g_in, g_bg, row_mask)
    if q_in.shape != qe.shape or q_bg.shape != qe.shape or g_in.shape != (h, k_rows) \
            or g_bg.shape != (h, k_rows) or row_mask.shape != (k_rows,):
        raise ValueError("q_in/q_bg must match qe, g_in/g_bg be (H, K), row_mask (K,)")
    f32 = dict(dtype=torch.float32, device=qe.device)
    scratch = torch.empty((4, h, k_rows), **f32)
    d_qe = torch.empty((h, k_rows, d), **f32)
    d_ke = torch.empty((h, lk, d), **f32)
    err = _build.lib().gd_corr_bwd(
        qe.data_ptr(), ke.data_ptr(), kb.data_ptr(), q_in.data_ptr(), q_bg.data_ptr(),
        g_in.data_ptr(), g_bg.data_ptr(), row_mask.data_ptr(), scratch.data_ptr(),
        d_qe.data_ptr(), d_ke.data_ptr(),
        h, k_rows, lk, d, float(scale), _build.dtype_code(qe), _build.stream_ptr(qe))
    _build.check(err, "gd_corr_bwd")
    LAUNCHES["corr_bwd"] += 1
    return d_qe.to(qe.dtype), d_ke.to(ke.dtype)


class RemovalCorrelation(torch.autograd.Function):
    """Differentiable in (qe, ke); kernels for CUDA tensors, plain versions
    for CPU tensors."""

    @staticmethod
    def forward(ctx, qe, ke, qb, kb, inpaint, background, row_mask, scale):
        if qe.is_cuda:
            out = corr_fwd_cuda(qe, ke, qb, kb, inpaint, background, row_mask, scale)
        else:
            out = corr_fwd_plain(qe, ke, qb, kb, inpaint, background, row_mask, scale)
        p_in, p_bg, j_in, j_bg = out
        ctx.save_for_backward(qe, ke, qb, kb, row_mask, p_in, p_bg, j_in, j_bg)
        ctx.scale = scale
        ctx.mark_non_differentiable(j_in, j_bg)
        return out

    @staticmethod
    def backward(ctx, g_in, g_bg, _gj_in, _gj_bg):
        qe, ke, qb, kb, row_mask, p_in, p_bg, j_in, j_bg = ctx.saved_tensors
        zero = torch.zeros((), dtype=torch.float32, device=qe.device)
        g_in = zero if g_in is None else g_in
        g_bg = zero if g_bg is None else g_bg
        # mask-excluded maxima (and dead rows) carry no gradient
        g_in = torch.where(p_in > MASKED * 0.5, g_in, zero).float()
        g_bg = torch.where(p_bg > MASKED * 0.5, g_bg, zero).float()
        q_in = _gather_rows(qb, j_in)
        q_bg = _gather_rows(qb, j_bg)
        if qe.is_cuda:
            d_qe, d_ke = corr_bwd_cuda(qe, ke, kb, q_in, q_bg, g_in, g_bg, row_mask, ctx.scale)
        else:
            d_qe, d_ke = corr_bwd_plain(qe, ke, kb, q_in, q_bg, g_in, g_bg, ctx.scale)
        # the remover passes its detached base keys as ke
        d_ke = d_ke if ctx.needs_input_grad[1] else None
        return d_qe, d_ke, None, None, None, None, None, None


def removal_correlation(qe, ke, qb, kb, inpaint, background, row_mask, scale: float):
    """Fused removal-loss correlation maxima (p_in, p_bg, j_in, j_bg), each
    (H, K).  qe (H, K, D) edit queries at the inpaint-row budget, ke/kb
    (H, Lk, D), qb (H, L, D), inpaint/background (L,), row_mask (K,)."""
    if row_mask is None:
        row_mask = torch.ones(qe.shape[1], dtype=torch.float32, device=qe.device)
    if qe.is_cuda:
        qe, ke, qb, kb = (x.contiguous() for x in (qe, ke, qb, kb))
    return RemovalCorrelation.apply(qe, ke, qb, kb, inpaint, background, row_mask, float(scale))
