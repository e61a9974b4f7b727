"""Fused removal-correlation loss: CUDA kernels and their plain versions.

Counterpart of `geodiffuser_tpu/kernels/removal_corr.py`; the kernels are
`csrc/removal_corr.cu`.  For each budgeted inpaint row i of the edit stream,

    corr[h, i, j] = sum_k softmax(qe ke^T s)[i, k] * softmax(qb kb^T s)[j, k]
    p_in, j_in = max/argmax_j corr over inpaint columns  (MASKED elsewhere)
    p_bg, j_bg = max/argmax_j corr over background columns

with probabilities rounded to bf16 and sums in float32, ties to the lowest
j, and rows whose row_mask is 0 returning NEG_INF with index 0.  The
backward is the sparse analytic VJP: only the two argmax base rows per
inpaint row carry gradient, and qb, kb and the masks get none.  The
forward also returns the natural-log LSEs of the edit rows (H, K) and the
base rows (H, L); the autograd Function saves them, and the backward
takes each row's probabilities as exp(s - lse), with lse_b gathered at
the argmax rows, instead of computing any LSE again.
"""

from __future__ import annotations

import torch

from geodiffuser_tpu_torch.kernels import _build
from geodiffuser_tpu_torch.kernels.flash_attention import _tma_ready, _unpad

NEG_INF = -1e30
MASKED = -1e9

# launches of each wrapper's kernels, and of each wrapper per shape
# (name, H, K, L, Lk, D) (chip_smoke.py reads and resets both)
LAUNCHES = {"corr_fwd": 0, "corr_bwd": 0}
SHAPES: dict = {}

SMS = 132          # streaming multiprocessors of the H100 SXM
TILE = 64          # rows of one operand tile (one wgmma warpgroup's M)
KEY_SPLIT = 8      # most key tiles of one block of a split key sweep


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _probs(q, k, scale):
    """softmax(q k^T * scale) in float32, rounded to bf16 (the XLA loss
    path's materialization cast)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    return torch.softmax(s, dim=-1).to(torch.bfloat16)


def corr_lse_plain(q, k, scale):
    """Natural-log LSE of q k^T * scale per row of q, float32 (H, R)."""
    return torch.logsumexp(torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale, dim=-1)


def corr_fwd_plain(qe, ke, qb, kb, inpaint, background, row_mask, scale):
    """Plain forward (materializes both maps and corr):
    (p_in, p_bg, j_in, j_bg, lse_e, lse_b), the LSEs (H, K) and (H, L) for
    the backward."""
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
            torch.where(dead, zero, j_in), torch.where(dead, zero, j_bg),
            corr_lse_plain(qe, ke, scale), corr_lse_plain(qb, kb, scale))


def _gather_rows(qb, j):
    return torch.gather(qb, 1, j.long()[..., None].expand(-1, -1, qb.shape[-1]))


def corr_bwd_plain(qe, ke, qb, kb, j_in, j_bg, g_in, g_bg, row_mask, lse_e, lse_b, scale):
    """Plain sparse backward from the argmax base rows j_in, j_bg (H, K),
    cotangents g_in, g_bg (already zeroed where the max was mask-excluded)
    and the forward's LSEs: pe = exp(s_e - lse_e), and the two base rows'
    probabilities exp(s - lse_b[j]) rounded to bf16.  Dead rows get no
    gradient.  Returns (d_qe, d_ke) in the input types."""
    def probs(q, k, lse):
        return torch.exp(torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
                         - lse[..., None])

    lse_of = lambda j: torch.gather(lse_b, 1, j.long())
    d_pe = (g_in[..., None] * probs(_gather_rows(qb, j_in), kb, lse_of(j_in)).to(torch.bfloat16).float()
            + g_bg[..., None] * probs(_gather_rows(qb, j_bg), kb, lse_of(j_bg)).to(torch.bfloat16).float())
    pe = probs(qe, ke, lse_e)
    live = row_mask[None, :, None] > 0.5
    t = torch.where(live, pe * (d_pe - torch.sum(d_pe * pe, dim=-1, keepdim=True)), 0.0)
    d_qe = torch.matmul(t, ke.float()).to(qe.dtype) * scale
    d_ke = torch.matmul(t.transpose(-1, -2), qe.float()).to(ke.dtype) * scale
    return d_qe, d_ke


# ---------------------------------------------------------------------------
# Launch plan of the bf16 kernels
# ---------------------------------------------------------------------------

def _tiles(n: int, per: int) -> int:
    return -(-n // per)


def corr_plan(h: int, k_rows: int, l: int, lk: int, d: int) -> dict:
    """What the wrapper hands the bf16 kernels for qe (H, K, D), ke/kb
    (H, Lk, D), qb (H, L, D), from which `csrc/removal_corr.cu` works out
    every grid: the head width padded to a multiple of 8 (16-byte TMA rows),
    the keys padded to whole 64-key tiles (the row of the P_e scratch, whose
    shape is `pe_shape`), the number of key splits of the edit-row and
    backward sweeps (each split takes ceil(tiles / splits) tiles, at most
    KEY_SPLIT), and the correlation kernel's warpgroups of 64 base rows a
    block: two (each loaded P_e tile then feeds 128 rows) where that still
    gives a block per SM, else one."""
    nt = _tiles(lk, TILE)
    return dict(d_pad=-(-d // 8) * 8, lk_pad=nt * TILE, splits=_tiles(nt, KEY_SPLIT),
                warpgroups=2 if h * _tiles(l, 2 * TILE) >= SMS else 1,
                pe_shape=(h, k_rows, nt * TILE))


def _count(name: str, h: int, k_rows: int, l: int, lk: int, d: int) -> None:
    LAUNCHES[name] += 1
    key = (name, h, k_rows, l, lk, d)
    SHAPES[key] = SHAPES.get(key, 0) + 1


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
        raise ValueError(f"head dim {d} outside 1..80: the removal loss runs at the two largest "
                         "UNet levels only, whose heads are 40 and 80 wide at every image size")


def corr_fwd_cuda(qe, ke, qb, kb, inpaint, background, row_mask, scale):
    """Forward kernels on contiguous CUDA tensors ->
    (p_in, p_bg, j_in, j_bg, lse_e, lse_b); lse_e is 0 on dead 64-row
    chunks, and lse_b is not written when no row is live."""
    _check(qe, ke, qb, kb)
    h, k_rows, d = qe.shape
    l, lk = qb.shape[1], ke.shape[1]
    masks = [m.float().contiguous() for m in (inpaint, background, row_mask)]
    _build.require_cuda(qe, *masks)
    if masks[0].shape != (l,) or masks[1].shape != (l,) or masks[2].shape != (k_rows,):
        raise ValueError("inpaint/background must be (L,) and row_mask (K,)")
    lib = _build.lib()
    f32 = dict(dtype=torch.float32, device=qe.device)
    lse_e = torch.empty((h, k_rows), **f32)
    lse_b = torch.empty((h, l), **f32)
    p_in, p_bg = torch.empty((h, k_rows), **f32), torch.empty((h, k_rows), **f32)
    j_in = torch.empty((h, k_rows), dtype=torch.int32, device=qe.device)
    j_bg = torch.empty_like(j_in)
    outs = [x.data_ptr() for x in (lse_e, lse_b, p_in, p_bg, j_in, j_bg)]
    if qe.dtype == torch.bfloat16:
        plan = corr_plan(h, k_rows, l, lk, d)
        qe, ke, qb, kb = (_tma_ready(x, plan["d_pad"]) for x in (qe, ke, qb, kb))
        pe = torch.empty(plan["pe_shape"], dtype=torch.bfloat16, device=qe.device)
        part = torch.empty((h, k_rows, plan["splits"], 2), **f32)
        keys = torch.zeros((h, k_rows, 2), dtype=torch.int64, device=qe.device)
        err = lib.gd_corr_fwd_bf16(
            qe.data_ptr(), ke.data_ptr(), qb.data_ptr(), kb.data_ptr(), pe.data_ptr(),
            part.data_ptr(), keys.data_ptr(), *(m.data_ptr() for m in masks), *outs,
            h, k_rows, l, lk, plan["d_pad"], plan["lk_pad"], plan["splits"],
            plan["warpgroups"], float(scale), _build.stream_ptr(qe))
        _build.check(err, "gd_corr_fwd_bf16")
    else:
        spans = lib.gd_corr_spans(l)
        part_val = torch.empty((h, k_rows, spans, 2), **f32)
        part_idx = torch.empty((h, k_rows, spans, 2), dtype=torch.int32, device=qe.device)
        err = lib.gd_corr_fwd(
            qe.data_ptr(), ke.data_ptr(), qb.data_ptr(), kb.data_ptr(),
            *(m.data_ptr() for m in masks), outs[0], outs[1],
            part_val.data_ptr(), part_idx.data_ptr(), *outs[2:],
            h, k_rows, l, lk, d, float(scale), _build.dtype_code(qe), _build.stream_ptr(qe))
        _build.check(err, "gd_corr_fwd")
    _count("corr_fwd", h, k_rows, l, lk, d)
    return p_in, p_bg, j_in, j_bg, lse_e, lse_b


def corr_bwd_cuda(qe, ke, qb, kb, j_in, j_bg, g_in, g_bg, row_mask, lse_e, lse_b, scale,
                  need_dke: bool = True):
    """Backward kernels on contiguous CUDA tensors -> (d_qe, d_ke), d_ke None
    when not `need_dke`.  bf16 takes the forward's LSEs (lse_b gathered at
    j_in and j_bg here) and computes none; float32 recomputes them."""
    _check(qe, ke, qb, kb)
    h, k_rows, d = qe.shape
    l, lk = qb.shape[1], ke.shape[1]
    g_in, g_bg, row_mask = (x.float().contiguous() for x in (g_in, g_bg, row_mask))
    _build.require_cuda(qe, g_in, g_bg, row_mask, lse_e, lse_b, j_in, j_bg)
    if g_in.shape != (h, k_rows) or g_bg.shape != (h, k_rows) or row_mask.shape != (k_rows,) \
            or j_in.shape != (h, k_rows) or j_bg.shape != (h, k_rows) \
            or lse_e.shape != (h, k_rows) or lse_b.shape != (h, l):
        raise ValueError("g_in/g_bg/j_in/j_bg/lse_e must be (H, K), lse_b (H, L), row_mask (K,)")
    q_in = _gather_rows(qb, j_in).contiguous()
    q_bg = _gather_rows(qb, j_bg).contiguous()
    f32 = dict(dtype=torch.float32, device=qe.device)
    lib = _build.lib()
    if qe.dtype == torch.bfloat16:
        plan = corr_plan(h, k_rows, l, lk, d)
        d8, splits = plan["d_pad"], plan["splits"]
        lse_in = torch.gather(lse_b, 1, j_in.long())
        lse_bg = torch.gather(lse_b, 1, j_bg.long())
        qe, ke, kb, q_in, q_bg = (_tma_ready(x, d8) for x in (qe, ke, kb, q_in, q_bg))
        c_part = torch.empty((h, k_rows, splits), **f32)
        a_part = torch.empty((splits, h, k_rows, d8), **f32)
        b_part = torch.empty_like(a_part)
        c_rows = torch.empty((h, k_rows), **f32)
        d_qe = torch.empty((h, k_rows, d8), **f32)
        d_ke = torch.empty((h, lk, d8), **f32) if need_dke else None
        err = lib.gd_corr_bwd_bf16(
            qe.data_ptr(), ke.data_ptr(), kb.data_ptr(), q_in.data_ptr(), q_bg.data_ptr(),
            g_in.data_ptr(), g_bg.data_ptr(), row_mask.data_ptr(), lse_e.data_ptr(),
            lse_in.data_ptr(), lse_bg.data_ptr(), c_part.data_ptr(), a_part.data_ptr(),
            b_part.data_ptr(), c_rows.data_ptr(), d_qe.data_ptr(),
            None if d_ke is None else d_ke.data_ptr(),
            h, k_rows, lk, d8, splits, float(scale), _build.stream_ptr(qe))
        _build.check(err, "gd_corr_bwd_bf16")
        d_qe = _unpad(d_qe, d)
        d_ke = None if d_ke is None else _unpad(d_ke, d)
    else:
        scratch = torch.empty((4, h, k_rows), **f32)
        d_qe = torch.empty((h, k_rows, d), **f32)
        d_ke = torch.empty((h, lk, d), **f32)
        err = lib.gd_corr_bwd(
            qe.data_ptr(), ke.data_ptr(), kb.data_ptr(), q_in.data_ptr(), q_bg.data_ptr(),
            g_in.data_ptr(), g_bg.data_ptr(), row_mask.data_ptr(), scratch.data_ptr(),
            d_qe.data_ptr(), d_ke.data_ptr(),
            h, k_rows, lk, d, float(scale), _build.dtype_code(qe), _build.stream_ptr(qe))
        _build.check(err, "gd_corr_bwd")
        d_ke = d_ke if need_dke else None
    _count("corr_bwd", h, k_rows, l, lk, d)
    return d_qe.to(qe.dtype), None if d_ke is None else d_ke.to(ke.dtype)


class RemovalCorrelation(torch.autograd.Function):
    """Differentiable in (qe, ke); kernels for CUDA tensors, plain versions
    for CPU tensors.  The forward's LSEs are saved for the backward."""

    @staticmethod
    def forward(ctx, qe, ke, qb, kb, inpaint, background, row_mask, scale):
        fwd = corr_fwd_cuda if qe.is_cuda else corr_fwd_plain
        p_in, p_bg, j_in, j_bg, lse_e, lse_b = fwd(qe, ke, qb, kb, inpaint, background,
                                                   row_mask, scale)
        ctx.save_for_backward(qe, ke, qb, kb, row_mask, p_in, p_bg, j_in, j_bg, lse_e, lse_b)
        ctx.scale = scale
        ctx.mark_non_differentiable(j_in, j_bg)
        return p_in, p_bg, j_in, j_bg

    @staticmethod
    def backward(ctx, g_in, g_bg, _gj_in, _gj_bg):
        qe, ke, qb, kb, row_mask, p_in, p_bg, j_in, j_bg, lse_e, lse_b = ctx.saved_tensors
        zero = torch.zeros((), dtype=torch.float32, device=qe.device)
        g_in = zero if g_in is None else g_in
        g_bg = zero if g_bg is None else g_bg
        # mask-excluded maxima (and dead rows) carry no gradient
        g_in = torch.where(p_in > MASKED * 0.5, g_in, zero).float()
        g_bg = torch.where(p_bg > MASKED * 0.5, g_bg, zero).float()
        args = (qe, ke, qb, kb, j_in, j_bg, g_in, g_bg, row_mask, lse_e, lse_b, ctx.scale)
        # the remover passes its detached base keys as ke
        need_dke = ctx.needs_input_grad[1]
        if qe.is_cuda:
            d_qe, d_ke = corr_bwd_cuda(*args, need_dke=need_dke)
        else:
            d_qe, d_ke = corr_bwd_plain(*args)
        return d_qe, d_ke if need_dke else None, None, None, None, None, None, None


def removal_correlation(qe, ke, qb, kb, inpaint, background, row_mask, scale: float):
    """Fused removal-loss correlation maxima (p_in, p_bg, j_in, j_bg), each
    (H, K).  qe (H, K, D) edit queries at the inpaint-row budget, ke/kb
    (H, Lk, D), qb (H, L, D), inpaint/background (L,), row_mask (K,)."""
    if row_mask is None:
        row_mask = torch.ones(qe.shape[1], dtype=torch.float32, device=qe.device)
    if qe.is_cuda:
        qe, ke, qb, kb = (x.contiguous() for x in (qe, ke, qb, kb))
    return RemovalCorrelation.apply(qe, ke, qb, kb, inpaint, background, row_mask, float(scale))
