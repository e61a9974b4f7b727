"""Removal-correlation maxima and their backward: a frozen copy of the
port's plain versions (`geodiffuser_tpu_torch/kernels/removal_corr.py`) in
float32 throughout.  For each budgeted inpaint row i of the edit stream,

    corr[h, i, j] = sum_k softmax(qe ke^T s)[i, k] * softmax(qb kb^T s)[j, k]
    p_in, j_in = max/argmax_j corr over inpaint columns  (MASKED elsewhere)
    p_bg, j_bg = max/argmax_j corr over background columns

ties to the lowest j, rows whose row_mask is 0 returning NEG_INF with index
0.  The port rounds the probabilities to bf16; the reference keeps them in
float32.  A group of E edits has E * heads heads, edit-major, and masks
with the edit axis.  `RECORD`, when a list, receives each forward's
(p_in, p_bg).
"""

from __future__ import annotations

import torch

NEG_INF = -1e30
MASKED = -1e9
RECORD = None


def edit_masks(h: int, inpaint, background, row_mask):
    """The masks with their edit axis, (E, L), (E, L), (E, K), and the heads
    of each edit, H / E; (L,) and (K,) masks are one edit's."""
    inpaint, background, row_mask = (m if m.dim() == 2 else m[None]
                                     for m in (inpaint, background, row_mask))
    e = inpaint.shape[0]
    if background.shape[0] != e or row_mask.shape[0] != e or h % e:
        raise ValueError(f"masks of {inpaint.shape[0]}, {background.shape[0]} and "
                         f"{row_mask.shape[0]} edits for {h} heads")
    return inpaint, background, row_mask, h // e


def _per_head(m, hpe: int):
    """A per-edit mask (E, N) as per head (E * hpe, N)."""
    return m.repeat_interleave(hpe, dim=0)

def _probs(q, k, scale):
    """softmax(q k^T * scale) in float32."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    return torch.softmax(s, dim=-1)


def corr_lse_plain(q, k, scale):
    """Natural-log LSE of q k^T * scale per row of q, float32 (H, R)."""
    return torch.logsumexp(torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale, dim=-1)


def corr_fwd_plain(qe, ke, qb, kb, inpaint, background, row_mask, scale):
    """Plain forward (materializes both maps and corr):
    (p_in, p_bg, j_in, j_bg, lse_e, lse_b), the LSEs (H, K) and (H, L) for
    the backward."""
    inpaint, background, row_mask, hpe = edit_masks(qe.shape[0], inpaint, background, row_mask)
    inpaint, background, row_mask = (_per_head(m, hpe) for m in (inpaint, background, row_mask))
    pe = _probs(qe, ke, scale).float()
    pb = _probs(qb, kb, scale).float()
    corr = torch.matmul(pe, pb.transpose(-1, -2))
    masked = torch.tensor(MASKED, dtype=torch.float32, device=corr.device)
    c_in = torch.where(inpaint[:, None, :] > 0.5, corr, masked)
    c_bg = torch.where(background[:, None, :] > 0.5, corr, masked)
    # torch.max returns the first maximal index, as jnp.argmax
    p_in, j_in = torch.max(c_in, dim=-1)
    p_bg, j_bg = torch.max(c_bg, dim=-1)
    j_in, j_bg = j_in.int(), j_bg.int()
    dead = row_mask < 0.5
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
    probabilities exp(s - lse_b[j]).  Dead rows get no
    gradient.  Returns (d_qe, d_ke) in the input types."""
    def probs(q, k, lse):
        return torch.exp(torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
                         - lse[..., None])

    lse_of = lambda j: torch.gather(lse_b, 1, j.long())
    d_pe = (g_in[..., None] * probs(_gather_rows(qb, j_in), kb, lse_of(j_in))
            + g_bg[..., None] * probs(_gather_rows(qb, j_bg), kb, lse_of(j_bg)))
    pe = probs(qe, ke, lse_e)
    _, _, row_mask, hpe = edit_masks(qe.shape[0], row_mask, row_mask, row_mask)
    live = _per_head(row_mask, hpe)[..., None] > 0.5
    t = torch.where(live, pe * (d_pe - torch.sum(d_pe * pe, dim=-1, keepdim=True)), 0.0)
    d_qe = torch.matmul(t, ke.float()).to(qe.dtype) * scale
    d_ke = torch.matmul(t.transpose(-1, -2), qe.float()).to(ke.dtype) * scale
    return d_qe, d_ke


class RemovalCorrelation(torch.autograd.Function):
    """Differentiable in (qe, ke).  The forward's LSEs are saved for the
    backward."""

    @staticmethod
    def forward(ctx, qe, ke, qb, kb, inpaint, background, row_mask, scale):
        p_in, p_bg, j_in, j_bg, lse_e, lse_b = corr_fwd_plain(qe, ke, qb, kb, inpaint, background,
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
        d_qe, d_ke = corr_bwd_plain(*args)
        return d_qe, d_ke if need_dke else None, None, None, None, None, None, None


def removal_correlation(qe, ke, qb, kb, inpaint, background, row_mask, scale: float):
    """Fused removal-loss correlation maxima (p_in, p_bg, j_in, j_bg), each
    (H, K).  qe (H, K, D) edit queries at the inpaint-row budget, ke/kb
    (H, Lk, D), qb (H, L, D), inpaint/background (L,), row_mask (K,); for a
    group of E edits, H = E * heads (edit-major), inpaint/background (E, L)
    and row_mask (E, K)."""
    if row_mask is None:
        row_mask = torch.ones(inpaint.shape[:-1] + (qe.shape[1],), dtype=torch.float32,
                              device=qe.device)
    out = RemovalCorrelation.apply(qe, ke, qb, kb, inpaint, background, row_mask, float(scale))
    if RECORD is not None:
        RECORD.append((out[0].detach(), out[1].detach()))
    return out
