"""GeoDiffuser shared-attention editing (editor and remover modes) as
functions on tensors.

Counterpart of `geodiffuser_tpu/core/edit_attention.py` (reference
AttentionGeometryEdit, attention_processors.py:384-624,
AttentionGeometryRemover, :748-928, the edit losses :231-305 and the
smoothness TV loss, loss.py:29-40).

q, k, v are (E*S, H, L, D): E edits of a lockstep group, each with its
block of S CFG streams, H heads (`make_edit_state` makes one edit's masks
a group of one).  Every loss is reduced per edit, each edit's streams see
only that edit's masks, rows and taps, and every attention and correlation
call takes the whole group at once.  Logits, softmax and losses are
float32.  Gradient boundaries follow the reference: the base
stream is detached (attention_sharing.py:242), edit_out is detached, only
replace_out carries gradient; `.detach()` stands exactly where the JAX
package has `sg`.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from geodiffuser_tpu_torch.core.edit_state import EditState, MaskSet
from geodiffuser_tpu_torch.kernels import flash_attention as fa
from geodiffuser_tpu_torch.kernels import removal_corr as rc
from geodiffuser_tpu_torch.ops import image as image_ops
from geodiffuser_tpu_torch.ops import splat as splat_ops

LOG_KEYS = ("sim", "movement", "removal", "smoothness", "amodal")


def zero_logs() -> Dict[str, float]:
    logs = {f"{b}/{k}": 0.0 for b in ("self", "cross") for k in LOG_KEYS}
    logs["num_layers"] = 0.0
    return logs


def normalize_logs(logs: Dict[str, float]) -> Dict[str, float]:
    """Per-layer average of the logged loss components (the reference's
    convert_loss_log_to_numpy division by num_layers)."""
    n = max(float(logs.get("num_layers", 0.0)), 1.0)
    return {k: (v / n if k != "num_layers" else v) for k, v in logs.items()}


def attn_probs(q, k, scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) with float32 logits, in float32."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    return torch.softmax(logits * scale, dim=-1)


def attn_out(probs, v) -> torch.Tensor:
    """probs (cast to v's type) @ v, float32 sums, in v's type."""
    return torch.matmul(probs.to(v.dtype).float(), v.float()).to(v.dtype)


def fast_attention(q, k, v, scale: float) -> torch.Tensor:
    """Attention routed through the flash kernel for CUDA tensors when the
    map is large (`use_flash`); plain math otherwise.  Differentiable: the
    kernel's backward is a kernel too."""
    if q.is_cuda and fa.use_flash(q.shape[-2], k.shape[-2]):
        return fa.flash_attention(q, k, v, scale)
    return fa.attention_plain(q, k, v, scale)


# ---------------------------------------------------------------------------
# Per-edit gathers (masks are (E, L) floats, rows (E, K) indices)
# ---------------------------------------------------------------------------

def _rows_of(x, rows):
    """x (E, H, L, D) at each edit's rows (E, K) -> (E, H, K, D).  Indexing,
    not `torch.gather`: gather's backward keeps all of x alive, a whole
    attention map of every constrained self layer."""
    edit = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[edit, :, rows].transpose(1, 2)


def _pos_at(pos, idx):
    """pos (E, L, 2) at each edit's indices idx (E, ...) -> (E, ..., 2)."""
    flat = idx.reshape(idx.shape[0], -1).long()
    out = torch.gather(pos, 1, flat[..., None].expand(-1, -1, 2))
    return out.reshape(*idx.shape, 2)


# ---------------------------------------------------------------------------
# Losses (float32; each returns (E,), one loss per edit)
# ---------------------------------------------------------------------------

def background_preservation_loss(edit_out, replace_out, mask_bg, eps: float = 1e-8):
    """Masked L1 between the detached shared output and the live edit
    output over the background (attention_processors.py:231-246)."""
    diff = torch.abs(edit_out.detach().float() - replace_out.float())
    num = (diff * mask_bg[:, None, :, None]).sum((1, 2, 3))
    _, h, _, d = replace_out.shape
    return num / (mask_bg.sum(-1) * h * d + eps)


def object_placement_loss(edit_out, replace_out, mask_edit, eps: float = 1e-8):
    """Masked L1 inside the warped object mask (attention_processors.py:283-287)."""
    return background_preservation_loss(edit_out, replace_out, mask_edit, eps)


def _removal_per_row_loss(p_in, p_bg, d_bg, row_mask, inpaint_sum, h, eps=1e-4):
    """Distance-weighted log-ratio reduction (attention_processors.py:263-268)
    of (E, H, K) maxima."""
    w = torch.exp(-d_bg).detach()
    per_row = w * (-torch.log(torch.clamp(p_bg, min=0.0) + eps)
                   + torch.log(torch.clamp(p_in, min=0.0) + eps))
    return (per_row * row_mask[:, None, :]).sum((1, 2)) / (inpaint_sum * h + 1e-8)


def _bg_distance(ms: MaskSet, j_bg):
    """Distance from each budgeted inpaint row to its argmax background row
    j_bg (E, H, K)."""
    rows_pos = _pos_at(ms.pos, ms.inpaint_rows)[:, None]
    return torch.sqrt(((rows_pos - _pos_at(ms.pos, j_bg)) ** 2).sum(-1) + 1e-12)


def removal_loss_fused(q_e, k_r, q_b, k_b, ms: MaskSet, scale: float) -> torch.Tensor:
    """Removal correlation loss through the fused kernel (no attention map
    or correlation matrix in device memory; attention_processors.py:248-280
    under the static row budget); one launch for the group, the heads of
    edit e reading edit e's masks."""
    e, h = q_e.shape[:2]
    k = ms.inpaint_rows.shape[1]
    flat = lambda x: x.reshape(e * h, *x.shape[2:])
    p_in, p_bg, _, j_bg = rc.removal_correlation(
        flat(_rows_of(q_e, ms.inpaint_rows)), flat(k_r), flat(q_b.detach()), flat(k_b.detach()),
        ms.inpaint, ms.background, ms.inpaint_row_mask, scale)
    p_in, p_bg, j_bg = (x.reshape(e, h, k) for x in (p_in, p_bg, j_bg))
    return _removal_per_row_loss(p_in, p_bg, _bg_distance(ms, j_bg), ms.inpaint_row_mask,
                                 ms.inpaint.sum(-1), h)


def removal_loss(probs_rows, base_probs, ms: MaskSet) -> torch.Tensor:
    """The removal correlation loss from materialized maps: probs_rows
    (E, H, K, L) are the edit stream's probabilities at the budgeted inpaint
    rows, base_probs (E, H, L, L) the base stream's (attention_processors.py:
    248-280).  Used only with the attention constraints, where the maps
    exist anyway; `removal_loss_fused` otherwise."""
    h = probs_rows.shape[1]
    corr = torch.matmul(probs_rows.float(), base_probs.detach().float().transpose(-1, -2))
    neg = torch.tensor(-1e9, dtype=torch.float32, device=corr.device)
    corr_in = torch.where(ms.inpaint[:, None, None, :] > 0.5, corr, neg)
    corr_bg = torch.where(ms.background[:, None, None, :] > 0.5, corr, neg)
    # amax splits the gradient between tied maxima, as jnp.max does
    p_in = torch.amax(corr_in, dim=-1)
    p_bg = torch.amax(corr_bg, dim=-1)
    j_bg = torch.argmax(corr_bg, dim=-1)
    return _removal_per_row_loss(p_in, p_bg, _bg_distance(ms, j_bg), ms.inpaint_row_mask,
                                 ms.inpaint.sum(-1), h)


def smooth_attention_features(features: torch.Tensor) -> torch.Tensor:
    """5x5 Gaussian blur of per-head feature maps (..., L, D)
    (generic_torch.py:145-154)."""
    *lead, l, d = features.shape
    res = math.isqrt(l)
    maps = features.transpose(-1, -2).reshape(-1, res, res)
    maps = image_ops.gaussian_smooth_2d(maps, size=5)
    return maps.reshape(*lead, d, l).transpose(-1, -2)


def amodal_loss(edit_out, replace_out, ms: MaskSet, eps: float = 1e-8):
    """Fill the amodal ring by nearest-foreground interpolation and pull the
    edit output toward it (attention_processors.py:289-305)."""
    e = edit_out.detach().float()
    n, h, l, d = e.shape
    # each edit's 4 interpolation sources per row: (E, L, 4, H, D)
    rows = e.transpose(1, 2).reshape(n, l, h * d)
    idx = ms.interp_idx.reshape(n, -1)
    feats = torch.gather(rows, 1, idx[..., None].expand(-1, -1, h * d)).reshape(n, l, 4, h, d)
    vals = ms.interp_vals
    interp = ((feats * vals[..., None, None]).sum(2)
              / (vals.sum(-1)[..., None, None] + 1e-12)).transpose(1, 2)
    w = ms.interp_w
    interp = torch.where((ms.mask_new_warped > 0.5)[:, None, :, None], e, interp)
    interp = smooth_attention_features(interp)
    diff = torch.abs(interp.detach() - replace_out.float())
    wm = (w * ms.amodal)[:, None, :, None]
    return (diff * wm).sum((1, 2, 3)) / ((w * ms.amodal).sum(-1) * h * d + eps)


def smoothness_loss(replace_out: torch.Tensor) -> torch.Tensor:
    """Total variation over the spatial grid (loss.py:29-40)."""
    n, h, l, d = replace_out.shape
    res = math.isqrt(l)
    r = replace_out.float().reshape(n, h, res, res, d)
    dh = torch.abs(r[:, :, 1:] - r[:, :, :-1]).mean((1, 2, 3, 4))
    dw = torch.abs(r[:, :, :, 1:] - r[:, :, :, :-1]).mean((1, 2, 3, 4))
    return dh + dw


# ---------------------------------------------------------------------------
# Edit-stream attention
# ---------------------------------------------------------------------------

def _warp_queries(q_base, ms: MaskSet, state: EditState) -> torch.Tensor:
    """q <- q*(1-m) + m*splat(q) inside the warped mask
    (attention_processors.py:423-424, 543-545), through each edit's dense
    warp operator in the model type; fully detached."""
    n, h, l, d = q_base.shape
    res = math.isqrt(l)
    q_img = q_base.transpose(1, 2).reshape(n, res, res, h * d)
    if state.warp_mats is not None and res in state.warp_mats:
        q_warp = splat_ops.apply_warp_matrix(state.warp_mats[res].to(q_img.dtype), q_img)
    else:
        q_warp = torch.stack([
            splat_ops.splat_image(q.float(), tc, radius=state.splat_radius, tau=state.splat_tau,
                                  z_beta=state.z_beta) for q, tc in zip(q_img, ms.t_coords)])
    m = ms.mask_new_warped_2d[..., None]
    out = q_img.float() * (1.0 - m) + m * q_warp.float()
    return out.reshape(n, l, h, d).transpose(1, 2).to(q_base.dtype).detach()


def _warp_queries_rows(q_base, ms: MaskSet, state: EditState, rows) -> torch.Tensor:
    """`_warp_queries` over each edit's static row budget rows (E, K): the
    operator's rows are gathered before the product.  Returns (E, H, K, D),
    detached."""
    n, h, l, d = q_base.shape
    res = math.isqrt(l)
    k = rows.shape[1]
    q_flat = q_base.transpose(1, 2).reshape(n, l, h * d)
    if state.warp_mats is not None and res in state.warp_mats:
        # operands rounded to the model type, float32 result (the JAX
        # package's dot with preferred_element_type=float32)
        w_rows = torch.gather(state.warp_mats[res], 1, rows[..., None].expand(n, k, l))
        q_warp = w_rows.to(q_flat.dtype).float() @ q_flat.float()
    else:
        q_warp = torch.stack([
            splat_ops.splat_image(q.reshape(res, res, h * d).float(), tc,
                                  radius=state.splat_radius, tau=state.splat_tau,
                                  z_beta=state.z_beta).reshape(l, h * d)[r]
            for q, tc, r in zip(q_flat, ms.t_coords, rows)])
    m = torch.gather(ms.mask_new_warped, 1, rows)[..., None]
    q_rows = torch.gather(q_flat, 1, rows[..., None].expand(n, k, h * d))
    out = q_rows.float() * (1.0 - m) + m * q_warp
    return out.reshape(n, k, h, d).transpose(1, 2).to(q_base.dtype).detach()


def _constraint_bias(ms: MaskSet, lk: int) -> torch.Tensor:
    """Additive -1000 bias of the self-attention constraints that the
    reference's compute_attention intends (attention_sharing.py:37-42; its
    chained boolean indexing assigns to a copy): rows inside the warped
    object take no keys outside the object, background rows none inside.
    (E, L, lk), each edit's own."""
    rows_fgw = ms.mask_new_warped >= 0.5
    cols_not_fg = ms.mask_warp[..., :lk] < 0.5
    rows_bg = ms.background >= 0.5
    cols_fg = ms.mask_warp[..., :lk] >= 0.5
    bias = torch.where(rows_fgw[..., :, None] & cols_not_fg[..., None, :], -1000.0, 0.0)
    return bias + torch.where(rows_bg[..., :, None] & cols_fg[..., None, :], -1000.0, 0.0)


def _branch_logs(is_cross: bool, **vals) -> Dict[str, torch.Tensor]:
    logs = zero_logs()
    prefix = "cross" if is_cross else "self"
    for k, v in vals.items():
        logs[f"{prefix}/{k}"] = v
    logs["num_layers"] = 1.0
    return logs


def _streams(q, k, v, state: EditState):
    """Each edit's detached base stream (q_b, k_b, v_b) and its edit
    queries q_e, (E, H, L, D) each.  Contiguous: a strided stream would take
    another matmul path than the contiguous warped queries that meet it in
    the L1 losses, whose zero residual at step 0 must stay exactly zero."""
    b_i, e_i = state.base_idx, state.edit_idx
    return (q[:, b_i].detach().contiguous(), k[:, b_i].detach().contiguous(),
            v[:, b_i].detach().contiguous(), q[:, e_i].contiguous())


def _past_obj(state: EditState) -> bool:
    if state.past_obj_edit is None:
        return state.cur_step >= state.obj_edit_thresh
    return state.past_obj_edit


def _editor_stream(q, k, v, is_cross: bool, state: EditState, ms: MaskSet, scale: float):
    """AttentionGeometryEdit edit-stream output + losses
    (attention_processors.py:384-624) of every edit of the group: q, k, v
    (E, S, H, L, D), returns (E, H, L, D), the (E,) losses and the logs.
    With the attention constraints the self layers' edit attention is
    explicit: logits plus `_constraint_bias`, the softmax in bf16, and the
    removal loss from those maps."""
    q_b, k_b, v_b, q_e = _streams(q, k, v, state)
    # live keys: self uses base keys, cross uses edit keys; values from base
    k_r = k[:, state.edit_idx].contiguous() if is_cross else k_b

    # No-loss blend over the warped-row budget (CFG steps); the host selects
    # full_blend when any edit's warped mask at any resolution overflows it.
    if (not state.compute_losses and state.past_obj_edit is False
            and not state.full_blend and ms.warped_rows is not None
            and not state.apply_constraints):
        rows = ms.warped_rows
        q_eb_rows = _warp_queries_rows(q_b, ms, state, rows)
        edit_rows = fast_attention(q_eb_rows, k_b, v_b, scale).detach()
        replace_out = fast_attention(q_e, k_r, v_b, scale)
        idx = rows[:, None, :, None].expand(*edit_rows.shape)
        rep_rows = torch.gather(replace_out, 2, idx)
        m_rows = torch.gather(ms.mask_new_warped, 1, rows)[:, None, :, None].to(replace_out.dtype)
        # padded budget rows carry mask weight 0: the blend is a no-op there
        blend = edit_rows.to(replace_out.dtype) * m_rows + rep_rows * (1.0 - m_rows)
        return replace_out.scatter(2, idx, blend), 0.0, zero_logs()

    past_obj = _past_obj(state)
    use_explicit = state.apply_constraints and not is_cross
    if use_explicit:
        logits = torch.matmul(q_e.float(), k_r.float().transpose(-1, -2)) * scale
        logits = logits + _constraint_bias(ms, logits.shape[-1])[:, None]
        probs_full = torch.softmax(logits, dim=-1).to(torch.bfloat16)
        replace_out = attn_out(probs_full, v_b)
        probs_rows = (_rows_of(probs_full, ms.inpaint_rows)
                      if state.compute_losses and ms.inpaint_rows is not None else None)
    else:
        replace_out = fast_attention(q_e, k_r, v_b, scale)
    if past_obj and not state.compute_losses:
        # diffusion correction: the shared output would feed nothing (the
        # JAX package's compiler deletes this side the same way)
        return replace_out, 0.0, zero_logs()
    q_eb = _warp_queries(q_b, ms, state)
    edit_out = fast_attention(q_eb, k_b, v_b, scale).detach()

    loss = 0.0
    logs = zero_logs()
    l = q.shape[3]
    if state.compute_losses and l >= state.loss_min_seq:
        w = state.weights_cross if is_cross else state.weights_self
        sim = background_preservation_loss(edit_out, replace_out, ms.background)
        movement = object_placement_loss(edit_out, replace_out, ms.mask_new_warped)
        if use_explicit:
            removal = removal_loss(probs_rows, attn_probs(q_b, k_b, scale).to(torch.bfloat16), ms)
        else:
            removal = removal_loss_fused(q_e, k_r, q_b, k_b, ms, scale)
        smooth = smoothness_loss(replace_out)
        if l >= state.amodal_min_seq:
            amodal = amodal_loss(edit_out, replace_out, ms)
        else:
            # zeroed at 32^2 (attention_processors.py:479-480)
            amodal = torch.zeros_like(sim)
        loss = (w["sim"] * sim + w["movement"] * movement + w["removal"] * removal
                + w["smoothness"] * smooth + w["amodal"] * amodal)
        logs = _branch_logs(is_cross, sim=sim, movement=movement, removal=removal,
                            smoothness=smooth, amodal=amodal)

    # attention sharing vs diffusion correction (attention_processors.py:502-508)
    if past_obj:
        return replace_out, loss, logs
    m_e = ms.mask_new_warped[:, None, :, None].to(replace_out.dtype)
    return edit_out * m_e + replace_out * (1.0 - m_e), loss, logs


def _remover_stream(q, k, v, is_cross: bool, state: EditState, ms: MaskSet, scale: float,
                    base_out):
    """AttentionGeometryRemover edit-stream output + losses
    (attention_processors.py:748-928) of every edit of the group, shapes as
    in `_editor_stream`."""
    q_b, k_b, v_b, q_e = _streams(q, k, v, state)
    edit_out = base_out.detach()   # the base stream's vanilla output
    replace_out = fast_attention(q_e, k_b, v_b, scale)

    loss = 0.0
    logs = zero_logs()
    l = q.shape[3]
    if state.compute_losses and l >= state.loss_min_seq:
        w = state.weights_cross if is_cross else state.weights_self
        sim = background_preservation_loss(edit_out, replace_out, ms.background)
        removal = removal_loss_fused(q_e, k_b, q_b, k_b, ms, scale)
        smooth = smoothness_loss(replace_out)
        loss = w["sim"] * sim + w["removal"] * removal + w["smoothness"] * smooth
        logs = _branch_logs(is_cross, sim=sim, removal=removal, smoothness=smooth)

    # past obj_edit_step, identity attention inside the inpaint mask
    # (attention_processors.py:831-834, 922-925)
    m_in = ms.inpaint[:, None, :, None].to(replace_out.dtype)
    m_bg = ms.background[:, None, :, None].to(replace_out.dtype)
    if _past_obj(state):
        e_i = state.edit_idx
        id_out = fast_attention(q_e, k[:, e_i].contiguous(), v[:, e_i].contiguous(), scale)
        return id_out * m_in + replace_out * m_bg, loss, logs
    return replace_out * m_in + replace_out * m_bg, loss, logs


def edited_attention(q, k, v, *, is_cross: bool, state: EditState, scale: float
                     ) -> Tuple[torch.Tensor, object, Dict[str, object]]:
    """Full edited multi-stream attention (AttentionGeometryEdit.forward,
    attention_processors.py:633-664): cross layers are always edited,
    self layers inside the self-replace window; under CFG only the cond
    edit stream is replaced.  q, k, v are (E*S, H, L, D), each edit's S
    streams together; returns (out (E*S, H, L, D), loss, logs), the loss
    and every log (E,)."""
    n, h, l, d = q.shape
    res = math.isqrt(l)
    if res * res != l or res not in state.masks:
        return fast_attention(q, k, v, scale), 0.0, zero_logs()
    ms = state.masks[res]
    e = state.n_edits
    q, k, v = (x.reshape(e, -1, *x.shape[1:]) for x in (q, k, v))
    n_van = state.n_vanilla_streams
    van = slice(0, n_van)
    if state.consume_taps:
        # the vanilla streams start with the detached tap; detaching them
        # all keeps autograd from running a backward whose cotangent is 0
        out_v = fast_attention(q[:, van].detach(), k[:, van].detach(), v[:, van].detach(), scale)
    else:
        out_v = fast_attention(q[:, van], k[:, van], v[:, van], scale)

    in_window = state.self_window
    if in_window is None:
        in_window = state.self_replace_lo <= state.cur_step < state.self_replace_hi
    if (is_cross or in_window) and state.mode == "remover":
        out_e, loss, logs = _remover_stream(q, k, v, is_cross, state, ms, scale,
                                            out_v[:, state.base_idx])
    elif is_cross or in_window:
        out_e, loss, logs = _editor_stream(q, k, v, is_cross, state, ms, scale)
    else:
        i = state.edit_idx
        out_e = fast_attention(q[:, i], k[:, i], v[:, i], scale)
        loss, logs = 0.0, zero_logs()
    return torch.cat([out_v, out_e[:, None]], dim=1).reshape(n, h, l, d), loss, logs
