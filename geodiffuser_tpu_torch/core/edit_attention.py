"""GeoDiffuser shared-attention editing (editor and remover modes) as
functions on tensors.

Counterpart of `geodiffuser_tpu/core/edit_attention.py` (reference
AttentionGeometryEdit, attention_processors.py:384-624,
AttentionGeometryRemover, :748-928, the edit losses :231-305 and the
smoothness TV loss, loss.py:29-40).

q, k, v are (S, H, L, D): S CFG streams, H heads.  Logits, softmax and
losses are float32.  Gradient boundaries follow the reference: the base
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
# Losses (float32; masks are flattened (L,) floats)
# ---------------------------------------------------------------------------

def background_preservation_loss(edit_out, replace_out, mask_bg, eps: float = 1e-8):
    """Masked L1 between the detached shared output and the live edit
    output over the background (attention_processors.py:231-246)."""
    diff = torch.abs(edit_out.detach().float() - replace_out.float())
    num = (diff * mask_bg[None, :, None]).sum()
    h, _, d = replace_out.shape
    return num / (mask_bg.sum() * h * d + eps)


def object_placement_loss(edit_out, replace_out, mask_edit, eps: float = 1e-8):
    """Masked L1 inside the warped object mask (attention_processors.py:283-287)."""
    return background_preservation_loss(edit_out, replace_out, mask_edit, eps)


def _removal_per_row_loss(p_in, p_bg, d_bg, row_mask, inpaint_sum, h, eps=1e-4):
    """Distance-weighted log-ratio reduction (attention_processors.py:263-268)."""
    w = torch.exp(-d_bg).detach()
    per_row = w * (-torch.log(torch.clamp(p_bg, min=0.0) + eps)
                   + torch.log(torch.clamp(p_in, min=0.0) + eps))
    return (per_row * row_mask[None, :]).sum() / (inpaint_sum * h + 1e-8)


def removal_loss_fused(q_e, k_r, q_b, k_b, ms: MaskSet, scale: float) -> torch.Tensor:
    """Removal correlation loss through the fused kernel (no attention map
    or correlation matrix in device memory; attention_processors.py:248-280
    under the static row budget)."""
    h = q_e.shape[0]
    rows, row_mask = ms.inpaint_rows, ms.inpaint_row_mask
    qe_rows = q_e[:, rows]
    p_in, p_bg, _, j_bg = rc.removal_correlation(
        qe_rows, k_r, q_b.detach(), k_b.detach(), ms.inpaint, ms.background, row_mask, scale
    )
    d_bg = torch.sqrt(((ms.pos[rows][None] - ms.pos[j_bg.long()]) ** 2).sum(-1) + 1e-12)
    return _removal_per_row_loss(p_in, p_bg, d_bg, row_mask, ms.inpaint.sum(), h)


def removal_loss(probs_rows, base_probs, ms: MaskSet) -> torch.Tensor:
    """The removal correlation loss from materialized maps: probs_rows
    (H, K, L) are the edit stream's probabilities at the budgeted inpaint
    rows, base_probs (H, L, L) the base stream's (attention_processors.py:
    248-280).  Used only with the attention constraints, where the maps
    exist anyway; `removal_loss_fused` otherwise."""
    h = probs_rows.shape[0]
    rows, row_mask = ms.inpaint_rows, ms.inpaint_row_mask
    corr = torch.matmul(probs_rows.float(), base_probs.detach().float().transpose(-1, -2))
    neg = torch.tensor(-1e9, dtype=torch.float32, device=corr.device)
    corr_in = torch.where(ms.inpaint[None, None, :] > 0.5, corr, neg)
    corr_bg = torch.where(ms.background[None, None, :] > 0.5, corr, neg)
    # amax splits the gradient between tied maxima, as jnp.max does
    p_in = torch.amax(corr_in, dim=-1)
    p_bg = torch.amax(corr_bg, dim=-1)
    j_bg = torch.argmax(corr_bg, dim=-1)
    d_bg = torch.sqrt(((ms.pos[rows][None] - ms.pos[j_bg]) ** 2).sum(-1) + 1e-12)
    return _removal_per_row_loss(p_in, p_bg, d_bg, row_mask, ms.inpaint.sum(), h)


def smooth_attention_features(features: torch.Tensor) -> torch.Tensor:
    """5x5 Gaussian blur of per-head feature maps (generic_torch.py:145-154)."""
    h, l, d = features.shape
    res = math.isqrt(l)
    maps = features.permute(0, 2, 1).reshape(h * d, res, res)
    maps = image_ops.gaussian_smooth_2d(maps, size=5)
    return maps.reshape(h, d, l).permute(0, 2, 1)


def amodal_loss(edit_out, replace_out, ms: MaskSet, eps: float = 1e-8):
    """Fill the amodal ring by nearest-foreground interpolation and pull the
    edit output toward it (attention_processors.py:289-305)."""
    e = edit_out.detach().float()
    feats = e[:, ms.interp_idx, :]                              # (H, L, 4, D)
    vals = ms.interp_vals
    interp = (feats * vals[None, :, :, None]).sum(-2) / (vals.sum(-1)[None, :, None] + 1e-12)
    w = ms.interp_w
    interp = torch.where((ms.mask_new_warped > 0.5)[None, :, None], e, interp)
    interp = smooth_attention_features(interp)
    diff = torch.abs(interp.detach() - replace_out.float())
    wm = (w * ms.amodal)[None, :, None]
    h, _, d = replace_out.shape
    return (diff * wm).sum() / ((w * ms.amodal).sum() * h * d + eps)


def smoothness_loss(replace_out: torch.Tensor) -> torch.Tensor:
    """Total variation over the spatial grid (loss.py:29-40)."""
    h, l, d = replace_out.shape
    res = math.isqrt(l)
    r = replace_out.float().reshape(h, res, res, d)
    dh = torch.abs(r[:, 1:] - r[:, :-1]).mean()
    dw = torch.abs(r[:, :, 1:] - r[:, :, :-1]).mean()
    return dh + dw


# ---------------------------------------------------------------------------
# Edit-stream attention
# ---------------------------------------------------------------------------

def _warp_queries(q_base, ms: MaskSet, state: EditState) -> torch.Tensor:
    """q <- q*(1-m) + m*splat(q) inside the warped mask
    (attention_processors.py:423-424, 543-545), through the dense warp
    operator in the model type; fully detached."""
    h, l, d = q_base.shape
    res = math.isqrt(l)
    q_img = q_base.permute(1, 0, 2).reshape(res, res, h * d)
    if state.warp_mats is not None and res in state.warp_mats:
        q_warp = splat_ops.apply_warp_matrix(state.warp_mats[res].to(q_img.dtype), q_img)
    else:
        q_warp = splat_ops.splat_image(q_img.float(), ms.t_coords, radius=state.splat_radius,
                                       tau=state.splat_tau, z_beta=state.z_beta)
    m = ms.mask_new_warped_2d[..., None]
    out = q_img.float() * (1.0 - m) + m * q_warp.float()
    return out.reshape(l, h, d).permute(1, 0, 2).to(q_base.dtype).detach()


def _warp_queries_rows(q_base, ms: MaskSet, state: EditState, rows) -> torch.Tensor:
    """`_warp_queries` over a static row budget: the operator's rows are
    gathered before the product.  Returns (H, K, D), detached."""
    h, l, d = q_base.shape
    res = math.isqrt(l)
    q_flat = q_base.permute(1, 0, 2).reshape(l, h * d)
    if state.warp_mats is not None and res in state.warp_mats:
        # operands rounded to the model type, float32 result (the JAX
        # package's dot with preferred_element_type=float32)
        w_rows = state.warp_mats[res][rows].to(q_flat.dtype).float()
        q_warp = w_rows @ q_flat.float()
    else:
        q_img = q_flat.reshape(res, res, h * d)
        q_warp = splat_ops.splat_image(q_img.float(), ms.t_coords, radius=state.splat_radius,
                                       tau=state.splat_tau, z_beta=state.z_beta
                                       ).reshape(l, h * d)[rows]
    m = ms.mask_new_warped[rows][:, None]
    out = q_flat[rows].float() * (1.0 - m) + m * q_warp
    k = rows.shape[0]
    return out.reshape(k, h, d).permute(1, 0, 2).to(q_base.dtype).detach()


def _constraint_bias(ms: MaskSet, lk: int) -> torch.Tensor:
    """Additive -1000 bias (L, lk) of the self-attention constraints that
    the reference's compute_attention intends (attention_sharing.py:37-42;
    its chained boolean indexing assigns to a copy): rows inside the warped
    object take no keys outside the object, background rows none inside."""
    rows_fgw = ms.mask_new_warped >= 0.5
    cols_not_fg = ms.mask_warp < 0.5
    rows_bg = ms.background >= 0.5
    cols_fg = ms.mask_warp >= 0.5
    bias = torch.where(rows_fgw[:, None] & cols_not_fg[None, :lk], -1000.0, 0.0)
    return bias + torch.where(rows_bg[:, None] & cols_fg[None, :lk], -1000.0, 0.0)


def _branch_logs(is_cross: bool, **vals) -> Dict[str, torch.Tensor]:
    logs = zero_logs()
    prefix = "cross" if is_cross else "self"
    for k, v in vals.items():
        logs[f"{prefix}/{k}"] = v
    logs["num_layers"] = 1.0
    return logs


def _editor_stream(q, k, v, is_cross: bool, state: EditState, ms: MaskSet, scale: float):
    """AttentionGeometryEdit edit-stream output + losses
    (attention_processors.py:384-624).  With the attention constraints the
    self layers' edit attention is explicit: logits plus `_constraint_bias`,
    the softmax in bf16, and the removal loss from those maps."""
    b_i, e_i = state.base_idx, state.edit_idx
    q_b, k_b, v_b = q[b_i].detach(), k[b_i].detach(), v[b_i].detach()
    q_e = q[e_i]
    # live keys: self uses base keys, cross uses edit keys; values from base
    k_r = k[e_i] if is_cross else k_b

    # No-loss blend over the warped-row budget (CFG steps); the host selects
    # full_blend when any resolution's warped mask overflows the budget.
    if (not state.compute_losses and state.past_obj_edit is False
            and not state.full_blend and ms.warped_rows is not None
            and not state.apply_constraints):
        rows = ms.warped_rows
        q_eb_rows = _warp_queries_rows(q_b, ms, state, rows)
        edit_rows = fast_attention(q_eb_rows, k_b, v_b, scale).detach()
        replace_out = fast_attention(q_e, k_r, v_b, scale)
        rep_rows = replace_out[:, rows]
        m_rows = ms.mask_new_warped[rows][None, :, None].to(replace_out.dtype)
        # padded budget rows carry mask weight 0: the blend is a no-op there
        blend = edit_rows.to(replace_out.dtype) * m_rows + rep_rows * (1.0 - m_rows)
        out = replace_out.clone()
        out[:, rows] = blend
        return out, 0.0, zero_logs()

    past_obj = state.past_obj_edit
    if past_obj is None:
        past_obj = state.cur_step >= state.obj_edit_thresh
    use_explicit = state.apply_constraints and not is_cross
    if use_explicit:
        logits = torch.matmul(q_e.float(), k_r.float().transpose(-1, -2)) * scale
        logits = logits + _constraint_bias(ms, logits.shape[-1])[None]
        probs_full = torch.softmax(logits, dim=-1).to(torch.bfloat16)
        replace_out = attn_out(probs_full, v_b)
        probs_rows = probs_full[:, ms.inpaint_rows] if state.compute_losses else None
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
    l = q.shape[2]
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
            amodal = torch.zeros((), dtype=torch.float32, device=q.device)
        loss = (w["sim"] * sim + w["movement"] * movement + w["removal"] * removal
                + w["smoothness"] * smooth + w["amodal"] * amodal)
        logs = _branch_logs(is_cross, sim=sim, movement=movement, removal=removal,
                            smoothness=smooth, amodal=amodal)

    # attention sharing vs diffusion correction (attention_processors.py:502-508)
    if past_obj:
        return replace_out, loss, logs
    m_e = ms.mask_new_warped[None, :, None].to(replace_out.dtype)
    return edit_out * m_e + replace_out * (1.0 - m_e), loss, logs


def _remover_stream(q, k, v, is_cross: bool, state: EditState, ms: MaskSet, scale: float,
                    base_out):
    """AttentionGeometryRemover edit-stream output + losses
    (attention_processors.py:748-928)."""
    b_i, e_i = state.base_idx, state.edit_idx
    q_b, k_b, v_b = q[b_i].detach(), k[b_i].detach(), v[b_i].detach()
    q_e = q[e_i]
    edit_out = base_out.detach()   # the base stream's vanilla output
    replace_out = fast_attention(q_e, k_b, v_b, scale)

    loss = 0.0
    logs = zero_logs()
    l = q.shape[2]
    if state.compute_losses and l >= state.loss_min_seq:
        w = state.weights_cross if is_cross else state.weights_self
        sim = background_preservation_loss(edit_out, replace_out, ms.background)
        removal = removal_loss_fused(q_e, k_b, q_b, k_b, ms, scale)
        smooth = smoothness_loss(replace_out)
        loss = w["sim"] * sim + w["removal"] * removal + w["smoothness"] * smooth
        logs = _branch_logs(is_cross, sim=sim, removal=removal, smoothness=smooth)

    # past obj_edit_step, identity attention inside the inpaint mask
    # (attention_processors.py:831-834, 922-925)
    past_obj = state.past_obj_edit
    if past_obj is None:
        past_obj = state.cur_step >= state.obj_edit_thresh
    m_in = ms.inpaint[None, :, None].to(replace_out.dtype)
    m_bg = ms.background[None, :, None].to(replace_out.dtype)
    if past_obj:
        id_out = fast_attention(q_e, k[e_i], v[e_i], scale)
        return id_out * m_in + replace_out * m_bg, loss, logs
    return replace_out * m_in + replace_out * m_bg, loss, logs


def edited_attention(q, k, v, *, is_cross: bool, state: EditState, scale: float
                     ) -> Tuple[torch.Tensor, object, Dict[str, object]]:
    """Full edited multi-stream attention (AttentionGeometryEdit.forward,
    attention_processors.py:633-664): cross layers are always edited,
    self layers inside the self-replace window; under CFG only the cond
    edit stream is replaced.  Returns (out (S,H,L,D), loss, logs)."""
    s, h, l, d = q.shape
    res = math.isqrt(l)
    if res * res != l or res not in state.masks:
        return fast_attention(q, k, v, scale), 0.0, zero_logs()
    ms = state.masks[res]
    n_van = state.n_vanilla_streams
    van = slice(0, n_van)
    if state.consume_taps:
        # the vanilla streams start with the detached tap; detaching them
        # all keeps autograd from running a backward whose cotangent is 0
        out_v = fast_attention(q[van].detach(), k[van].detach(), v[van].detach(), scale)
    else:
        out_v = fast_attention(q[van], k[van], v[van], scale)

    in_window = state.self_window
    if in_window is None:
        in_window = state.self_replace_lo <= state.cur_step < state.self_replace_hi
    if (is_cross or in_window) and state.mode == "remover":
        out_e, loss, logs = _remover_stream(q, k, v, is_cross, state, ms, scale,
                                            out_v[state.base_idx])
    elif is_cross or in_window:
        out_e, loss, logs = _editor_stream(q, k, v, is_cross, state, ms, scale)
    else:
        e = state.edit_idx
        out_e = fast_attention(q[e:e + 1], k[e:e + 1], v[e:e + 1], scale)[0]
        loss, logs = 0.0, zero_logs()
    return torch.cat([out_v, out_e[None]], dim=0), loss, logs
