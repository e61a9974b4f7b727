"""Edit state: the masks, warp operators and flags the attention edit needs.

Counterpart of `geodiffuser_tpu/core/edit_state.py`.  The reference threads
a stateful controller with lazily built per-resolution mask caches through
every attention layer (attention_sharing.py:110-153,
attention_processors.py:319-373); here the masks of every attention
resolution are built once per edit and the per-step state is a plain
dataclass passed down the UNet.

A lockstep group of E edits (`parallel/batch.py`) stacks E single-edit mask
sets into one whose every field has a leading edit axis
(`stack_mask_sets`), as the JAX package's `jax.vmap` over its step
programs gives each per-edit array; the row budgets are equal across edits
of one type, so they stack.  An `EditState` over such masks carries the
group size in `n_edits` (1 for one edit's masks, which it stacks as a
group of one) and may carry per-edit (E,) loss weights.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence

import torch

from portbench.reference.gd.config import EditConfig
from portbench.reference.gd.ops import image as image_ops
from portbench.reference.gd.ops import splat as splat_ops


def loss_min_seq(max_res: int) -> int:
    """Losses run at the two highest attention resolutions (seq >= 32^2 at 512^2)."""
    return (max_res // 2) ** 2


def amodal_min_seq(max_res: int) -> int:
    return max_res ** 2


def top_k_desc(x: torch.Tensor, k: int):
    """`jax.lax.top_k` over the last axis: ties keep the lowest index first.

    `torch.topk` promises no order among ties; a stable descending sort
    does, and the row budgets (inpaint_rows, warped_rows) and the amodal
    interpolation sources of binary or symmetric inputs are all ties."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@dataclasses.dataclass
class MaskSet:
    """Per-resolution masks, flattened to (seq,) where noted (reference
    process_and_cache_masks, attention_processors.py:334-373); field
    meanings as in the JAX package's MaskSet."""

    mask_warp: torch.Tensor
    mask_new_warped: torch.Tensor
    amodal: torch.Tensor
    inpaint: torch.Tensor
    background: torch.Tensor
    mask_new_warped_2d: torch.Tensor     # (res, res)
    t_coords: torch.Tensor               # (res, res, 3)
    pos: Optional[torch.Tensor] = None           # (seq, 2) NDC pixel centers
    interp_idx: Optional[torch.Tensor] = None    # (seq, 4) amodal sources
    interp_vals: Optional[torch.Tensor] = None   # (seq, 4) inverse distances
    interp_w: Optional[torch.Tensor] = None      # (seq,) confidence weights
    inpaint_rows: Optional[torch.Tensor] = None      # (budget,) removal-loss rows
    inpaint_row_mask: Optional[torch.Tensor] = None  # (budget,)
    inpaint_overflow: Optional[torch.Tensor] = None  # () 1.0 when rows were dropped
    warped_rows: Optional[torch.Tensor] = None       # (seq//4,) no-loss blend rows
    warped_row_mask: Optional[torch.Tensor] = None
    warped_overflow: Optional[torch.Tensor] = None   # () 1.0 -> full_blend


class RecordTaps:
    """`edit` value for the no-grad base pass: run vanilla attention and
    record each attention layer's (q, k, v) in `taps`, keyed by layer name,
    for the one-stream differentiated edit pass."""

    def __init__(self):
        self.taps: Dict[str, tuple] = {}


class LossAccumulator:
    """Sum of the per-layer edit losses and logs over one UNet forward
    (the reference's `controller.loss +=`, attention_processors.py:494, 604);
    in a group each loss and log is an (E,) tensor, one entry per edit."""

    def __init__(self):
        from portbench.reference.gd.core.edit_attention import zero_logs

        self.loss = 0.0
        self.logs = zero_logs()

    def add(self, loss, logs):
        self.loss = self.loss + loss
        for k, v in logs.items():
            self.logs[k] = self.logs[k] + v


@dataclasses.dataclass
class EditState:
    """Per-step state threaded through the UNet attention layers."""

    cur_step: int
    obj_edit_thresh: int
    self_replace_lo: int
    self_replace_hi: int
    splat_radius: float
    splat_tau: float
    weights_self: Dict[str, object]     # floats, or (E,) tensors in a group
    weights_cross: Dict[str, object]
    masks: Dict[int, MaskSet]
    warp_mats: Optional[Dict[int, torch.Tensor]] = None
    loss_min_seq: int = 32 * 32
    amodal_min_seq: int = 64 * 64
    mode: str = "editor"
    use_cfg: bool = True
    slim_cfg: bool = False
    consume_taps: bool = False
    compute_losses: bool = False
    apply_constraints: bool = False
    z_beta: float = 20.0
    self_window: Optional[bool] = None
    past_obj_edit: Optional[bool] = None
    full_blend: bool = False
    # base-stream (q, k, v) per attention layer from a RecordTaps pass
    taps: Optional[Dict[str, tuple]] = None
    # edits of a lockstep group: the masks' (and warp operators') leading axis
    n_edits: int = 1

    @property
    def n_vanilla_streams(self) -> int:
        """Streams that keep vanilla attention; orderings as in the JAX
        package: [base, edit]; CFG [uncond_base, uncond_edit, cond_base,
        cond_edit]; slim [uncond_edit, cond_base, cond_edit]; slim + taps
        [cond_base(tap), uncond_edit, cond_edit]."""
        if not self.use_cfg:
            return 1
        if self.consume_taps:
            return 2
        return 2 if self.slim_cfg else 3

    @property
    def base_idx(self) -> int:
        if not self.use_cfg or self.consume_taps:
            return 0
        return 1 if self.slim_cfg else 2

    @property
    def edit_idx(self) -> int:
        if not self.use_cfg:
            return 1
        if self.consume_taps:
            return 2
        return 2 if self.slim_cfg else 3


def coordinate_positions(res: int, device=None) -> torch.Tensor:
    """NDC pixel-center positions (seq, 2): x_i = (2i+1)/res - 1
    (CoordinateDistances, generic_torch.py:126-140)."""
    x = (2.0 * torch.arange(res, dtype=torch.float32, device=device) + 1.0) / res - 1.0
    yy, xx = torch.meshgrid(x, x, indexing="ij")
    return torch.stack([xx.reshape(-1), yy.reshape(-1)], dim=-1)


def pairwise_distance(pos_a: torch.Tensor, pos_b: torch.Tensor) -> torch.Tensor:
    d2 = torch.sum((pos_a[..., :, None, :] - pos_b[..., None, :, :]) ** 2, dim=-1)
    return torch.sqrt(d2 + 1e-12)


def build_mask_sets(image_mask: torch.Tensor, t_coords: torch.Tensor,
                    amodal_mask: Optional[torch.Tensor], resolutions: tuple,
                    mode: str = "editor", splat_radius: float = 1.3, splat_tau: float = 1.0,
                    z_beta: float = 20.0, dilate_remover: int = 5) -> Dict[int, MaskSet]:
    """Every per-resolution mask set of one edit (process_and_cache_masks,
    attention_processors.py:319-373; remover variant :748-780, :986)."""
    image_mask = image_ops.binarize(image_mask.float())
    if mode == "remover":
        image_mask = image_ops.dilate(image_mask, dilate_remover)
    if mode == "editor":
        warped_full = splat_ops.splat_image(
            image_mask[..., None], t_coords, radius=splat_radius, tau=splat_tau, z_beta=z_beta
        )[..., 0]
        warped_full = image_ops.binarize(warped_full)
        amodal_full = image_ops.binarize(amodal_mask.float())
    else:
        warped_full = image_mask
        amodal_full = torch.zeros_like(image_mask)

    dev = image_mask.device
    out: Dict[int, MaskSet] = {}
    for res in resolutions:
        seq = res * res
        m_warp = image_ops.resize_bilinear(image_mask, res, res)
        m_new = image_ops.resize_bilinear(warped_full, res, res)
        tc = image_ops.resize_bilinear_hwc(t_coords, res, res)
        if mode == "editor":
            am = image_ops.resize_bilinear(amodal_full, res, res)
            am = image_ops.binarize(am - m_new)
            intersection = image_ops.binarize((m_new + am) * m_warp, 0.5)
            inpaint = image_ops.binarize(m_warp - intersection, 0.5)
            background = image_ops.binarize(1.0 - (inpaint + m_new))
        else:
            am = torch.zeros((res, res), dtype=torch.float32, device=dev)
            inpaint = image_ops.binarize(m_warp, 0.5)
            background = image_ops.binarize(1.0 - inpaint)
            m_new = inpaint

        is_loss_res = seq >= loss_min_seq(max(resolutions))
        extra = {}
        inpaint_flat = inpaint.reshape(-1)
        if is_loss_res:
            pos = coordinate_positions(res, dev)
            dist = pairwise_distance(pos, pos)
            fg = m_new.reshape(-1)
            d_new = dist * (512.0 / 2.0) + 1e5 * (1.0 - (fg > 0.5).float())[None, :]
            inv = 1.0 / (d_new + 1e-4)
            del dist, d_new
            interp_vals, interp_idx = top_k_desc(inv, 4)
            del inv
            k = seq // 2 if mode == "remover" else seq // 4
            row_vals, rows = top_k_desc(inpaint_flat, k)
            m_new_flat = m_new.reshape(-1)
            kw = seq // 4
            wvals, wrows = top_k_desc(m_new_flat, kw)
            extra = dict(
                pos=pos,
                interp_idx=interp_idx,
                interp_vals=interp_vals,
                interp_w=torch.exp(-(1.0 / torch.amax(interp_vals, dim=-1)) / 5.0),
                inpaint_rows=rows,
                inpaint_row_mask=(row_vals > 0.5).float(),
                inpaint_overflow=(inpaint_flat.sum() > k).float(),
                warped_rows=wrows,
                warped_row_mask=(wvals > 0.0).float(),
                warped_overflow=((m_new_flat > 0.0).sum() > kw).float(),
            )
        out[res] = MaskSet(
            mask_warp=m_warp.reshape(-1),
            mask_new_warped=m_new.reshape(-1),
            amodal=am.reshape(-1),
            inpaint=inpaint_flat,
            background=background.reshape(-1),
            mask_new_warped_2d=m_new.reshape(res, res),
            t_coords=tc,
            **extra,
        )
    return out


def is_batched(masks: Dict[int, MaskSet]) -> bool:
    """Whether the mask sets carry a leading edit axis."""
    return next(iter(masks.values())).inpaint.dim() == 2


def stack_mask_sets(sets: Sequence[Dict[int, MaskSet]]) -> Dict[int, MaskSet]:
    """E single-edit mask sets (of one edit type and image size) as one
    whose every field has a leading edit axis of E."""
    out = {}
    for res in sets[0]:
        fields = {}
        for f in dataclasses.fields(MaskSet):
            vals = [getattr(s[res], f.name) for s in sets]
            fields[f.name] = None if vals[0] is None else torch.stack(vals)
        out[res] = MaskSet(**fields)
    return out


def as_batched(masks: Dict[int, MaskSet]) -> Dict[int, MaskSet]:
    """The mask sets with a leading edit axis: one edit's become a group of 1."""
    return masks if is_batched(masks) else stack_mask_sets([masks])


def build_warp_matrices(masks: Dict[int, MaskSet], radius: float, tau: float,
                        z_beta: float) -> Dict[int, torch.Tensor]:
    """Dense splat operator per resolution for the current (annealed) splat
    parameters; shared by all attention layers of a step.  (L, L) for one
    edit's masks, (E, L, L) for a group's: one operator per edit."""
    def op(tc):
        return splat_ops.warp_matrix(tc, radius=radius, tau=tau, z_beta=z_beta)

    if not is_batched(masks):
        return {res: op(ms.t_coords) for res, ms in masks.items()}
    return {res: torch.stack([op(tc) for tc in ms.t_coords]) for res, ms in masks.items()}


def make_edit_state(cfg: EditConfig, masks: Dict[int, MaskSet], cur_step: int = 0,
                    use_cfg: bool = True, compute_losses: bool = False,
                    weights: Optional[Mapping[str, Mapping[str, float]]] = None,
                    splat_radius: Optional[float] = None, splat_tau: Optional[float] = None,
                    warp_mats: Optional[Dict[int, torch.Tensor]] = None, slim_cfg: bool = False,
                    consume_taps: bool = False, self_window: Optional[bool] = None,
                    past_obj_edit: Optional[bool] = None, full_blend: bool = False,
                    taps: Optional[Dict[str, tuple]] = None) -> EditState:
    """The state of one step; one edit's masks and warp operators without an
    edit axis become a group of one."""
    if not is_batched(masks):
        masks = stack_mask_sets([masks])
        warp_mats = None if warp_mats is None else {r: w[None] for r, w in warp_mats.items()}
    w = weights if weights is not None else cfg.resolved_loss_weights()
    n = cfg.num_ddim_steps
    max_res = max(masks.keys())
    return EditState(
        cur_step=int(cur_step),
        obj_edit_thresh=int(n * cfg.obj_edit_step),
        self_replace_lo=0,
        self_replace_hi=int(n * cfg.self_replace_steps),
        splat_radius=float(cfg.splat.radius if splat_radius is None else splat_radius),
        splat_tau=float(cfg.splat.tau if splat_tau is None else splat_tau),
        weights_self={k: _weight(v) for k, v in w["self"].items()},
        weights_cross={k: _weight(v) for k, v in w["cross"].items()},
        masks=masks,
        warp_mats=warp_mats,
        loss_min_seq=loss_min_seq(max_res),
        amodal_min_seq=amodal_min_seq(max_res),
        mode="remover" if cfg.edit_type == "geometry_remover" else "editor",
        use_cfg=use_cfg,
        slim_cfg=slim_cfg,
        consume_taps=consume_taps,
        compute_losses=compute_losses,
        apply_constraints=cfg.apply_attention_constraints,
        z_beta=cfg.splat.z_beta,
        self_window=self_window,
        past_obj_edit=past_obj_edit,
        full_blend=full_blend,
        taps=taps,
        n_edits=next(iter(masks.values())).inpaint.shape[0],
    )


def _weight(v):
    """A loss weight: a float, or a group's (E,) tensor as it is."""
    return v if isinstance(v, torch.Tensor) and v.dim() > 0 else float(v)
