"""The reference's edit steps: a frozen copy of the step functions of the
port's `core/editor.py` (reference `text2image_ldm_stable`,
editor.py:65-423), run in float32.

 * `_optimize_step`: a no-grad base pass records per-layer q/k/v taps, a
   differentiated one-stream edit pass consumes them and sums the five
   losses, `torch.autograd.grad` gives the latent/embedding gradients, then
   the masked SGD update and norm projection;
 * `_cfg_step`: a slim 3-stream pass, or a 2-stream pass reusing the same
   step's taps, then the DDIM step, base-trajectory pinning and the latent
   warp-replace (editor mode);
 * `step_plan`: what the port's edit loop hands a step (its phase flags,
   splat radius and tau, learning rate and warp operators).

The step functions take a leading edit axis: latents2 (E, 2, h, w, 4),
context4 (E, 4, 77, D), mask sets with an edit axis, (E,) loss weights and
an (E, ...) SGD state.
"""

from __future__ import annotations

import logging
import math
from typing import Dict

import numpy as np
import torch

from portbench.reference.gd.config import EditConfig
from portbench.reference.gd.core import edit_attention, edit_state, optimization
from portbench.reference.gd.core import scheduler as sched
from portbench.reference.gd.core.pipeline import Pipeline
from portbench.reference.gd.ops import image as image_ops
from portbench.reference.gd.ops import splat as splat_ops
from portbench.reference.gd.ops import transform_field as tf_ops

log = logging.getLogger(__name__)

def _attention_resolutions(latent_size: int) -> tuple:
    return tuple(latent_size // (2 ** i) for i in range(4))


class EditSession:
    """The reference's step functions for one (pipeline, config) pair."""

    def __init__(self, pipeline: Pipeline, cfg: EditConfig):
        self.pipeline = pipeline
        self.cfg = cfg
        self.device = pipeline.device
        self.mode = "remover" if cfg.edit_type == "geometry_remover" else "editor"

    # ------------------------------------------------------------------ setup
    def _preprocess(self, image, depth, image_mask, transform):
        cfg = self.cfg
        tf = tf_ops.build_transform_field(
            image, depth, image_mask, transform, focal_length=cfg.focal_length,
            splat_radius=cfg.splat.radius, splat_tau=cfg.splat.tau, z_beta=cfg.splat.z_beta,
        )
        amodal = image_ops.erode(tf.amodal_mask, cfg.amodal_erode)  # editor.py:633
        masks = edit_state.build_mask_sets(
            image_mask, tf.coords, amodal,
            resolutions=_attention_resolutions(self.pipeline.latent_size), mode=self.mode,
            splat_radius=cfg.splat.radius, splat_tau=cfg.splat.tau, z_beta=cfg.splat.z_beta,
            dilate_remover=cfg.mask_dilate_remover,
        )
        return tf, masks

    def preprocess_batch(self, images, depths, masks, transforms):
        """Transform fields and mask sets of E edits, one edit at a time (the
        JAX package chunks its preprocess to one edit a device: the splat's
        buffers are per edit), then stacked: (E transform fields, mask sets
        with an edit axis)."""
        out = [self._preprocess(*args) for args in zip(images, depths, masks, transforms)]
        return [tf for tf, _ in out], edit_state.stack_mask_sets([ms for _, ms in out])

    def _full_blend(self, masks) -> bool:
        """Warn when an inpaint mask exceeds the removal-loss row budget;
        True when any warped mask exceeds the no-loss blend budget, in which
        case the CFG steps run the exact full-row blend.  A group runs it
        when any of its edits overflows (the fast blend equals it for the
        others); the warnings name the overflowing edits."""
        masks = edit_state.as_batched(masks)
        flagged = [(res, ms) for res, ms in masks.items() if ms.inpaint_overflow is not None]
        if not flagged:
            return False
        vals = torch.stack([torch.stack([ms.inpaint_overflow, ms.warped_overflow], dim=-1)
                            for _, ms in flagged]).tolist()      # (res, E, 2)
        group = len(vals[0]) > 1
        full_blend = False
        for (res, _), per_edit in zip(flagged, vals):
            over = [e for e, (inp_of, _) in enumerate(per_edit) if inp_of > 0.5]
            if over:
                log.warning("inpaint mask at %dx%d exceeds the removal-loss row budget%s; "
                            "overflow rows are dropped and the removal loss is underestimated",
                            res, res, f" in edit(s) {over}" if group else "")
            warped = [e for e, (_, warp_of) in enumerate(per_edit) if warp_of > 0.5]
            if warped and group:
                log.warning("warped mask at %dx%d exceeds the no-loss blend row budget in "
                            "edit(s) %s: the group's CFG steps run the full-row blend",
                            res, res, warped)
            full_blend |= bool(warped)
        return full_blend

    def _state(self, masks, i, weights, radius, tau, use_cfg, compute_losses, warp_mats,
               slim_cfg=False, consume_taps=False, self_window=None, past_obj=None,
               full_blend=False, taps=None):
        return edit_state.make_edit_state(
            self.cfg, masks, cur_step=i, use_cfg=use_cfg, compute_losses=compute_losses,
            weights=weights, splat_radius=radius, splat_tau=tau, warp_mats=warp_mats,
            slim_cfg=slim_cfg, consume_taps=consume_taps, self_window=self_window,
            past_obj_edit=past_obj, full_blend=full_blend, taps=taps,
        )

    # --------------------------------------------------------------- optimize
    def _optimize_step(self, latents2, context4, t, masks, i, weights, radius, tau, lr_eff,
                       sgd_state, warp_mats, self_window, past_obj, fetch_logs: bool = True):
        """Grad-enabled cond-only pass + masked update (editor.py:181-336)
        of every edit of the group.  Returns (latents2, context4, sgd_state,
        logs, taps); logs is a list of E {key: float} dicts (one dict for one
        edit's shapes), or without `fetch_logs` the unfetched (keys,
        (E, 1 + K) device tensor) for `_host_logs`."""
        one, latents2, context4, sgd_state, masks, warp_mats = _as_group(
            latents2, context4, sgd_state, masks, warp_mats)
        cfg = self.cfg
        unet = self.pipeline.unet
        e = latents2.shape[0]
        rec = edit_state.RecordTaps()
        with torch.no_grad():
            unet(latents2[:, 0], t, context4[:, 2], rec)
        state = self._state(masks, i, weights, radius, tau, use_cfg=False, compute_losses=True,
                            warp_mats=warp_mats, consume_taps=True, self_window=self_window,
                            past_obj=past_obj, taps=rec.taps)
        latent_edit = latents2[:, 1].float().detach().requires_grad_(True)
        ctx_edit = context4[:, 3].float().detach().requires_grad_(True)
        acc = edit_state.LossAccumulator()
        per_edit = lambda x: torch.as_tensor(x, dtype=torch.float32, device=self.device).expand(e)
        with torch.enable_grad():
            unet(latent_edit, t, ctx_edit, state, acc)
            loss = per_edit(acc.loss)
            if loss.requires_grad:
                # the edits' losses are independent: the gradient of their
                # sum is each edit's own
                gl, gc = torch.autograd.grad(loss.sum(), [latent_edit, ctx_edit],
                                             allow_unused=True)
            else:
                gl = gc = None
        gl = torch.zeros_like(latent_edit) if gl is None else gl
        gc = torch.zeros_like(ctx_edit) if gc is None else gc

        with torch.no_grad():
            orig_norm = optimization.edit_norms(latents2[:, 1])
            res = self.pipeline.latent_size
            mask_latent = image_ops.binarize(masks[res].mask_new_warped_2d)[..., None]
            new_latent, new_ctx, sgd_state = optimization.apply_update(
                latents2[:, 1], context4[:, 3], gl, gc, lr_eff, mask_latent, sgd_state,
                momentum=cfg.sgd_momentum)
            latents2 = latents2.clone()
            context4 = context4.clone()
            if cfg.optimize_latents:
                latents2[:, 1] = optimization.project_norm(new_latent, orig_norm)
            if cfg.optimize_embeddings:
                context4[:, 3] = new_ctx
            keys = sorted(acc.logs)
            vals = torch.stack([loss.detach()] + [per_edit(acc.logs[k]).detach() for k in keys],
                               dim=1)
        logs = (keys, vals)
        if fetch_logs:
            logs = self._host_logs(keys, vals)
            logs = logs[0] if one else logs
        if one:
            latents2, context4 = latents2[0], context4[0]
            sgd_state = None if sgd_state is None else optimization.SGDState(
                sgd_state.mom_latent[0], sgd_state.mom_context[0])
        return latents2, context4, sgd_state, logs, rec.taps

    @staticmethod
    def _host_logs(keys, vals):
        """E {key: float} logs, normalized per layer, with their "total",
        from an optimize step's (E, 1 + K) device logs: one device-to-host
        copy."""
        logs = []
        for row in vals.tolist():
            logs.append(edit_attention.normalize_logs(dict(zip(keys, row[1:]))))
            logs[-1]["total"] = row[0]
        return logs

    # -------------------------------------------------------------------- cfg
    @torch.no_grad()
    def _cfg_step(self, latents2, context4, t, masks, i, weights, radius, tau, pinned_base,
                  do_replace, warp_mats, self_window, past_obj, full_blend, taps=None):
        """No-grad CFG denoise + pinning + latent warp-replace
        (editor.py:339-403) of every edit of the group.  Without taps: the
        slim 3-stream batch [uncond_edit, cond_base, cond_edit] of each edit
        (the reference's uncond_base stream only feeds output that the
        pinning overwrites).  With the same step's taps: 2 streams
        [uncond_edit, cond_edit] of each edit, the taps standing in for
        cond_base's k/v.  pinned_base holds each edit's base latent."""
        one, latents2, context4, _, masks, warp_mats = _as_group(
            latents2, context4, None, masks, warp_mats)
        cfg = self.cfg
        e = latents2.shape[0]
        state = self._state(masks, i, weights, radius, tau, use_cfg=True, compute_losses=False,
                            warp_mats=warp_mats, slim_cfg=True, consume_taps=taps is not None,
                            self_window=self_window, past_obj=past_obj, full_blend=full_blend,
                            taps=taps)
        lat_e = latents2[:, 1]
        streams = ((lat_e, latents2[:, 0], lat_e), (1, 2, 3)) if taps is None else \
            ((lat_e, lat_e), (1, 3))
        lat_in = torch.stack(streams[0], dim=1)
        ctx_in = context4[:, list(streams[1])]
        eps = self.pipeline.unet(lat_in.reshape(-1, *lat_in.shape[2:]), t,
                                 ctx_in.reshape(-1, *ctx_in.shape[2:]), state)
        eps = eps.reshape(e, -1, *eps.shape[1:])
        eps_g = eps[:, 0] + cfg.guidance_scale * (eps[:, -1] - eps[:, 0])
        out = self._finish_cfg(state, masks, eps_g, lat_e, t, pinned_base.reshape(lat_e.shape),
                               do_replace)
        return out[0] if one else out

    def _finish_cfg(self, state, masks, eps_g, lat_e, t, pinned_base, do_replace):
        """DDIM step on the edit streams (E, h, w, 4), base-trajectory
        pinning (editor.py:375-377) and, in editor mode, the hard latent
        warp-replace while i < latent_replace * T (editor.py:382-399).
        Returns (E, 2, h, w, 4)."""
        new_edit = sched.ddim_step(self.pipeline.schedule, eps_g, t, lat_e,
                                   self.cfg.num_ddim_steps)
        base = pinned_base.reshape(new_edit.shape)
        if do_replace and self.mode == "editor":
            res = self.pipeline.latent_size
            warped = splat_ops.apply_warp_matrix(state.warp_mats[res], base)
            i_mask = image_ops.binarize(masks[res].mask_new_warped_2d)[..., None]
            new_edit = new_edit * (1.0 - i_mask) + i_mask * warped
        return torch.stack([base, new_edit], dim=1)

    # ------------------------------------------------------------------- run


def _as_group(latents2, context4, sgd_state, masks, warp_mats):
    """The step functions' arguments with the edit axis: one edit's
    (2, h, w, 4) latents, (4, 77, D) embeddings, SGD state, mask sets and
    warp operators become a group of one.  Returns (one, latents2,
    context4, sgd_state, masks, warp_mats), `one` when they came without
    it."""
    if latents2.dim() == 5:
        return False, latents2, context4, sgd_state, masks, warp_mats
    if sgd_state is not None:
        sgd_state = optimization.SGDState(sgd_state.mom_latent[None], sgd_state.mom_context[None])
    if not edit_state.is_batched(masks):
        masks = edit_state.stack_mask_sets([masks])
        warp_mats = None if warp_mats is None else {r: w[None] for r, w in warp_mats.items()}
    return True, latents2[None], context4[None], sgd_state, masks, warp_mats


def splat_schedule(cfg: EditConfig):
    """Each step's splat radius and tau, with the reference's int() radius
    floor (editor.py:154-156)."""
    radius, tau = [], []
    r_, tau_ = float(cfg.splat.radius), float(cfg.splat.tau)
    for _ in range(cfg.num_ddim_steps):
        r_ = max(1, int(r_ * cfg.splat.radius_decay))
        tau_ = max(tau_ * cfg.splat.tau_decay, cfg.splat.tau_floor)
        radius.append(r_)
        tau.append(float(np.float32(tau_)))
    return radius, tau


def step_plan(cfg: EditConfig, i: int) -> Dict[str, object]:
    """What the edit loop hands step i: its timestep, whether it optimizes,
    the phase flags, the splat radius and tau, the learning rate, the step
    whose radius and tau build the warp operators (past the optimize and
    latent-replace windows, the tail's first step), whether it replaces
    the latent inside the warped mask, and the inversion step it pins."""
    n = cfg.num_ddim_steps
    optimize_frac = min(cfg.optimize_steps, max(cfg.self_replace_steps, cfg.cross_replace_steps))
    last_opt = max([j for j in range(n)
                    if j < optimize_frac * n and j % cfg.skip_optim_steps == 0] + [-1])
    tail_start = max(last_opt + 1, int(math.ceil(cfg.latent_replace * n)))
    radius, tau = splat_schedule(cfg)
    wm_i = min(i, tail_start) if tail_start < n else i
    lr_step = 0 if cfg.use_optimizer else i
    return dict(
        t=int(sched.timesteps(n, 1000)[i]),
        optimize=(i < optimize_frac * n and i % cfg.skip_optim_steps == 0
                  and i >= cfg.fast_start_steps * n),
        self_window=i < int(n * cfg.self_replace_steps),
        past_obj=i >= int(n * cfg.obj_edit_step),
        radius=radius[i], tau=tau[i], warp_radius=radius[wm_i], warp_tau=tau[wm_i],
        lr=optimization.effective_lr(cfg.lr, lr_step, cfg.skip_optim_steps, n),
        replace=i < cfg.latent_replace * n, pinned=n - 1 - i,
    )
