"""The GeoDiffuser edit loop and its top-level API, editor mode.

Counterpart of `geodiffuser_tpu/core/editor.py` (reference
`text2image_ldm_stable`, editor.py:65-423, and `perform_geometric_edit`,
editor.py:428-710).  The JAX package's compiled step programs are plain
functions here, run eagerly:

 * optimize steps: a no-grad base pass records per-layer q/k/v taps, a
   differentiated one-stream edit pass consumes them and sums the five
   losses, `torch.autograd.grad` gives the latent/embedding gradients, then
   the masked SGD update and norm projection;
 * CFG steps: a slim 3-stream pass, or a 2-stream pass reusing the same
   step's taps, then the DDIM step, base-trajectory pinning and the latent
   warp-replace;
 * the CFG-only tail past the optimize and latent-replace windows is the
   same CFG step in a loop, with the warp operator of the tail's first step.

The XLA compile machinery of the JAX package (precompile, lowering, the
persistent compile cache) has no counterpart: PyTorch runs eagerly.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import math
import time
from collections import OrderedDict
from typing import Dict, Optional

import numpy as np
import torch

from geodiffuser_tpu_torch.config import EditConfig
from geodiffuser_tpu_torch.core import edit_attention, edit_state, inversion, optimization
from geodiffuser_tpu_torch.core import scheduler as sched
from geodiffuser_tpu_torch.core.pipeline import Pipeline, resolve_device
from geodiffuser_tpu_torch.ops import image as image_ops
from geodiffuser_tpu_torch.ops import splat as splat_ops
from geodiffuser_tpu_torch.ops import transform_field as tf_ops

log = logging.getLogger(__name__)


@dataclasses.dataclass
class EditResult:
    images: np.ndarray                 # (2, H, W, 3) uint8: [reconstruction, edit]
    edited_image: np.ndarray           # (H, W, 3) uint8, histogram-matched
    loss_log: Dict[int, Dict[str, float]]
    warped_preview: Optional[np.ndarray] = None
    timings: Optional[Dict[str, float]] = None
    weight_log: Optional[Dict[int, Dict[str, float]]] = None
    latents: Optional[torch.Tensor] = None   # (2, h, w, 4) final [base, edit] latents


def _attention_resolutions(latent_size: int) -> tuple:
    return tuple(latent_size // (2 ** i) for i in range(4))


class EditSession:
    """One (pipeline, config) pair; reuse it across edits to reuse the
    in-memory inversion memo."""

    def __init__(self, pipeline: Pipeline, cfg: EditConfig, device="cuda"):
        dev = resolve_device(device)
        if dev != pipeline.device:
            raise ValueError(f"session device {dev} differs from the pipeline's {pipeline.device}")
        if cfg.edit_type != "geometry_editor":
            raise NotImplementedError(f"{cfg.edit_type} is not ported yet (editor mode only)")
        if (cfg.apply_attention_constraints or cfg.perform_inversion
                or (cfg.fast_start_steps > 0.0 and cfg.num_first_optim_steps > 1)):
            raise NotImplementedError("attention constraints, null-text inversion and the "
                                      "fast-start inner loop are not ported yet")
        self.pipeline = pipeline
        self.cfg = cfg
        self.device = dev
        self.mode = "editor"
        self._inv_mem: "OrderedDict[str, torch.Tensor]" = OrderedDict()
        self._pipe_fp: Optional[str] = None

    # -------------------------------------------------------- inversion memo
    def _pipeline_fingerprint(self) -> str:
        """Config, schedule and a 4-element head of every UNet weight."""
        if self._pipe_fp is None:
            h = hashlib.sha256()
            h.update(repr(self.pipeline.config).encode())
            h.update(str(self.pipeline.image_size).encode())
            h.update(self.pipeline.schedule.alphas_cumprod[:8].double().numpy().tobytes())
            probe = torch.cat([p.reshape(-1)[:4].float() for p in self.pipeline.unet.parameters()])
            h.update(probe.cpu().numpy().tobytes())
            self._pipe_fp = h.hexdigest()[:16]
        return self._pipe_fp

    def inversion_key(self, image_f: np.ndarray, prompt: str) -> str:
        cfg = self.cfg
        h = hashlib.sha256()
        h.update(self._pipeline_fingerprint().encode())
        h.update(np.ascontiguousarray(image_f, np.float32).tobytes())
        for part in (prompt, cfg.uncond_text, repr(cfg.guidance_scale), repr(cfg.num_ddim_steps)):
            h.update(part.encode())
            h.update(b"\x00")
        return h.hexdigest()

    def _inv_cache_put(self, key: str, all_latents: torch.Tensor) -> None:
        self._inv_mem[key] = all_latents
        self._inv_mem.move_to_end(key)
        while len(self._inv_mem) > 4:
            self._inv_mem.popitem(last=False)

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

    def _full_blend(self, masks) -> bool:
        """Warn when an inpaint mask exceeds the removal-loss row budget;
        True when any warped mask exceeds the no-loss blend budget, in which
        case the CFG steps run the exact full-row blend."""
        flagged = [(res, ms) for res, ms in masks.items() if ms.inpaint_overflow is not None]
        if not flagged:
            return False
        vals = torch.stack([torch.stack([ms.inpaint_overflow, ms.warped_overflow])
                            for _, ms in flagged]).tolist()
        full_blend = False
        for (res, _), (inp_of, warp_of) in zip(flagged, vals):
            if inp_of > 0.5:
                log.warning("inpaint mask at %dx%d exceeds the removal-loss row budget; "
                            "overflow rows are dropped and the removal loss is underestimated",
                            res, res)
            full_blend |= warp_of > 0.5
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

    def _phase_flags(self, i: int):
        cfg = self.cfg
        n = cfg.num_ddim_steps
        return i < int(n * cfg.self_replace_steps), i >= int(n * cfg.obj_edit_step)

    # --------------------------------------------------------------- optimize
    def _optimize_step(self, latents2, context4, t, masks, i, weights, radius, tau, lr_eff,
                       sgd_state, warp_mats, self_window, past_obj):
        """Grad-enabled cond-only pass + masked update (editor.py:181-336).
        Returns (latents2, context4, sgd_state, logs, taps)."""
        cfg = self.cfg
        unet = self.pipeline.unet
        rec = edit_state.RecordTaps()
        with torch.no_grad():
            unet(latents2[0][None], t, context4[2][None], rec)
        state = self._state(masks, i, weights, radius, tau, use_cfg=False, compute_losses=True,
                            warp_mats=warp_mats, consume_taps=True, self_window=self_window,
                            past_obj=past_obj, taps=rec.taps)
        latent_edit = latents2[1].float().detach().requires_grad_(True)
        ctx_edit = context4[3].float().detach().requires_grad_(True)
        acc = edit_state.LossAccumulator()
        with torch.enable_grad():
            unet(latent_edit[None], t, ctx_edit[None], state, acc)
            loss = torch.as_tensor(acc.loss, dtype=torch.float32, device=self.device)
            if loss.requires_grad:
                gl, gc = torch.autograd.grad(loss, [latent_edit, ctx_edit], allow_unused=True)
            else:
                gl = gc = None
        gl = torch.zeros_like(latent_edit) if gl is None else gl
        gc = torch.zeros_like(ctx_edit) if gc is None else gc

        with torch.no_grad():
            orig_norm = image_ops.norm_tensor(latents2[1])
            res = self.pipeline.latent_size
            mask_latent = image_ops.binarize(masks[res].mask_new_warped_2d)[..., None]
            new_latent, new_ctx, sgd_state = optimization.apply_update(
                latents2[1], context4[3], gl, gc, lr_eff, mask_latent, sgd_state,
                momentum=cfg.sgd_momentum)
            latents2 = latents2.clone()
            context4 = context4.clone()
            if cfg.optimize_latents:
                latents2[1] = optimization.project_norm(new_latent, orig_norm)
            if cfg.optimize_embeddings:
                context4[3] = new_ctx
            keys = sorted(acc.logs)
            vals = torch.stack([loss.detach()] + [
                torch.as_tensor(acc.logs[k], dtype=torch.float32, device=self.device).detach()
                for k in keys]).tolist()   # one device-to-host copy
        logs = edit_attention.normalize_logs(dict(zip(keys, vals[1:])))
        logs["total"] = vals[0]
        return latents2, context4, sgd_state, logs, rec.taps

    # -------------------------------------------------------------------- cfg
    @torch.no_grad()
    def _cfg_step(self, latents2, context4, t, masks, i, weights, radius, tau, pinned_base,
                  do_replace, warp_mats, self_window, past_obj, full_blend, taps=None):
        """No-grad CFG denoise + pinning + latent warp-replace
        (editor.py:339-403).  Without taps: the slim 3-stream batch
        [uncond_edit, cond_base, cond_edit] (the reference's uncond_base
        stream only feeds output that the pinning overwrites).  With the
        same step's taps: 2 streams [uncond_edit, cond_edit], the taps
        standing in for cond_base's k/v."""
        cfg = self.cfg
        state = self._state(masks, i, weights, radius, tau, use_cfg=True, compute_losses=False,
                            warp_mats=warp_mats, slim_cfg=True, consume_taps=taps is not None,
                            self_window=self_window, past_obj=past_obj, full_blend=full_blend,
                            taps=taps)
        lat_e = latents2[1]
        if taps is None:
            eps = self.pipeline.unet(torch.stack([lat_e, latents2[0], lat_e]), t,
                                     torch.stack([context4[1], context4[2], context4[3]]), state)
            eps_g = eps[0] + cfg.guidance_scale * (eps[2] - eps[0])
        else:
            eps = self.pipeline.unet(torch.stack([lat_e, lat_e]), t,
                                     torch.stack([context4[1], context4[3]]), state)
            eps_g = eps[0] + cfg.guidance_scale * (eps[1] - eps[0])
        return self._finish_cfg(state, masks, eps_g, lat_e, t, pinned_base, do_replace)

    def _finish_cfg(self, state, masks, eps_g, lat_e, t, pinned_base, do_replace):
        """DDIM step on the edit stream, base-trajectory pinning
        (editor.py:375-377) and the hard latent warp-replace while
        i < latent_replace * T (editor.py:382-399)."""
        new_edit = sched.ddim_step(self.pipeline.schedule, eps_g[None], t, lat_e[None],
                                   self.cfg.num_ddim_steps)
        base = pinned_base.reshape(new_edit.shape)
        if do_replace:
            res = self.pipeline.latent_size
            warped = splat_ops.apply_warp_matrix(state.warp_mats[res], base[0])
            i_mask = image_ops.binarize(masks[res].mask_new_warped_2d)[..., None]
            new_edit = (new_edit[0] * (1.0 - i_mask) + i_mask * warped)[None]
        return torch.cat([base, new_edit], dim=0)

    # ------------------------------------------------------------------- run
    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, image: np.ndarray, depth: np.ndarray, image_mask: np.ndarray,
            transform: np.ndarray, prompt: str = "", progress=None) -> EditResult:
        cfg = self.cfg
        dev = self.device
        timings: Dict[str, float] = {}
        t_start = time.time()

        image = np.asarray(image)
        if image.dtype == np.uint8:
            image = image.astype(np.float32) / 255.0
        f32 = dict(dtype=torch.float32, device=dev)
        image_t = torch.as_tensor(image, **f32)
        depth_t = torch.as_tensor(np.asarray(depth), **f32)
        mask_t = image_ops.binarize(torch.as_tensor(np.asarray(image_mask), **f32))
        transform_t = torch.as_tensor(np.asarray(transform), **f32)

        tf, masks = self._preprocess(image_t, depth_t, mask_t, transform_t)
        full_blend = self._full_blend(masks)
        ctx_cond = self.pipeline.encode_text([prompt])
        ctx_uncond = self.pipeline.encode_text([cfg.uncond_text])
        latent0 = self.pipeline.encode_image(image_t)
        self._sync()
        timings["preprocess"] = time.time() - t_start

        t_inv = time.time()
        inv_key = self.inversion_key(image, prompt) if cfg.cache_inversion else None
        all_latents = self._inv_mem.get(inv_key) if inv_key is not None else None
        if all_latents is None:
            all_latents, _ = inversion.ddim_invert(
                self.pipeline, latent0, ctx_uncond, ctx_cond, guidance_scale=cfg.guidance_scale,
                num_steps=cfg.num_ddim_steps, cfg_free=prompt == cfg.uncond_text)
            if inv_key is not None:
                self._inv_cache_put(inv_key, all_latents)
        else:
            self._inv_mem.move_to_end(inv_key)
        self._sync()
        timings["inversion"] = time.time() - t_inv

        t_loop = time.time()
        n = cfg.num_ddim_steps
        x_t = all_latents[-1]
        latents2 = torch.cat([x_t, x_t], dim=0)
        context4 = torch.cat([ctx_uncond, ctx_uncond, ctx_cond, ctx_cond], dim=0).float()
        optimize_frac = min(cfg.optimize_steps, max(cfg.self_replace_steps, cfg.cross_replace_steps))
        defaults = {b: dict(t_) for b, t_ in cfg.resolved_loss_weights().items()}
        weights = {b: dict(t_) for b, t_ in defaults.items()}
        sgd_state = (optimization.init_sgd_state(latents2[1], context4[3])
                     if cfg.use_optimizer else None)
        lr_first = optimization.effective_lr(cfg.lr, 0, cfg.skip_optim_steps, n)
        loss_log: Dict[int, Dict[str, float]] = {}
        weight_log: Dict[int, Dict[str, float]] = {}
        timesteps = sched.timesteps(n, self.pipeline.schedule.num_train_timesteps)

        # splat annealing incl. the reference's int() radius floor (editor.py:154-156)
        radius_sched, tau_sched = [], []
        r_, tau_ = float(cfg.splat.radius), float(cfg.splat.tau)
        for _ in range(n):
            r_ = max(1, int(r_ * cfg.splat.radius_decay))
            tau_ = max(tau_ * cfg.splat.tau_decay, cfg.splat.tau_floor)
            radius_sched.append(r_)
            tau_sched.append(float(np.float32(tau_)))

        def record(i_p, logs_host):
            nonlocal weights
            loss_log[i_p] = logs_host
            if cfg.use_adaptive_optimization:
                weights = optimization.adaptive_step(
                    weights, defaults, i_p, cfg.skip_optim_steps, n, logs_host["self/removal"],
                    cfg.edit_type, cfg.removal_loss_value)
            weight_log[i_p] = {f"{b}/{k_}": float(v_) for b, t_ in weights.items()
                               for k_, v_ in t_.items()}
            if progress is not None:
                progress(i_p / n, desc=f"Editing loss: {logs_host['total']:.4f}")

        last_opt = max([i for i in range(n)
                        if i < optimize_frac * n and i % cfg.skip_optim_steps == 0] + [-1])
        # past both the optimize and latent-replace windows every step is a
        # plain CFG step sharing the warp operator of the tail's first step
        tail_start = max(last_opt + 1, int(math.ceil(cfg.latent_replace * n)))
        wm_cache: Dict = {}
        for i, t in enumerate(timesteps):
            t = int(t)
            win, obj = self._phase_flags(i)
            wm_i = min(i, tail_start) if tail_start < n else i
            wm_key = (radius_sched[wm_i], round(tau_sched[wm_i], 6))
            if wm_key not in wm_cache:
                wm_cache[wm_key] = edit_state.build_warp_matrices(
                    masks, radius_sched[wm_i], tau_sched[wm_i], cfg.splat.z_beta)
            wm = wm_cache[wm_key]
            do_optimize = (i < optimize_frac * n and i % cfg.skip_optim_steps == 0
                           and i >= cfg.fast_start_steps * n)
            taps = None
            if do_optimize:
                lr_eff = (lr_first if cfg.use_optimizer
                          else optimization.effective_lr(cfg.lr, i, cfg.skip_optim_steps, n))
                latents2, context4, sgd_state, logs_host, taps = self._optimize_step(
                    latents2, context4, t, masks, i, weights, radius_sched[i], tau_sched[i],
                    lr_eff, sgd_state, wm, win, obj)
                record(i, logs_host)
            latents2 = self._cfg_step(
                latents2, context4, t, masks, i, weights, radius_sched[i], tau_sched[i],
                all_latents[n - 1 - i], i < cfg.latent_replace * n, wm, win, obj, full_blend,
                taps=taps)
        self._sync()
        timings["edit_loop"] = time.time() - t_loop

        t_post = time.time()
        images = self.pipeline.decode_latents(latents2)
        h_img = images.shape[1]
        res_mask = image_ops.binarize(image_ops.resize_bilinear(
            masks[self.pipeline.latent_size].mask_new_warped_2d, h_img, h_img)).cpu().numpy()
        warped_u8 = torch.round(torch.clamp(tf.warped_preview, 0.0, 1.0) * 255.0
                                ).to(torch.uint8).cpu().numpy()
        edited = self._postprocess(images[-1], image, mask_t.cpu().numpy(), res_mask, warped_u8)
        timings["decode_post"] = time.time() - t_post
        timings["total"] = time.time() - t_start
        return EditResult(images=images, edited_image=edited, loss_log=loss_log,
                          warped_preview=warped_u8, timings=timings, weight_log=weight_log,
                          latents=latents2)

    def _postprocess(self, edited_u8, image_f, mask_np, res_mask, warped_input) -> np.ndarray:
        """Masked histogram matching of the edit against the warp-composited
        input (editor.py:660-694)."""
        image_u8 = np.asarray(np.clip(image_f * 255.0, 0, 255)).astype(np.uint8)
        mask_changed = ((res_mask + mask_np) > 0.5) * 1.0
        mask_bg = ((1.0 - mask_changed) > 0.5) * 1.0
        composite = (mask_bg[..., None] * image_u8 + res_mask[..., None] * warped_input
                     ).astype(np.uint8)
        mask_source = ((res_mask + mask_bg) > 0.5) * 1.0
        return image_ops.masked_histogram_matching(
            edited_u8, composite, mask_source, mask_source).astype(np.uint8)


def perform_geometric_edit(pipeline: Pipeline, image: np.ndarray, depth: np.ndarray,
                           image_mask: np.ndarray, transform: np.ndarray,
                           cfg: Optional[EditConfig] = None, prompt: str = "",
                           session: Optional[EditSession] = None, progress=None,
                           device="cuda") -> EditResult:
    """Top-level programmatic API (reference editor.py:428-710).  Pass a
    session to reuse its inversion memo across edits."""
    cfg = cfg or EditConfig()
    if session is None:
        session = EditSession(pipeline, cfg, device=device)
    return session.run(image, depth, image_mask, transform, prompt=prompt, progress=progress)
