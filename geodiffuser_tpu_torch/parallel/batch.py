"""Lockstep multi-edit batch on one card: the port of
`geodiffuser_tpu/parallel/batch.py`.

E independent edits of one edit type advance through the same DDIM steps
together on the session's card, through the loop that runs one edit
(`EditSession._edit_loop`).  Every per-edit tensor carries a leading edit
axis (latents, embeddings, mask sets, warp operators, SGD state, loss
weights), and each pass makes one UNet call for the whole group: the taps
pass E streams, the differentiated edit pass E, a slim CFG step 3E and a
CFG step that reuses the taps 2E.  Each flash and removal-correlation call
takes the group in one launch, so a group launches as many kernels as one
edit.  Step-shared values (step, timestep, splat radius and tau, the
self-attention window and the obj-edit phase) are taken once a step.  What
the group adds to `EditSession.run` is its preprocessing, its inversion
and cache, and each edit's post-processing.

One card holds the whole group: the JAX package's mesh, its placement of
edits across chips and `aot_compile_check` (an XLA compile of the sharded
programs) have no counterpart here.

The reference for each edit of a group is `EditSession.run` of that edit.
The JAX `run_batch` departs from the JAX sequential run in three places,
and the port repeats none of them:
 * stitch groups take the stitch's adaptive rule (`adaptive_step_stitching`
   on the background-similarity log), not the removal rule;
 * an edit whose prompt is the unconditional text is inverted without
   guidance, as `run` inverts it (`cfg_free`);
 * the fast start (`fast_start_steps > 0`, with its first-optimize inner
   loop) and null-text inversion (`perform_inversion`) are refused with a
   ValueError rather than silently changed.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from geodiffuser_tpu_torch.core import inversion
from geodiffuser_tpu_torch.core.editor import EditSession, logs_of_edit
from geodiffuser_tpu_torch.ops import image as image_ops
from geodiffuser_tpu_torch.utils import exp_io


@dataclasses.dataclass
class BatchEditResult:
    images: np.ndarray                 # (E, 2, H, W, 3) uint8: [reconstruction, edit]
    edited_images: List[np.ndarray]    # E x (H, W, 3) uint8, histogram-matched
    loss_log: Dict[int, Dict[str, np.ndarray]]     # per step, (E,) arrays
    timings: Dict[str, float]
    weight_log: Optional[Dict[int, Dict[str, np.ndarray]]] = None   # per step, (E,)
    latents: Optional[torch.Tensor] = None         # (E, 2, h, w, 4) final latents
    warped_previews: Optional[np.ndarray] = None   # (E, H, W, 3) uint8

    def edit_logs(self, e: int):
        """Edit e's (loss_log, weight_log) as `EditResult` holds one edit's."""
        return logs_of_edit(self.loss_log, e), logs_of_edit(self.weight_log or {}, e)


class ShardedEditSession(EditSession):
    """An EditSession that runs groups of E edits at once on its card (the
    JAX name is kept: there the group is sharded over chips)."""

    def _invert_group(self, latent0, ctx_uncond, ctx_cond, prompts):
        """DDIM inversion of the group, (T+1, E, h, w, 4): one call for the
        edits inverted with guidance and one for those whose prompt is the
        unconditional text, which `run` inverts without it."""
        cfg = self.cfg
        free = [p == cfg.uncond_text for p in prompts]
        out = [None] * len(prompts)
        for flag in sorted(set(free)):
            idx = [j for j, f in enumerate(free) if f == flag]
            lat, _ = inversion.ddim_invert(
                self.pipeline, latent0[idx], ctx_uncond[idx], ctx_cond[idx],
                guidance_scale=cfg.guidance_scale, num_steps=cfg.num_ddim_steps, cfg_free=flag)
            for pos, j in enumerate(idx):
                out[j] = lat[:, pos]
        return torch.stack(out, dim=1)

    def run_batch(self, images: np.ndarray, depths: np.ndarray, masks_in: np.ndarray,
                  transforms: np.ndarray, prompts: Optional[Sequence[str]] = None,
                  exp_folders: Optional[Sequence[str]] = None) -> BatchEditResult:
        """E edits in lockstep: images (E, H, W, 3) (uint8 or [0, 1]),
        depths (E, H, W), masks (E, H, W), transforms (E, 4, 4).  With
        `cache_inversion` and `exp_folders`, each folder's inversion cache
        is read and, when any is missing, the whole group is inverted and
        every folder's cache written (all or nothing, as the JAX package)."""
        cfg = self.cfg
        if cfg.perform_inversion:
            raise ValueError("run_batch does not run null-text inversion (perform_inversion); "
                             "run these edits one at a time with EditSession.run")
        if cfg.fast_start_steps > 0.0:
            raise ValueError("run_batch does not run the fast start (fast_start_steps > 0); "
                             "run these edits one at a time with EditSession.run")
        dev = self.device
        e = len(images)
        prompts = list(prompts) if prompts is not None else [""] * e
        timings: Dict[str, float] = {}
        t_start = time.time()

        images_f = np.asarray(images)
        images_f = (images_f.astype(np.float32) / 255.0 if images_f.dtype == np.uint8
                    else images_f.astype(np.float32))
        f32 = dict(dtype=torch.float32, device=dev)
        image_t = torch.as_tensor(images_f, **f32)
        mask_t = image_ops.binarize(torch.as_tensor(np.asarray(masks_in), **f32))
        tfs, masks = self.preprocess_batch(image_t, torch.as_tensor(np.asarray(depths), **f32),
                                           mask_t, torch.as_tensor(np.asarray(transforms), **f32))
        full_blend = self._full_blend(masks)
        # each distinct prompt encoded once (a group's edits often share one)
        distinct = list(dict.fromkeys(prompts))
        ctx_cond = self.pipeline.encode_text(distinct)[[distinct.index(p) for p in prompts]]
        ctx_uncond = self.pipeline.encode_text([cfg.uncond_text]).expand(e, -1, -1)
        latent0 = self.pipeline.encode_images(image_t)
        self._sync()
        timings["preprocess"] = time.time() - t_start

        t_inv = time.time()
        all_latents = keys = None
        if cfg.cache_inversion and exp_folders:
            keys = [self.inversion_key(images_f[j], prompts[j]) for j in range(e)]
            cached = [exp_io.load_inversion(f, k) for f, k in zip(exp_folders, keys)]
            if all(c is not None for c in cached):
                all_latents = torch.as_tensor(np.concatenate(cached, axis=1), **f32)
        if all_latents is None:
            all_latents = self._invert_group(latent0, ctx_uncond, ctx_cond, prompts)
            if keys is not None:
                host = all_latents.cpu().numpy()
                for j, folder in enumerate(exp_folders):
                    exp_io.save_inversion(folder, keys[j], host[:, j:j + 1])
        self._sync()
        timings["inversion"] = time.time() - t_inv

        t_loop = time.time()
        latents2, loss_log, weight_log = self._edit_loop(all_latents, ctx_uncond, ctx_cond,
                                                         masks, full_blend)
        self._sync()
        timings["edit_loop"] = time.time() - t_loop

        t_post = time.time()
        images_out, edited, warped_u8 = self._decode_post(latents2, images_f,
                                                          mask_t.cpu().numpy(), masks, tfs)
        timings["decode_post"] = time.time() - t_post
        timings["total"] = time.time() - t_start
        return BatchEditResult(images=images_out, edited_images=edited, loss_log=loss_log,
                               timings=timings, weight_log=weight_log, latents=latents2,
                               warped_previews=warped_u8)
