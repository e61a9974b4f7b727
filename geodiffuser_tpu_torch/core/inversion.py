"""DDIM inversion: counterpart of `geodiffuser_tpu/core/inversion.py:ddim_invert`
(reference NullInversion.ddim_loop, inversion.py:131-196) as a Python loop."""

from __future__ import annotations

from typing import Tuple

import torch

from geodiffuser_tpu_torch.core import scheduler as sched
from geodiffuser_tpu_torch.core.pipeline import Pipeline


@torch.no_grad()
def ddim_invert(pipeline: Pipeline, latent: torch.Tensor, context_uncond: torch.Tensor,
                context_cond: torch.Tensor, guidance_scale: float, num_steps: int,
                cfg_free: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (all_latents (num_steps+1, S0, h, w, 4), all_noise_cond
    (num_steps, S0, h, w, 4)); all_latents[0] is the clean latent and
    all_latents[num_steps] the inverted x_T.  Guidance is applied during
    inversion (inversion.py:174-187); cfg_free=True is the exact fast path
    for prompt == uncond_text."""
    ts = sched.inverse_timesteps(num_steps, pipeline.schedule.num_train_timesteps)
    context = torch.cat([context_uncond, context_cond], dim=0)
    s0 = latent.shape[0]
    x = latent.float()
    lats, noise = [x], []
    for t in ts:
        t = int(t)
        if cfg_free:
            eps_c = pipeline.unet(x, t, context[s0:])
            eps_g = eps_c
        else:
            eps = pipeline.unet(torch.cat([x, x], dim=0), t, context)
            eps_u, eps_c = eps[:s0], eps[s0:]
            eps_g = eps_u + guidance_scale * (eps_c - eps_u)
        x = sched.ddim_inverse_step(pipeline.schedule, eps_g, t, x, num_steps)
        lats.append(x)
        noise.append(eps_c)
    return torch.stack(lats, dim=0), torch.stack(noise, dim=0)
