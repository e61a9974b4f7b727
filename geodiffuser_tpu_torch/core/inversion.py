"""DDIM inversion, reconstruction and null-text optimization: counterpart
of `geodiffuser_tpu/core/inversion.py` (`ddim_invert`, reference
NullInversion.ddim_loop, inversion.py:131-196; `reconstruct`;
`null_text_optimization`, inversion.py:213-259) as Python loops."""

from __future__ import annotations

from typing import Tuple

import torch

from geodiffuser_tpu_torch.core import scheduler as sched
from geodiffuser_tpu_torch.core.pipeline import Pipeline
from geodiffuser_tpu_torch.utils.profiling import annotate


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
    kind = "kind=cfg_free" if cfg_free else "kind=cfg"
    for k, t in enumerate(ts):
        t = int(t)
        with annotate("gd.inversion.step", f"step={k} {kind}"):
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


@torch.no_grad()
def reconstruct(pipeline: Pipeline, latent_T: torch.Tensor, context_uncond: torch.Tensor,
                context_cond: torch.Tensor, guidance_scale: float, num_steps: int) -> torch.Tensor:
    """CFG DDIM sampling from an inverted latent (S0, h, w, 4) back to t=0:
    the invert -> reconstruct round trip of the scheduler."""
    ts = sched.timesteps(num_steps, pipeline.schedule.num_train_timesteps)
    context = torch.cat([context_uncond, context_cond], dim=0)
    s0 = latent_T.shape[0]
    x = latent_T.float()
    for t in ts:
        t = int(t)
        eps = pipeline.unet(torch.cat([x, x], dim=0), t, context)
        eps_u, eps_c = eps[:s0], eps[s0:]
        eps_g = eps_u + guidance_scale * (eps_c - eps_u)
        x = sched.ddim_step(pipeline.schedule, eps_g, t, x, num_steps)
    return x


# optax.adam's defaults
ADAM_B1, ADAM_B2, ADAM_EPS, ADAM_EPS_ROOT = 0.9, 0.999, 1e-8, 0.0


class _Adam:
    """optax.adam(lr) on one tensor, in optax's order of operations."""

    def __init__(self, lr: float, like: torch.Tensor):
        self.lr = lr
        self.mu = torch.zeros_like(like)
        self.nu = torch.zeros_like(like)
        self.count = 0

    def step(self, param: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
        self.count += 1
        self.mu = (1 - ADAM_B1) * grad + ADAM_B1 * self.mu
        self.nu = (1 - ADAM_B2) * (grad * grad) + ADAM_B2 * self.nu
        mu_hat = self.mu / (1 - ADAM_B1 ** self.count)
        nu_hat = self.nu / (1 - ADAM_B2 ** self.count)
        return param + mu_hat / (torch.sqrt(nu_hat + ADAM_EPS_ROOT) + ADAM_EPS) * -self.lr


def null_text_optimization(pipeline: Pipeline, all_latents: torch.Tensor,
                           context_uncond: torch.Tensor, context_cond: torch.Tensor,
                           guidance_scale: float, num_steps: int, num_inner_steps: int = 10,
                           early_stop_eps: float = 1e-5, lr: float = 1e-2) -> torch.Tensor:
    """Per-timestep null-text (unconditional embedding) optimization
    (reference NullInversion.null_optimization, inversion.py:213-259): for
    each denoising timestep i, Adam with lr * (1 - i/100), its state fresh
    at each timestep, steers the uncond embedding (carried across timesteps)
    so that the CFG DDIM step reproduces the stored inversion trajectory;
    the inner loop stops once the loss falls below eps + i * 2e-5.  Its
    gradient runs through the UNet's backward.  Returns the (T, S0, 77, D)
    optimized uncond embeddings, one per timestep."""
    ts = sched.timesteps(num_steps, pipeline.schedule.num_train_timesteps)
    unet = pipeline.unet

    def ddim_from(uncond, latent_cur, eps_cond, t):
        eps_u = unet(latent_cur, t, uncond)
        eps = eps_u + guidance_scale * (eps_cond - eps_u)
        return sched.ddim_step(pipeline.schedule, eps, t, latent_cur, num_steps)

    uncond = context_uncond.float()
    latent_cur = all_latents[-1]
    out = []
    for i, t in enumerate(ts):
        t = int(t)
        latent_prev = all_latents[num_steps - 1 - i]
        with torch.no_grad():
            eps_cond = unet(latent_cur, t, context_cond)
        adam = _Adam(lr * (1.0 - i / 100.0), uncond)
        for _ in range(num_inner_steps):
            u = uncond.detach().requires_grad_(True)
            with torch.enable_grad():
                loss = torch.mean((ddim_from(u, latent_cur, eps_cond, t) - latent_prev) ** 2)
                (grad,) = torch.autograd.grad(loss, u)
            uncond = adam.step(uncond, grad)
            if float(loss.detach()) < early_stop_eps + i * 2e-5:
                break
        out.append(uncond)
        with torch.no_grad():
            latent_cur = ddim_from(uncond, latent_cur, eps_cond, t)
    return torch.stack(out, dim=0)
