"""DDIM and inverse-DDIM as functions of the cumulative alphas.

Counterpart of `geodiffuser_tpu/core/scheduler.py` (reference
inversion.py:47-65, diffusion.py:110): scaled-linear betas, 1000 train steps,
clip_sample=False, set_alpha_to_one=False, leading spacing.  Timesteps are
host integers; the alpha table is a float32 CPU tensor whose 0-dim entries
combine with samples on any device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from portbench.reference.gd.config import SchedulerConfig


class Schedule(NamedTuple):
    alphas_cumprod: torch.Tensor        # (num_train_timesteps,) float32
    final_alpha_cumprod: torch.Tensor   # 0-dim float32: ac[0]
    num_train_timesteps: int


def make_schedule(cfg: SchedulerConfig = SchedulerConfig()) -> Schedule:
    if cfg.beta_schedule == "scaled_linear":
        betas = np.linspace(cfg.beta_start ** 0.5, cfg.beta_end ** 0.5, cfg.num_train_timesteps) ** 2
    elif cfg.beta_schedule == "linear":
        betas = np.linspace(cfg.beta_start, cfg.beta_end, cfg.num_train_timesteps)
    else:
        raise ValueError(cfg.beta_schedule)
    ac = np.cumprod(1.0 - betas)
    final = 1.0 if cfg.set_alpha_to_one else ac[0]
    return Schedule(
        alphas_cumprod=torch.as_tensor(ac, dtype=torch.float32),
        final_alpha_cumprod=torch.tensor(final, dtype=torch.float32),
        num_train_timesteps=cfg.num_train_timesteps,
    )


def timesteps(num_inference_steps: int, num_train_timesteps: int = 1000) -> np.ndarray:
    """Descending sampling timesteps [.., 40, 20, 0] (leading spacing)."""
    ratio = num_train_timesteps // num_inference_steps
    return (np.arange(num_inference_steps) * ratio)[::-1].copy()


def inverse_timesteps(num_inference_steps: int, num_train_timesteps: int = 1000) -> np.ndarray:
    """Ascending inversion timesteps [0, 20, ..., 980]."""
    ratio = num_train_timesteps // num_inference_steps
    return np.arange(num_inference_steps) * ratio


def _alpha_at(schedule: Schedule, t: int) -> torch.Tensor:
    """alphas_cumprod[t], with t < 0 mapping to final_alpha_cumprod."""
    if t < 0:
        return schedule.final_alpha_cumprod
    return schedule.alphas_cumprod[min(t, schedule.num_train_timesteps - 1)]


def _step(a_from, a_to, eps, sample):
    eps32 = eps.float()
    x32 = sample.float()
    x0 = (x32 - torch.sqrt(1.0 - a_from) * eps32) / torch.sqrt(a_from)
    out = torch.sqrt(a_to) * x0 + torch.sqrt(1.0 - a_to) * eps32
    return out.to(sample.dtype)


def ddim_step(schedule: Schedule, eps: torch.Tensor, t: int, sample: torch.Tensor,
              num_inference_steps: int) -> torch.Tensor:
    """One denoising step x_t -> x_{t-ratio}, eta=0 (inversion.py:47-55)."""
    ratio = schedule.num_train_timesteps // num_inference_steps
    return _step(_alpha_at(schedule, int(t)), _alpha_at(schedule, int(t) - ratio), eps, sample)


def ddim_inverse_step(schedule: Schedule, eps: torch.Tensor, t: int, sample: torch.Tensor,
                      num_inference_steps: int) -> torch.Tensor:
    """One inversion step from noise level t - ratio to t (inversion.py:57-65)."""
    ratio = schedule.num_train_timesteps // num_inference_steps
    t_from = min(int(t) - ratio, schedule.num_train_timesteps - 1)
    return _step(_alpha_at(schedule, t_from), _alpha_at(schedule, int(t)), eps, sample)
