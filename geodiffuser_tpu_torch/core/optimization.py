"""Latent/embedding update rules and the adaptive loss-weight schedule.

Counterpart of `geodiffuser_tpu/core/optimization.py` (reference
optimization.py): the masked asymmetric / SGD-momentum update of the edit
latent and conditional embedding, and the host-side adaptive removal
weight (for the stitch, the background-similarity weight).  Momentum is
carried across steps (the JAX package's fix of the reference defect,
PARITY.md 2.1).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import torch


def effective_lr(lr: float, step: int, skip_optim_steps: int, num_ddim_steps: int) -> float:
    """lr * (50 - i) * skip * (50 / T) (editor.py:207; both 50s hardcoded)."""
    return lr * (50.0 - step) * skip_optim_steps * (50.0 / (num_ddim_steps + 1e-8))


@dataclasses.dataclass
class SGDState:
    mom_latent: torch.Tensor
    mom_context: torch.Tensor


def init_sgd_state(latent_edit: torch.Tensor, ctx_edit: torch.Tensor) -> SGDState:
    return SGDState(torch.zeros_like(latent_edit), torch.zeros_like(ctx_edit))


def apply_update(latent_edit, ctx_edit, grad_latent, grad_ctx, step_size: float,
                 mask_warped: Optional[torch.Tensor], sgd: Optional[SGDState],
                 momentum: float = 0.9) -> Tuple[torch.Tensor, torch.Tensor, Optional[SGDState]]:
    """One update: (1 + mask) * step * grad on the latent (2x inside the
    warped mask), plain step on the embedding; SGD momentum when `sgd` is
    given; non-finite grads zeroed and non-finite results rejected
    (optimization.py:196-247)."""
    gl = torch.nan_to_num(grad_latent, nan=0.0, posinf=0.0, neginf=0.0)
    gc = torch.nan_to_num(grad_ctx, nan=0.0, posinf=0.0, neginf=0.0)
    scale = 1.0 if mask_warped is None else (1.0 + mask_warped)
    step = torch.tensor(step_size, dtype=torch.float32)
    if sgd is None:
        new_latent = latent_edit - step * scale * gl
        new_ctx = ctx_edit - step * gc
        new_state = None
    else:
        ml = momentum * sgd.mom_latent + gl
        mc = momentum * sgd.mom_context + gc
        new_latent = latent_edit - step * scale * ml
        new_ctx = ctx_edit - step * mc
        new_state = SGDState(ml, mc)
    new_latent = torch.where(torch.isfinite(new_latent), new_latent, latent_edit)
    new_ctx = torch.where(torch.isfinite(new_ctx), new_ctx, ctx_edit)
    return new_latent, new_ctx, new_state


def project_norm(latent_edit: torch.Tensor, target_norm: torch.Tensor) -> torch.Tensor:
    """Re-project to the pre-update Frobenius norm (editor.py:312-316)."""
    cur = torch.sqrt(torch.sum(latent_edit * latent_edit) + 1e-12)
    return latent_edit * target_norm / cur


WeightTable = Dict[str, Dict[str, float]]


def _clone(w: Mapping[str, Mapping[str, float]]) -> WeightTable:
    return {b: dict(t) for b, t in w.items()}


def adaptive_step(weights: WeightTable, defaults: Mapping[str, Mapping[str, float]], step: int,
                  skip_optim_steps: int, num_ddim_steps: int, logged_self_removal: float,
                  edit_type: str = "geometry_editor",
                  removal_loss_value: float = -1.5) -> WeightTable:
    """Exponential expected-loss targeting of the removal weight
    (optimization.py:7-105); phases at 40% and 80% of the steps."""
    w = _clone(weights)
    frac = step / num_ddim_steps
    down = 2.0 if edit_type == "geometry_editor" else 2.5
    if frac < 0.4:
        remaining = int((0.4 - frac) * num_ddim_steps / skip_optim_steps)
        expected = removal_loss_value / (1.25 ** remaining)
        if expected < logged_self_removal:
            w["self"]["removal"] *= 1.3
        elif 2.5 * expected > logged_self_removal:
            w["self"]["removal"] /= down
    elif frac < 0.8:
        if (removal_loss_value - 0.3) < logged_self_removal:
            w["self"]["removal"] *= 2.0
        else:
            w = _clone(defaults)
    else:
        w = _clone(defaults)
    return w


def adaptive_step_stitching(weights: WeightTable, defaults: Mapping[str, Mapping[str, float]],
                            step: int, skip_optim_steps: int, num_ddim_steps: int,
                            logged_self_sim: float) -> WeightTable:
    """Exponential expected-loss targeting of the background-similarity
    weight (optimization.py:109-162); phases at 40% and 70% of the steps.
    The stitch runs the editor's losses, so the key is `sim`."""
    w = _clone(weights)
    frac = step / num_ddim_steps
    if frac < 0.4:
        remaining = int((0.4 - frac) * num_ddim_steps / skip_optim_steps)
        expected = 0.18 / (1.01 ** remaining)
        if expected < logged_self_sim:
            w["self"]["sim"] *= 1.1
        elif 2.5 * expected > logged_self_sim:
            w["self"]["sim"] /= 2.5
    elif frac < 0.7:
        if logged_self_sim > 0.2:
            w["self"]["sim"] *= 1.1
        else:
            w = _clone(defaults)
    else:
        w = _clone(defaults)
    return w
