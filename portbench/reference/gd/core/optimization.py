"""Latent/embedding update rules.

Counterpart of `geodiffuser_tpu/core/optimization.py` (reference
optimization.py): the masked asymmetric / SGD-momentum update of the edit
latent and conditional embedding.  Momentum is carried across steps (the
JAX package's fix of the reference defect, PARITY.md 2.1).  The host-side
adaptive loss weights are the program's: the benchmark hands the reference
the weights that the program's captured step used.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


def effective_lr(lr: float, step: int, skip_optim_steps: int, num_ddim_steps: int) -> float:
    """lr * (50 - i) * skip * (50 / T) (editor.py:207; both 50s hardcoded)."""
    return lr * (50.0 - step) * skip_optim_steps * (50.0 / (num_ddim_steps + 1e-8))


@dataclasses.dataclass
class SGDState:
    mom_latent: torch.Tensor
    mom_context: torch.Tensor


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


def edit_norms(latent_edit: torch.Tensor) -> torch.Tensor:
    """Frobenius norm of each edit's latent: (E, ...) -> (E,)
    (generic_torch.py:87-88 per edit)."""
    return torch.sqrt(torch.sum(latent_edit * latent_edit,
                                dim=tuple(range(1, latent_edit.dim()))) + 1e-12)


def project_norm(latent_edit: torch.Tensor, target_norm: torch.Tensor) -> torch.Tensor:
    """Re-project each edit's latent (E, ...) to its pre-update Frobenius
    norm, target_norm (E,) (editor.py:312-316)."""
    tail = (1,) * (latent_edit.dim() - 1)
    return (latent_edit * target_norm.reshape(-1, *tail)
            / edit_norms(latent_edit).reshape(-1, *tail))
