"""Plain attention: a frozen copy of the port's plain version
(`geodiffuser_tpu_torch/kernels/flash_attention.py:attention_plain`), the
reference's only attention.  Operands are (..., L, D)."""

from __future__ import annotations

import torch


def attention_plain(q, k, v, scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v with float32 logits and softmax, the
    probabilities cast to v's type before the product (the JAX package's
    vanilla_attention).  Differentiable by autograd."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(probs.float(), v.float()).to(v.dtype)
