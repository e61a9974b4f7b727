"""Random model weights from a seed, made on the device in one call.

Both sides take their weights from here: the program's modules in the type
they are served in, the reference's in float32.  Every random leaf is cut
from one `torch.rand` draw of a generator on the device, in bfloat16, so the
same seed gives the reference exactly the program's bf16 values.  The
distribution is PyTorch's default initialisation of each module type:
Linear and Conv2d weights and biases U(-1, 1) / sqrt(fan_in), embeddings
with unit variance, norms' scale 1 and shift 0.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn as nn

NORMS = (nn.GroupNorm, nn.LayerNorm)


def _leaves(module: nn.Module):
    """(name, parameter, bound, constant) of every parameter, sorted by
    name: a random leaf has a bound, a norm's scale the constant 1.0 and its
    shift 0.0."""
    out = []
    for mname, m in module.named_modules():
        own = dict(m.named_parameters(recurse=False))
        if not own:
            continue
        if isinstance(m, NORMS):
            out += [(f"{mname}.{n}", p, None, 1.0 if n == "weight" else 0.0)
                    for n, p in own.items()]
        elif isinstance(m, nn.Embedding):
            out.append((f"{mname}.weight", m.weight, math.sqrt(3.0), None))
        elif isinstance(m, (nn.Linear, nn.Conv2d)):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            out += [(f"{mname}.{n}", p, bound, None) for n, p in own.items()]
        else:
            raise TypeError(f"no initialisation rule for {type(m).__name__} ({mname})")
    if list(module.buffers()):
        raise TypeError("modules with buffers are not filled by this initialisation")
    return sorted(out, key=lambda leaf: leaf[0])


@torch.no_grad()
def fill(modules: Dict[str, nn.Module], seed: int, device) -> None:
    """Fill `modules` ({name: module}, built on the meta device or anywhere
    and moved to `device` with `to_empty`) from `seed`."""
    leaves = [leaf for name in sorted(modules) for leaf in _leaves(modules[name])]
    total = sum(p.numel() for _, p, bound, _ in leaves if bound is not None)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.rand(total, generator=gen, device=device, dtype=torch.bfloat16)
    flat.mul_(2.0).sub_(1.0)
    at = 0
    for _, p, bound, const in leaves:
        if bound is None:
            p.fill_(const)
            continue
        n = p.numel()
        p.copy_((flat[at:at + n] * bound).view(p.shape))
        at += n


def build(modules: Dict[str, type], args, dtype: torch.dtype, seed: int, device):
    """{name: cls(args)} built on the meta device, given `dtype`, moved to
    `device` without initialisation, filled from `seed`, in eval mode with
    no gradients."""
    with torch.device("meta"):
        built = {name: cls(args) for name, cls in modules.items()}
    for m in built.values():
        m.to(dtype).to_empty(device=device).eval().requires_grad_(False)
    fill(built, seed, device)
    return built
