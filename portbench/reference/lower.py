"""The control: the reference computed one precision below the
configuration's bfloat16, as an fp8 path computes it (the usual fp8
recipe: e4m3 weights and activations into every matmul and convolution,
e5m2 gradients out of them, sums in float32)."""

from __future__ import annotations

import torch
import torch.nn as nn

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _round(x: torch.Tensor, fmt: torch.dtype, largest: float) -> torch.Tensor:
    """x rounded to `fmt` with one scale for the tensor (its largest
    magnitude at the format's largest value), in x's type."""
    scale = x.detach().abs().amax().float().clamp_min(1e-30) / largest
    return ((x.float() / scale).to(fmt).float() * scale).to(x.dtype)


def round_e4m3(x: torch.Tensor) -> torch.Tensor:
    return _round(x, torch.float8_e4m3fn, E4M3_MAX)


def round_e5m2(x: torch.Tensor) -> torch.Tensor:
    return _round(x, torch.float8_e5m2, E5M2_MAX)


class _Input(torch.autograd.Function):
    """e4m3 on the way in; the gradient passes straight through."""

    @staticmethod
    def forward(ctx, x):
        return round_e4m3(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _Output(torch.autograd.Function):
    """The identity on the way out; its gradient rounded to e5m2."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return round_e5m2(g)


def _round_input(module, args):
    return (_Input.apply(args[0]),) + tuple(args[1:])


def _round_grad(module, args, out):
    return _Output.apply(out) if out.requires_grad else out


@torch.no_grad()
def to_fp8_(*modules: nn.Module) -> None:
    """Every Linear and Conv2d of `modules` computes as an fp8 GEMM does:
    its weight rounded to e4m3 once, its input at every call, and the
    gradient of its output rounded to e5m2 before the backward's GEMMs."""
    for module in modules:
        for m in module.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                m.weight.copy_(round_e4m3(m.weight))
                m.register_forward_pre_hook(_round_input)
                m.register_forward_hook(_round_grad)
