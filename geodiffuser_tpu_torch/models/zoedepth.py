"""ZoeDepth metric depth (metric-bins head over a DPT core) in PyTorch.

Counterpart of `geodiffuser_tpu/models/zoedepth.py` (the reference's
metric-depth backend, get_monocular_ZoeDepth, depth_predictor.py:277-319;
zoedepth/models/zoedepth/zoedepth_v1.py:124-215): a relative-depth DPT core,
a seed bin regressor, per-scale bin attractors and a conditional
log-binomial output distribution whose expectation over the bin centres is
the metric depth.  The single-head model runs over the port's ViT-L/16 DPT
core (`models/midas_dpt.py`); the shipped two-head checkpoint is
`models/zoedepth_nk.py`.  Module names are the published ZoeDepth ones
(`core.core.…`, `seed_bin_regressor._net.N`, `projectors.N._net.N`,
`attractors.N._net.N`, `conditional_log_binomial.mlp.N`).  Maps are NCHW
inside; images NHWC in, (B, H, W) depth out.

The attractors follow a reference defect the JAX package keeps: the layers
call the attractor functions without their configured alpha and gamma
(attractor.py:196-199), so the defaults (300, 2) apply, not the
configuration's 1000.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn as nn

from geodiffuser_tpu_torch.models.depth_anything import resize_align_corners
from geodiffuser_tpu_torch.models.midas_dpt import DPTConfig, DPTLarge


def exp_attractor(dx: torch.Tensor, alpha: float = 300.0, gamma: int = 2) -> torch.Tensor:
    """dc = exp(-alpha * |dx|^gamma) * dx (zoedepth layers/attractor.py)."""
    return torch.exp(-alpha * dx.abs() ** gamma) * dx


def inv_attractor(dx: torch.Tensor, alpha: float = 300.0, gamma: int = 2) -> torch.Tensor:
    """dc = dx / (1 + alpha * dx^gamma)."""
    return dx / (1.0 + alpha * dx ** gamma)


def _resize_to(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return resize_align_corners(x, like.shape[2], like.shape[3])


class SeedBinRegressorUnnormed(nn.Module):
    """1x1-conv MLP -> softplus bin centres (unbounded)."""

    def __init__(self, cin: int, n_bins: int = 64, mlp_dim: int = 256):
        super().__init__()
        self._net = nn.Sequential(nn.Conv2d(cin, mlp_dim, 1), nn.ReLU(),
                                  nn.Conv2d(mlp_dim, n_bins, 1), nn.Softplus())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._net(x)


class Projector(nn.Module):
    def __init__(self, cin: int, out_features: int, mlp_dim: int = 128):
        super().__init__()
        self._net = nn.Sequential(nn.Conv2d(cin, mlp_dim, 1), nn.ReLU(),
                                  nn.Conv2d(mlp_dim, out_features, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._net(x)


class AttractorLayerUnnormed(nn.Module):
    """Moves the bin centres toward predicted attractor points
    (zoedepth layers/attractor.py:138-208), with the attractor function's
    default alpha and gamma (module docstring)."""

    def __init__(self, cin: int, n_bins: int, n_attractors: int = 16, mlp_dim: int = 128,
                 kind: str = "sum", attractor_type: str = "exp"):
        super().__init__()
        self.kind = kind
        self.dist = exp_attractor if attractor_type == "exp" else inv_attractor
        self._net = nn.Sequential(nn.Conv2d(cin, mlp_dim, 1), nn.ReLU(),
                                  nn.Conv2d(mlp_dim, n_attractors, 1), nn.Softplus())

    def forward(self, x: torch.Tensor, b_prev: torch.Tensor, prev_b_embedding=None):
        if prev_b_embedding is not None:
            x = x + _resize_to(prev_b_embedding, x)
        a = self._net(x)                                      # (B, A, H, W)
        b_centers = _resize_to(b_prev, x)                     # (B, n_bins, H, W)
        dx = a[:, :, None] - b_centers[:, None]               # (B, A, n_bins, H, W)
        delta = self.dist(dx)
        delta = delta.sum(1) if self.kind == "sum" else delta.mean(1)
        return b_centers + delta


def _log_binom_host(n: float, k, eps: float = 1e-7) -> np.ndarray:
    """log(nCk) by Stirling (zoedepth layers/dist_layers.py:29-33) in float64
    on the host, rounded to float32: the binomial coefficients over a fixed
    class count are constants, taken from the host as the JAX package takes
    them."""
    n = float(n) + eps
    k = np.asarray(k, np.float64) + eps
    return (n * np.log(n) - k * np.log(k) - (n - k) * np.log(n - k + eps)).astype(np.float32)


class ConditionalLogBinomial(nn.Module):
    """p and t from an MLP over [features | condition]; the output is the
    softmax over the log-binomial pmf at temperature t
    (zoedepth layers/dist_layers.py:36-121), log p and log(1 - p) clipped
    to [log 1e-4, 0]."""

    def __init__(self, cin: int, cond: int, n_classes: int = 64, bottleneck_factor: int = 2,
                 p_eps: float = 1e-4, max_temp: float = 50.0, min_temp: float = 1e-7):
        super().__init__()
        self.n_classes, self.p_eps = n_classes, p_eps
        self.max_temp, self.min_temp = max_temp, min_temp
        hidden = (cin + cond) // bottleneck_factor
        self.mlp = nn.Sequential(nn.Conv2d(cin + cond, hidden, 1), nn.GELU(),
                                 nn.Conv2d(hidden, 4, 1), nn.Softplus())
        self.register_buffer("log_binom", torch.tensor(
            _log_binom_host(n_classes - 1, np.arange(n_classes))), persistent=False)

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        pt = self.mlp(torch.cat([x, cond], dim=1))
        p0 = pt[:, 0] + self.p_eps
        p1 = pt[:, 1] + self.p_eps
        t = pt[:, 2:] + self.p_eps
        t = t[:, 0] / (t[:, 0] + t[:, 1])
        t = (self.max_temp - self.min_temp) * t + self.min_temp
        k = self.n_classes
        k_idx = torch.arange(k, dtype=torch.float32, device=x.device)[:, None, None]
        log_s = torch.log(p0 + p1)
        lo = math.log(1e-4)
        log_pc = torch.clamp(torch.log(p0) - log_s, lo, 0.0)[:, None]
        log_om = torch.clamp(torch.log(p1) - log_s, lo, 0.0)[:, None]
        y = self.log_binom[:, None, None] + k_idx * log_pc + (k - 1 - k_idx) * log_om
        return torch.softmax(y / t[:, None], dim=1)           # (B, K, H, W)


@dataclasses.dataclass(frozen=True)
class ZoeDepthConfig:
    core: DPTConfig = DPTConfig()
    n_bins: int = 64
    bin_embedding_dim: int = 128
    min_depth: float = 1e-3
    max_depth: float = 10.0
    n_attractors: Tuple[int, ...] = (16, 8, 4, 1)
    attractor_kind: str = "mean"
    attractor_type: str = "inv"
    min_temp: float = 0.0212
    max_temp: float = 50.0

    @staticmethod
    def tiny() -> "ZoeDepthConfig":
        return ZoeDepthConfig(core=DPTConfig.tiny(), n_bins=8, bin_embedding_dim=16,
                              n_attractors=(4, 2, 2, 1))


class ZoeDepthCore(DPTLarge):
    """The DPT core returning the metric head's taps: (relative depth, the
    32-channel head activation, layer4_rn's output, [r4, r3, r2, r1])."""

    def forward(self, x: torch.Tensor):
        return self.taps(x)


class MidasCore(nn.Module):
    """ZoeDepth's `core`, which holds the MiDaS model as `core`
    (zoedepth/models/base_models/midas.py)."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.core = model

    def forward(self, x: torch.Tensor):
        return self.core(x)


def attractor_stack(c, n_bins: int) -> nn.ModuleList:
    """The four attractor layers of one metric head (config `c`)."""
    return nn.ModuleList([
        AttractorLayerUnnormed(c.bin_embedding_dim, n_bins, n_attractors=n, kind=c.attractor_kind,
                               attractor_type=c.attractor_type)
        for n in c.n_attractors])


def refine_bins(attractors: nn.ModuleList, embs, b_prev, prev_emb):
    """The attractor stack over the projected r4..r1 embeddings: (the last
    bin centres, the last embedding)."""
    for layer, emb in zip(attractors, embs):
        b_prev = layer(emb, b_prev, prev_emb)
        prev_emb = emb
    return b_prev, prev_emb


def expected_depth(probs: torch.Tensor, b_centers: torch.Tensor, hw) -> torch.Tensor:
    """The expectation over the bins, resized to the input: (B, H, W)."""
    depth = (probs * _resize_to(b_centers, probs)).sum(1, keepdim=True)
    return resize_align_corners(depth, *hw)[:, 0]


class ZoeDepth(nn.Module):
    """(B, H, W, 3) normalized image -> (B, H, W) metric depth."""

    def __init__(self, cfg: ZoeDepthConfig = ZoeDepthConfig()):
        super().__init__()
        c = self.cfg = cfg
        f, e = c.core.features, c.bin_embedding_dim
        self.core = MidasCore(ZoeDepthCore(c.core))
        self.conv2 = nn.Conv2d(f, f, 1)
        self.seed_bin_regressor = SeedBinRegressorUnnormed(f, c.n_bins)
        self.seed_projector = Projector(f, e)
        self.projectors = nn.ModuleList([Projector(f, e) for _ in c.n_attractors])
        self.attractors = attractor_stack(c, c.n_bins)
        self.conditional_log_binomial = ConditionalLogBinomial(
            33, e, c.n_bins, min_temp=c.min_temp, max_temp=c.max_temp)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        rel, feat32, btlnck, blocks = self.core(x)
        z = self.conv2(btlnck)
        embs = [p(xb) for p, xb in zip(self.projectors, blocks)]
        b_centers, prev_emb = refine_bins(self.attractors, embs, self.seed_bin_regressor(z),
                                          self.seed_projector(z))
        last = torch.cat([feat32, _resize_to(rel[:, None], feat32)], dim=1)
        probs = self.conditional_log_binomial(last, _resize_to(prev_emb, last))
        return expected_depth(probs, b_centers, x.shape[1:3])
