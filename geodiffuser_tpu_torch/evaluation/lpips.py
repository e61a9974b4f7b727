"""LPIPS (AlexNet backbone) in PyTorch.

Counterpart of `geodiffuser_tpu/evaluation/lpips.py`.  The reference computes
LPIPS(net='alex') at 224^2 (image_fidelity.py:183-206) through the `lpips`
package: AlexNet conv features at 5 taps, each unit-normalized over its
channels, squared differences weighted by 1x1 linear heads, spatial means
summed over the taps.  Weights: torchvision's AlexNet state_dict
(`features.{0,3,6,8,10}`) and the lpips linear heads (`lin{i}.model.1`),
read with `torch.load(weights_only=True)`.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from geodiffuser_tpu_torch.core.pipeline import resolve_device
from geodiffuser_tpu_torch.models.weights import read_state
from geodiffuser_tpu_torch.ops import image as image_ops

# ImageNet normalization of LPIPS' scaling layer
LPIPS_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
LPIPS_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

ALEX_CHANNELS = (64, 192, 384, 256, 256)
# torchvision AlexNet.features index of each conv: (in, out, kernel, stride, padding)
ALEX_CONVS = {0: (3, 64, 11, 4, 2), 3: (64, 192, 5, 1, 2), 6: (192, 384, 3, 1, 1),
              8: (384, 256, 3, 1, 1), 10: (256, 256, 3, 1, 1)}


class AlexNetFeatures(nn.Module):
    """torchvision AlexNet.features, a tap after each ReLU stage; the
    parameters keep torchvision's indices (`features.0.weight`, ...)."""

    def __init__(self):
        super().__init__()
        self.features = nn.ModuleDict({
            str(i): nn.Conv2d(cin, cout, k, stride=s, padding=p)
            for i, (cin, cout, k, s, p) in ALEX_CONVS.items()})

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """(B, 3, H, W) -> the five ReLU outputs."""
        f = self.features
        taps = [F.relu(f["0"](x))]
        taps.append(F.relu(f["3"](F.max_pool2d(taps[-1], 3, 2))))
        taps.append(F.relu(f["6"](F.max_pool2d(taps[-1], 3, 2))))
        taps.append(F.relu(f["8"](taps[-1])))
        taps.append(F.relu(f["10"](taps[-1])))
        return taps


class LPIPS(nn.Module):
    def __init__(self):
        super().__init__()
        self.net = AlexNetFeatures()
        for i, c in enumerate(ALEX_CHANNELS):
            setattr(self, f"lin{i}", nn.Conv2d(c, 1, 1, bias=False))

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a, b: (B, H, W, 3) in [-1, 1].  Returns (B,) distances."""
        shift = torch.as_tensor(LPIPS_SHIFT, device=a.device)
        scale = torch.as_tensor(LPIPS_SCALE, device=a.device)
        prep = lambda x: ((x.float() - shift) / scale).permute(0, 3, 1, 2)
        total = torch.zeros(a.shape[0], device=a.device)
        for i, (xa, xb) in enumerate(zip(self.net(prep(a)), self.net(prep(b)))):
            na = xa / torch.sqrt(torch.sum(xa * xa, 1, keepdim=True) + 1e-10)
            nb = xb / torch.sqrt(torch.sum(xb * xb, 1, keepdim=True) + 1e-10)
            w = getattr(self, f"lin{i}")((na - nb) ** 2)
            total = total + w[:, 0].mean(dim=(1, 2))
        return total


def convert_lpips(alex_state: Dict[str, torch.Tensor],
                  lin_state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """torchvision alexnet (`features.{0,3,6,8,10}.{weight,bias}`, the
    classifier ignored) + lpips linear heads (`lin{i}.model.1.weight` or
    `lins.{i}.model.1.weight`) -> the `LPIPS` module's state_dict."""
    out = {}
    for idx in ALEX_CONVS:
        for leaf in ("weight", "bias"):
            out[f"net.features.{idx}.{leaf}"] = alex_state[f"features.{idx}.{leaf}"]
    for i in range(len(ALEX_CHANNELS)):
        key = f"lin{i}.model.1.weight"
        if key not in lin_state:
            key = f"lins.{i}.model.1.weight"
        out[f"lin{i}.weight"] = lin_state[key]
    return out


class LPIPSMetric:
    """Callable LPIPS on `device`, weights from a state_dict or two files."""

    def __init__(self, state: Optional[Dict[str, torch.Tensor]] = None,
                 alex_path: Optional[str] = None, lin_path: Optional[str] = None,
                 device="cuda"):
        self.device = resolve_device(device)
        if state is None:
            if not (alex_path and lin_path):
                raise RuntimeError("LPIPS needs pretrained AlexNet + linear-head weights; pass "
                                   "alex_path/lin_path or state.")
            state = convert_lpips(read_state(alex_path), read_state(lin_path))
        self.model = LPIPS().eval().requires_grad_(False)
        self.model.load_state_dict({k: v.float() for k, v in state.items()}, strict=True)
        self.model.to(self.device)

    @torch.no_grad()
    def __call__(self, a: np.ndarray, b: np.ndarray, size: int = 224) -> float:
        def prep(x):
            x = np.asarray(x, np.float32)
            if x.max() > 1.5:
                x = x / 255.0
            x = image_ops.resize_bilinear_hwc(torch.from_numpy(x).to(self.device), size, size)
            return (x * 2.0 - 1.0)[None]

        return float(self.model(prep(a), prep(b))[0])
