"""Edit-quality metrics (reference: GeoDiffuser/evaluation/image_fidelity.py).

Counterpart of `geodiffuser_tpu/evaluation/metrics.py`.  The reference's
metric set (image_fidelity.py:125-206, 510-514):
  * warp error   - masked L1 between the edit and the splat-warped input
  * LPIPS (alex @224) and IF = 1 - LPIPS
  * CLIP ViT-B/32 cosine similarity
  * MD           - mean distance of DIFT-matched keypoints from their
                   expected warped locations (evaluation/dift.py)

Warp error, PSNR, SSIM and background preservation need no pretrained
weights.  LPIPS and CLIP load theirs from a local directory and raise
`PretrainedWeightsUnavailable` when it does not hold them.  The functions
that run torch ops take `device` ("cuda" unless the caller asks for the
CPU); PSNR and the background bundle are numpy.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from geodiffuser_tpu_torch.core.pipeline import resolve_device
from geodiffuser_tpu_torch.ops import splat as splat_ops


def warp_error(edited: np.ndarray, source: np.ndarray, t_coords: np.ndarray,
               mask_warped: np.ndarray, radius: float = 1.3, tau: float = 1.0,
               device="cuda") -> float:
    """Masked L1 between the edit and the forward-warped source, inside the
    warped object mask (image_fidelity.py:134).  Images in [0, 1]."""
    dev = resolve_device(device)
    as_t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    warped = splat_ops.splat_image(as_t(source), as_t(t_coords), radius=radius, tau=tau)
    m = as_t(mask_warped)[..., None]
    num = (torch.abs(warped - as_t(edited)) * m).sum()
    return float(num / (m.sum() * edited.shape[-1] + 1e-8))


def psnr(a: np.ndarray, b: np.ndarray, mask: Optional[np.ndarray] = None) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.max() > 1.5:
        a, b = a / 255.0, b / 255.0
    if mask is not None:
        m = mask[..., None] if mask.ndim == 2 else mask
        mse = float((((a - b) ** 2) * m).sum() / (m.sum() * a.shape[-1] + 1e-12))
    else:
        mse = float(((a - b) ** 2).mean())
    return float(10.0 * np.log10(1.0 / max(mse, 1e-12)))


def ssim(a: np.ndarray, b: np.ndarray, window: int = 7, device="cuda") -> float:
    """Mean structural similarity (grayscale, uniform window, float32)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.max() > 1.5:
        a, b = a / 255.0, b / 255.0
    if a.ndim == 3:
        a = a.mean(-1)
        b = b.mean(-1)
    dev = resolve_device(device)
    at = torch.as_tensor(a, dtype=torch.float32, device=dev)
    bt = torch.as_tensor(b, dtype=torch.float32, device=dev)

    def box(x):
        return F.avg_pool2d(x[None, None], window, stride=1)[0, 0]

    mu_a, mu_b = box(at), box(bt)
    var_a = box(at * at) - mu_a ** 2
    var_b = box(bt * bt) - mu_b ** 2
    cov = box(at * bt) - mu_a * mu_b
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2))
    return float(s.mean())


def background_preservation(edited: np.ndarray, source: np.ndarray,
                            mask_changed: np.ndarray) -> dict:
    """PSNR/L1 of the untouched background: the offline stand-in for the
    LPIPS-based IF metric."""
    inv = 1.0 - np.asarray(mask_changed, np.float64)
    return {
        "bg_psnr": psnr(edited, source, inv),
        "bg_l1": float(
            (np.abs(edited.astype(np.float64) - source.astype(np.float64)) * inv[..., None]).sum()
            / (inv.sum() * 3 + 1e-8)
            / (255.0 if np.asarray(edited).max() > 1.5 else 1.0)
        ),
    }


# ---------------------------------------------------------------------------
# Pretrained-tower metrics (weight-gated)
# ---------------------------------------------------------------------------

class PretrainedWeightsUnavailable(RuntimeError):
    pass


def weights_file(weights_dir: Optional[str], name: str, what: str) -> str:
    """`weights_dir/name`, or PretrainedWeightsUnavailable naming what needs
    it when there is no directory or no such file."""
    if not weights_dir:
        raise PretrainedWeightsUnavailable(f"{what} needs pretrained weights; pass weights_dir "
                                           f"containing {name}.")
    path = os.path.join(weights_dir, name)
    if not os.path.exists(path):
        raise PretrainedWeightsUnavailable(f"{what} needs {path}, which does not exist.")
    return path


def lpips(a: np.ndarray, b: np.ndarray, weights_dir: Optional[str] = None,
          device="cuda") -> float:
    """LPIPS(alex) @ 224^2 (image_fidelity.py:183-206) via evaluation/lpips.py;
    needs alexnet.pth and lpips_alex.pth in weights_dir."""
    from geodiffuser_tpu_torch.evaluation.lpips import LPIPSMetric

    metric = LPIPSMetric(alex_path=weights_file(weights_dir, "alexnet.pth", "LPIPS"),
                         lin_path=weights_file(weights_dir, "lpips_alex.pth", "LPIPS"),
                         device=device)
    return metric(a, b)


def clip_similarity(a: np.ndarray, b: np.ndarray, weights_dir: Optional[str] = None,
                    device="cuda") -> float:
    """CLIP ViT-B/32 image-embedding cosine (image_fidelity.py:183-206) via
    models/clip_vision.py; needs clip_vision.safetensors in weights_dir."""
    from geodiffuser_tpu_torch.evaluation.fid import CLIPFeatureExtractor

    embed = CLIPFeatureExtractor(weights_dir=weights_dir, device=device)
    ea, eb = embed(a), embed(b)
    return float(ea @ eb / (np.linalg.norm(ea) * np.linalg.norm(eb) + 1e-12))


def evaluate_experiment(exp, edited: np.ndarray, t_coords: np.ndarray,
                        mask_warped: np.ndarray, device="cuda") -> dict:
    """Offline metric bundle for one experiment folder."""
    src = exp.input_image.astype(np.float32) / 255.0
    ed = np.asarray(edited, np.float32)
    if ed.max() > 1.5:
        ed = ed / 255.0
    mask_changed = np.clip(mask_warped + exp.input_mask, 0, 1)
    out = {
        "warp_l1": warp_error(ed, src, t_coords, mask_warped, device=device),
        "ssim": ssim(ed, src, device=device),
    }
    out.update(background_preservation(ed, src, mask_changed))
    return out
