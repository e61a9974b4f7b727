"""FID / IS with a pluggable feature extractor.

Counterpart of `geodiffuser_tpu/evaluation/fid.py`.  The reference computes
FID/IS over experiment trees with pytorch-fid's InceptionV3
(Evaluation/scripts/fid_is/fid_is_score_geodiff.py).  The math takes any
embedder (image -> feature vector or logits); the default embedder is the
CLIP ViT-B/32 image tower ("CLIP-FID"), whose weights are read from
`clip_vision.safetensors` in a weights directory.
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Tuple

import numpy as np
import scipy.linalg
import torch

from geodiffuser_tpu_torch.core.pipeline import resolve_device


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """FID between two Gaussians fitted to feature sets.  (`sqrtm` is called
    without the `disp` flag, which SciPy deprecates; the result is the one
    `disp=False` gives.)"""
    diff = mu1 - mu2
    covmean = scipy.linalg.sqrtm(sigma1 @ sigma2)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = scipy.linalg.sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


def fit_gaussian(features: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    mu = features.mean(0)
    sigma = np.cov(features, rowvar=False)
    return mu, np.atleast_2d(sigma)


def fid_score(feats_a: np.ndarray, feats_b: np.ndarray) -> float:
    return frechet_distance(*fit_gaussian(feats_a), *fit_gaussian(feats_b))


def inception_score(logits: np.ndarray, splits: int = 10) -> Tuple[float, float]:
    """IS from class logits: exp(E_x KL(p(y|x) || p(y)))."""
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs = probs / probs.sum(-1, keepdims=True)
    scores = []
    n = len(probs)
    for i in range(splits):
        part = probs[i * n // splits: (i + 1) * n // splits]
        if len(part) == 0:
            continue
        py = part.mean(0, keepdims=True)
        kl = (part * (np.log(part + 1e-12) - np.log(py + 1e-12))).sum(-1)
        scores.append(np.exp(kl.mean()))
    return float(np.mean(scores)), float(np.std(scores))


class CLIPFeatureExtractor:
    """Default embedder: CLIP ViT-B/32 image embeddings on `device`, from a
    state_dict or from `weights_dir/clip_vision.safetensors` (HF layout).
    Raises `metrics.PretrainedWeightsUnavailable` when neither is given."""

    def __init__(self, state: Optional[dict] = None, config=None,
                 weights_dir: Optional[str] = None, device="cuda"):
        from geodiffuser_tpu_torch.evaluation.metrics import weights_file
        from geodiffuser_tpu_torch.models import weights
        from geodiffuser_tpu_torch.models.clip_vision import CLIPVisionConfig, CLIPVisionEncoder

        self.cfg = config or CLIPVisionConfig()
        self.device = resolve_device(device)
        if state is None:
            path = weights_file(weights_dir, "clip_vision.safetensors", "CLIP ViT-B/32")
            state = weights.convert_clip_vision(weights.read_state(path))
        with self.device:
            self.model = CLIPVisionEncoder(self.cfg)
        self.model.eval().requires_grad_(False)
        self.model.load_state_dict({k: v.to(self.device, self.cfg.dtype)
                                    for k, v in state.items()}, strict=True)

    @torch.no_grad()
    def __call__(self, image: np.ndarray) -> np.ndarray:
        from geodiffuser_tpu_torch.models.clip_vision import preprocess_clip_image

        x = preprocess_clip_image(image, self.cfg.image_size, self.device)
        return self.model(x)[0].cpu().numpy()


def fid_over_experiments(exp_root: str, embed: Callable[[np.ndarray], np.ndarray],
                         result_name: str = "result_ls.png") -> float:
    """FID between edited results and input images over an experiment tree
    (the fid_is_score_geodiff.py flow)."""
    from geodiffuser_tpu_torch.utils import exp_io, png

    real, fake = [], []
    for _cat, folder in exp_io.list_experiments(exp_root):
        rp = os.path.join(folder, result_name)
        if not os.path.exists(rp):
            continue
        exp = exp_io.read_exp(folder)
        real.append(embed(exp.input_image))
        fake.append(embed(png.to_rgb(png.read_png(rp))))
    if len(real) < 2:
        raise ValueError("need at least 2 experiments with results for FID")
    return fid_score(np.stack(real), np.stack(fake))
