"""DIFT-style diffusion features and the MD (mean distance) metric.

Counterpart of `geodiffuser_tpu/evaluation/dift.py`.  The reference's
headline geometry metric (image_fidelity.py:125-181):
  1. detect keypoints inside the object mask of the source image;
  2. extract diffusion features for source and edit (DIFT: noise the latent
     to t=261, one UNet pass, up-block-1 features, an ensemble of 8 noise
     draws; evaluation/dift_sd.py), with SD-2.1 (`ModelConfig.sd21()`);
  3. for each source keypoint, find the edit pixel of largest cosine
     similarity and measure its distance to the *expected* warped location
     from the transform field.  MD = mean distance.

The features are the UNet's up-block taps (`UNet2DCondition(...,
features=True)`: up block i's output before its upsampler, as the JAX
package taps it).  On the card the SD-2.1 UNet's 64^2 and 32^2
self-attention layers (64-wide heads) run the flash kernel.  The noise
draws come from an explicit `torch.Generator` (seeded from `seed` when none
is given, so that the source and the edit see the same draws, as the JAX
package's PRNGKey(i) draws are the same for both); `features` is one draw.
On the card a call's 8 draws run as one CUDA graph, replayed for every
image of the same shape (`SDFeaturizer`), the draws' noises and the
inputs staged eagerly before it.
Keypoints: a numpy scale-space DoG detector (`sift_keypoints`, the detector
half of SIFT; the reference uses cv2.SIFT positions only) with Harris
corners as the fallback.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from geodiffuser_tpu_torch.core.pipeline import Pipeline
from geodiffuser_tpu_torch.ops import image as image_ops
from geodiffuser_tpu_torch.utils.cuda_graphs import CapturedCall
from geodiffuser_tpu_torch.utils.profiling import annotate

# featurizer calls whose ensemble was captured as a CUDA graph, replayed,
# or run eagerly (chip_smoke.py reads and resets them)
GRAPHS = {"captures": 0, "replays": 0, "eager": 0}


def harris_keypoints(gray: np.ndarray, mask: Optional[np.ndarray] = None, max_points: int = 50,
                     k: float = 0.04, min_distance: int = 5) -> np.ndarray:
    """Harris corner detection (float32) with greedy non-max suppression.
    Returns (N, 2) xy."""
    g = np.asarray(gray, np.float32)
    if g.ndim == 3:
        g = g.mean(-1)
    if g.max() > 1.5:
        g = g / np.float32(255.0)
    dy, dx = np.gradient(g)
    smooth = lambda x: image_ops.gaussian_smooth_2d(torch.from_numpy(x), 5).numpy()
    ixx, iyy, ixy = smooth(dx * dx), smooth(dy * dy), smooth(dx * dy)
    det = ixx * iyy - ixy * ixy
    tr = ixx + iyy
    r = det - np.float32(k) * tr * tr
    if mask is not None:
        r = np.where(np.asarray(mask) > 0.5, r, -np.inf)
    pts = []
    r_work = r.copy()
    h, w = r.shape
    for _ in range(max_points):
        idx = np.argmax(r_work)
        y, x = divmod(int(idx), w)
        if not np.isfinite(r_work[y, x]) or r_work[y, x] <= 0:
            break
        pts.append((x, y))
        y0, y1 = max(0, y - min_distance), min(h, y + min_distance + 1)
        x0, x1 = max(0, x - min_distance), min(w, x + min_distance + 1)
        r_work[y0:y1, x0:x1] = -np.inf
    return np.asarray(pts, np.float64).reshape(-1, 2)


def build_featurizer(weights_dir: Optional[str] = None, sd_version: str = "2.1",
                     image_size: int = 512, t: int = 261, up_block: int = 1, ensemble: int = 8,
                     device="cuda", seed: int = 0) -> "SDFeaturizer":
    """The featurizer of the reference's MD metric: SD-2.1
    (`SDFeaturizer('stabilityai/stable-diffusion-2-1')`, dift_sd.py:16; t=261,
    up_ft_index=1, ensemble 8, image_fidelity.py:150-166) from a
    diffusers-layout checkpoint in `weights_dir` (random weights from `seed`
    without one); "1.x" takes the edit pipeline's SD-1.4 geometry."""
    from geodiffuser_tpu_torch.config import ModelConfig

    cfg = ModelConfig.sd21() if sd_version.startswith("2") else ModelConfig()
    pipe = Pipeline.create(cfg, image_size=image_size, checkpoint_dir=weights_dir, seed=seed,
                           device=device)
    return SDFeaturizer(pipe, t=t, up_block=up_block, ensemble=ensemble, seed=seed)


class SDFeaturizer:
    """Diffusion features from one noised UNet pass a draw (dift_sd.py
    semantics: t=261, up_ft_index=1, an ensemble of 8 draws).

    A call stages its inputs eagerly (the VAE latent, the text context and
    the ensemble's noise draws from the caller's generator, `draw_noises`),
    then runs the ensemble (`_ensemble`).  On the card the ensemble is one
    CUDA graph, captured at the first call and replayed after it; the
    capture is keyed on what it freezes (the latent's and context's shapes,
    dtypes and device, `t`, `up_block`, `ensemble` and the UNet object), and
    a call whose key differs captures anew.  The graph and its memory pool
    belong to the featurizer and go with it."""

    def __init__(self, pipeline: Pipeline, t: int = 261, up_block: int = 1, ensemble: int = 8,
                 seed: int = 0):
        self.pipeline = pipeline
        self.t = t
        self.up_block = up_block
        self.ensemble = ensemble
        self.seed = seed
        self._scalars = {}
        self._graph = None   # (key, CapturedCall)

    def _step_scalars(self, t: int, device: torch.device):
        """(alphas_cumprod[t], the (1,) int64 timestep) on `device`, uploaded
        once: no host copy per draw, none inside a captured graph."""
        key = (t, device)
        if key not in self._scalars:
            self._scalars[key] = (self.pipeline.schedule.alphas_cumprod[t].to(device),
                                  torch.full((1,), t, dtype=torch.long, device=device))
        return self._scalars[key]

    @torch.no_grad()
    def features(self, latent: torch.Tensor, context: torch.Tensor, noise: torch.Tensor,
                 t: int) -> torch.Tensor:
        """One draw: the latent noised to t with `noise`, one UNet pass,
        up block `up_block`'s (B, h, w, C) output in the model's type."""
        a, timestep = self._step_scalars(t, latent.device)
        noised = torch.sqrt(a) * latent + torch.sqrt(1.0 - a) * noise
        _, taps = self.pipeline.unet(noised, timestep, context, features=True)
        return taps[f"up_block_{self.up_block}"]

    def draw_noises(self, shape, generator: torch.Generator) -> List[torch.Tensor]:
        """The ensemble's standard-normal draws of `shape`, in order."""
        dev = self.pipeline.device
        return [torch.randn(shape, generator=generator, device=dev) for _ in range(self.ensemble)]

    @torch.no_grad()
    def _stage(self, image: np.ndarray, prompt: str, generator: Optional[torch.Generator]):
        """The ensemble's inputs: the image's latent, the prompt's context
        and the noise draws, in that order from `generator`."""
        img = np.asarray(image, np.float32)
        if img.max() > 1.5:
            img = img / 255.0
        dev = self.pipeline.device
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(self.seed)
        latent = self.pipeline.encode_image(torch.from_numpy(img).to(dev))
        ctx = self.pipeline.encode_text([prompt])
        return latent, ctx, self.draw_noises(tuple(latent.shape), generator)

    @torch.no_grad()
    def _ensemble(self, latent: torch.Tensor, ctx: torch.Tensor,
                  noises: Sequence[torch.Tensor]) -> torch.Tensor:
        """The mean over the draws of up block `up_block`'s features,
        summed in float32: (B, h', w', C)."""
        acc = None
        for k, noise in enumerate(noises):
            with annotate("gd.dift.draw", f"draw={k}"):
                f = self.features(latent, ctx, noise, self.t).float()
                acc = f if acc is None else acc + f
        return acc / self.ensemble

    def _captured(self, latent: torch.Tensor, ctx: torch.Tensor,
                  noises: Sequence[torch.Tensor]) -> CapturedCall:
        """The ensemble's graph for these inputs, captured where none
        matches them."""
        # modules compare by identity: a new UNet object is a new key
        key = (tuple(latent.shape), latent.dtype, latent.device, tuple(ctx.shape), ctx.dtype,
               ctx.device, self.t, self.up_block, self.ensemble, self.pipeline.unet)
        if self._graph is None or self._graph[0] != key:
            self._graph = None   # the old graph's pool goes before the new one is made
            self._step_scalars(self.t, latent.device)
            graph = CapturedCall(lambda lat, c, *n: self._ensemble(lat, c, n),
                                 [latent, ctx, *noises])
            self._graph = (key, graph)
            GRAPHS["captures"] += 1
        return self._graph[1]

    @torch.no_grad()
    def __call__(self, image: np.ndarray, prompt: str = "",
                 generator: Optional[torch.Generator] = None) -> np.ndarray:
        """(H, W, 3) image -> (h', w', C) float32 ensemble-mean features."""
        latent, ctx, noises = self._stage(image, prompt, generator)
        if latent.is_cuda:
            graph = self._captured(latent, ctx, noises)
            with annotate("gd.dift.replay"):
                out = graph(latent, ctx, *noises)
            GRAPHS["replays"] += 1
        else:
            out = self._ensemble(latent, ctx, noises)
            GRAPHS["eager"] += 1
        return out[0].cpu().numpy()


def mean_distance_metric(featurizer: SDFeaturizer, source: np.ndarray, edited: np.ndarray,
                         mask: np.ndarray, t_coords: np.ndarray, prompt: str = "",
                         max_points: int = 50) -> Tuple[float, int]:
    """MD: mean distance between DIFT-matched keypoints and their expected
    warped locations (image_fidelity.py:125-181).

    Returns (mean_distance_px, n_keypoints).
    """
    h, w = mask.shape
    kps = detect_keypoints(source, mask, max_points=max_points)
    if len(kps) == 0:
        return float("nan"), 0
    fs = featurizer(source, prompt)
    fe = featurizer(edited, prompt)
    fh, fw, _ = fs.shape

    fs_n = fs / (np.linalg.norm(fs, axis=-1, keepdims=True) + 1e-8)
    fe_n = fe / (np.linalg.norm(fe, axis=-1, keepdims=True) + 1e-8)
    fe_flat = fe_n.reshape(-1, fe_n.shape[-1])

    dists = []
    for x, y in kps:
        fx = int(x * fw / w)
        fy = int(y * fh / h)
        q = fs_n[min(fy, fh - 1), min(fx, fw - 1)]
        sim = fe_flat @ q
        j = int(np.argmax(sim))
        my, mx = divmod(j, fw)
        # matched position back at image scale
        px = (mx + 0.5) * w / fw
        py = (my + 0.5) * h / fh
        # expected location from the transform field (NDC -> pixels)
        tc = t_coords[int(y), int(x)]
        ex = (tc[0] + 1.0) * 0.5 * (w - 1)
        ey = (tc[1] + 1.0) * 0.5 * (h - 1)
        dists.append(np.hypot(px - ex, py - ey))
    return float(np.mean(dists)), len(kps)


def sift_keypoints(gray: np.ndarray, mask: Optional[np.ndarray] = None, max_points: int = 50,
                   n_octaves: int = 3, scales_per_octave: int = 3, sigma0: float = 1.6,
                   contrast_thresh: float = 0.015, edge_ratio: float = 10.0,
                   min_distance: int = 3) -> np.ndarray:
    """Scale-space DoG keypoint detector (the detector half of SIFT).

    Returns (N, 2) xy at full-image scale, strongest |DoG| response first.
    The reference consumes cv2.SIFT keypoint positions only
    (image_fidelity.py:54-59); matching happens in DIFT feature space.
    """
    from scipy.ndimage import gaussian_filter

    g = np.asarray(gray, np.float64)
    if g.ndim == 3:
        g = g.mean(-1)
    if g.max() > 1.5:
        g = g / 255.0

    cand = []  # (|response|, x, y)
    base = g
    for octave in range(n_octaves):
        h, w = base.shape
        if min(h, w) < 16:
            break
        k = 2.0 ** (1.0 / scales_per_octave)
        sigmas = [sigma0 * (k ** i) for i in range(scales_per_octave + 3)]
        gauss = [gaussian_filter(base, s) for s in sigmas]
        dog = np.stack([gauss[i + 1] - gauss[i] for i in range(len(gauss) - 1)])

        for s in range(1, dog.shape[0] - 1):
            d = dog[s]
            # 3x3x3 local extrema
            stack = dog[s - 1:s + 2]
            mx = d == stack.max(axis=0)
            mn = d == stack.min(axis=0)
            for shift_y in (-1, 0, 1):
                for shift_x in (-1, 0, 1):
                    rolled = np.roll(np.roll(stack, shift_y, axis=1), shift_x, axis=2)
                    mx &= d >= rolled.max(axis=0)
                    mn &= d <= rolled.min(axis=0)
            extrema = (mx | mn) & (np.abs(d) > contrast_thresh)
            # edge response: ratio of principal curvatures (Lowe section 4.1)
            dyy = np.roll(d, -1, 0) + np.roll(d, 1, 0) - 2 * d
            dxx = np.roll(d, -1, 1) + np.roll(d, 1, 1) - 2 * d
            dxy = 0.25 * (
                np.roll(np.roll(d, 1, 0), 1, 1) + np.roll(np.roll(d, -1, 0), -1, 1)
                - np.roll(np.roll(d, 1, 0), -1, 1) - np.roll(np.roll(d, -1, 0), 1, 1)
            )
            tr, det = dxx + dyy, dxx * dyy - dxy * dxy
            r = edge_ratio
            not_edge = (det > 0) & (tr * tr * r < (r + 1.0) ** 2 * det)
            extrema &= not_edge
            extrema[:1, :] = extrema[-1:, :] = False
            extrema[:, :1] = extrema[:, -1:] = False
            ys, xs = np.where(extrema)
            scale = 2 ** octave
            for yy, xx in zip(ys, xs):
                fx, fy = xx * scale, yy * scale
                if mask is not None and mask[min(int(fy), mask.shape[0] - 1),
                                             min(int(fx), mask.shape[1] - 1)] <= 0.5:
                    continue
                cand.append((abs(d[yy, xx]), fx, fy))
        base = base[::2, ::2]

    if not cand:
        return np.zeros((0, 2), np.float64)
    cand.sort(key=lambda t: -t[0])
    pts: list = []
    for _, x, y in cand:
        if all((x - px) ** 2 + (y - py) ** 2 >= min_distance ** 2 for px, py in pts):
            pts.append((x, y))
            if len(pts) >= max_points:
                break
    return np.asarray(pts, np.float64).reshape(-1, 2)


def detect_keypoints(image: np.ndarray, mask: Optional[np.ndarray] = None,
                     max_points: int = 50) -> np.ndarray:
    """The DoG detector with the Harris fallback (the reference falls back
    to a Harris-style detector when SIFT finds nothing in the mask,
    image_fidelity.py:66-69)."""
    kps = sift_keypoints(image, mask, max_points=max_points)
    if len(kps) == 0:
        kps = harris_keypoints(image, mask, max_points=max_points)
    return kps
