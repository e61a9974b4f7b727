"""Seeded synthetic scenes and rigid transforms: the inputs of every cell.

A scene is a noise-textured image with one object, an ellipse on a depth
ramp with the object nearer, its mask and its depth map.  The parameters
come from the traffic mix's `scene` and `transform` groups; every draw
comes from `numpy.random.default_rng` seeded by the run's seed and the
scene's place in the traffic, so the same seed gives the same inputs.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from portbench.reference.gd.ops import camera


def rng(*words: int) -> np.random.Generator:
    """A generator seeded by any number of non-negative integers."""
    return np.random.default_rng([int(w) for w in words])


def scene(size: int, params: Dict, gen: np.random.Generator):
    """(image (H, W, 3) uint8, depth (H, W) float32, mask (H, W) float32)."""
    image = gen.random((size, size, 3), dtype=np.float32)
    lo, hi = params["centre"]
    cx, cy = gen.uniform(lo, hi, 2) * size
    radius = gen.uniform(*params["radius"]) * size
    aspect = gen.uniform(*params["aspect"])
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    mask = (((xx - cx) / radius) ** 2 + ((yy - cy) / (radius * aspect)) ** 2 < 1.0)
    tint = gen.uniform(0.2, 1.0, 3).astype(np.float32)
    image = np.where(mask[..., None], 0.5 * image + 0.5 * tint, image)
    d_lo, d_hi = params["depth"]
    depth = d_lo + (d_hi - d_lo) * yy / size
    depth = np.where(mask, depth * params["object_depth_scale"], depth)
    return ((image * 255).astype(np.uint8), depth.astype(np.float32), mask.astype(np.float32))


def transform(params: Dict, gen: np.random.Generator) -> np.ndarray:
    """A (4, 4) rigid transform with uniform scale, each component drawn
    uniformly from its range in `params`; {"identity": true} gives eye(4)."""
    if params.get("identity"):
        return np.eye(4)
    u = {k: gen.uniform(*params[k]) for k in ("tx", "ty", "tz", "ry", "scale")}
    return camera.compose_transform(tx=u["tx"], ty=u["ty"], tz=u["tz"], ry=u["ry"],
                                    sx=u["scale"], sy=u["scale"], sz=u["scale"])


def group(size: int, traffic: Dict, seed: int, index: int, slots: int) -> Dict[str, np.ndarray]:
    """The inputs of group `index`: `slots` distinct scenes, scene j seeded by
    (seed, index, j), each with its own transform."""
    images, depths, masks, tfs = [], [], [], []
    for j in range(slots):
        gen = rng(seed, index, j)
        image, depth, mask = scene(size, traffic["scene"], gen)
        images.append(image)
        depths.append(depth)
        masks.append(mask)
        tfs.append(transform(traffic["transform"], gen))
    return dict(images=np.stack(images), depths=np.stack(depths), masks=np.stack(masks),
                transforms=np.stack(tfs))


def images(size: int, params: Dict, seed: int, indices: Sequence[int]) -> np.ndarray:
    """Scene images (N, H, W, 3) uint8, image i seeded by (seed, i)."""
    return np.stack([scene(size, params, rng(seed, i))[0] for i in indices])
