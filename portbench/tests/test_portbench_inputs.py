"""The inputs are made from the seed: equal seeds give equal inputs, other
seeds other inputs, and the reference's weights are the program's."""

import numpy as np
import pytest
import torch

from portbench import run, scenes, weights
from portbench.drivers import dift_images

SEED = 2 ** 31 + 12345     # the driver's seeds pass 32 bits


@pytest.mark.parametrize("name", ["editor-e8", "remover-e8"])
def test_groups_repeat_from_the_seed(name):
    traffic = run.json.loads((run.ROOT / "portbench" / "traffic" / f"{name}.json").read_text())
    a = scenes.group(64, traffic, SEED, 3, 4)
    b = scenes.group(64, traffic, SEED, 3, 4)
    c = scenes.group(64, traffic, SEED + 1, 3, 4)
    for key in a:
        assert np.array_equal(a[key], b[key])
    assert not np.array_equal(a["images"], c["images"])
    # the scenes of a group differ from each other
    assert not np.array_equal(a["images"][0], a["images"][1])
    if traffic["transform"].get("identity"):
        assert np.array_equal(a["transforms"], np.broadcast_to(np.eye(4), (4, 4, 4)))
    else:
        assert not np.array_equal(a["transforms"][0], a["transforms"][1])


def test_scene_parameters_stay_in_their_ranges():
    params = {"radius": [0.10, 0.20], "centre": [0.2, 0.8], "aspect": [0.75, 1.0],
              "depth": [0.3, 0.8], "object_depth_scale": 0.8}
    for i in range(8):
        image, depth, mask = scenes.scene(128, params, scenes.rng(SEED, i))
        area = mask.mean()
        assert np.pi * 0.10 ** 2 * 0.75 * 0.9 < area < np.pi * 0.20 ** 2 * 1.1
        assert depth.min() >= 0.3 * 0.8 - 1e-6 and depth.max() <= 0.8
        # the object is nearer than the ramp behind it
        ramp = 0.3 + 0.5 * np.arange(128, dtype=np.float32)[:, None] / 128
        ramp = np.broadcast_to(ramp, (128, 128))
        assert np.allclose(depth[mask > 0], 0.8 * ramp[mask > 0])
        assert np.allclose(depth[mask == 0], ramp[mask == 0])
        assert image.dtype == np.uint8 and image.shape == (128, 128, 3)


def test_images_and_noise_repeat_from_the_seed():
    params = {"radius": [0.10, 0.20], "centre": [0.2, 0.8], "aspect": [0.75, 1.0],
              "depth": [0.3, 0.8], "object_depth_scale": 0.8}
    assert np.array_equal(scenes.images(64, params, SEED, [0, 5]),
                          scenes.images(64, params, SEED, [0, 5]))
    assert dift_images.noise_seed(SEED, 4) == dift_images.noise_seed(SEED, 4)
    assert dift_images.noise_seed(SEED, 4) != dift_images.noise_seed(SEED, 5)


def _tiny_modules(dtype, seed=SEED):
    from portbench.reference.gd.config import ModelConfig
    from portbench.reference.gd.core.pipeline import MODULES

    return weights.build(MODULES, ModelConfig.tiny(), dtype, seed, "cpu")


def test_weights_repeat_and_reach_the_reference_unrounded():
    a, b = _tiny_modules(torch.bfloat16), _tiny_modules(torch.bfloat16)
    ref = _tiny_modules(torch.float32)
    for name in a:
        for (k, p), q, r in zip(a[name].state_dict().items(), b[name].state_dict().values(),
                                ref[name].state_dict().values()):
            assert torch.equal(p, q), k
            assert torch.equal(p.float(), r), k
    other = _tiny_modules(torch.bfloat16, SEED + 1)
    assert not torch.equal(a["unet"].conv_in.weight, other["unet"].conv_in.weight)


def test_weights_follow_the_default_initialisation():
    mods = _tiny_modules(torch.float32)
    lin = mods["unet"].conv_in
    bound = 1.0 / np.sqrt(lin.weight[0].numel())
    # drawn in bfloat16: 8 bits of mantissa
    assert float(lin.weight.abs().max()) <= bound * 1.01
    assert float(lin.weight.abs().max()) > 0.8 * bound
    norm = mods["unet"].conv_norm_out
    assert torch.equal(norm.weight, torch.ones_like(norm.weight))
    assert torch.equal(norm.bias, torch.zeros_like(norm.bias))
    emb = mods["text"].text_model.embeddings.token_embedding.weight
    assert 0.9 < float(emb.float().std()) < 1.1
