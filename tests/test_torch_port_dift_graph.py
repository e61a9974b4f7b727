"""The DIFT featurizer's staged ensemble and its CUDA-graph bookkeeping on
the CPU: ModelConfig.tiny_sd21(), float32, one torch thread.

The staged call (`_stage`, then `_ensemble`) must give the per-draw loop's
features bit for bit and draw the noises `draw_noises` draws; the capture
key must change with everything a graph freezes.  The graph itself runs
on the card only: chip_smoke.py's evaluation phase counts a replay's kernel
launches from a profiler trace (`traced_launches`, here on a made-up one).
"""

import numpy as np
import pytest
import torch

import chip_smoke
from geodiffuser_tpu_torch.config import ModelConfig
from geodiffuser_tpu_torch.core.pipeline import Pipeline
from geodiffuser_tpu_torch.evaluation import dift

SIZE = 64


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def pipe():
    return Pipeline.create(ModelConfig.tiny_sd21(), image_size=SIZE, device="cpu")


def _image(seed: int) -> np.ndarray:
    return np.random.RandomState(seed).rand(SIZE, SIZE, 3).astype(np.float32)


@torch.no_grad()
def _per_draw_loop(feat, image, generator):
    """The featurizer's call as one loop over the draws, each noising the
    latent with the schedule's alphas_cumprod[t] and an int timestep."""
    pipe = feat.pipeline
    latent = pipe.encode_image(torch.from_numpy(image))
    ctx = pipe.encode_text([""])
    a = pipe.schedule.alphas_cumprod[feat.t]
    acc = None
    for noise in feat.draw_noises(tuple(latent.shape), generator):
        noised = torch.sqrt(a) * latent + torch.sqrt(1.0 - a) * noise
        _, taps = pipe.unet(noised, feat.t, ctx, features=True)
        f = taps[f"up_block_{feat.up_block}"].float()
        acc = f if acc is None else acc + f
    return (acc[0] / feat.ensemble).numpy()


def test_staged_ensemble_equals_the_per_draw_loop(pipe):
    feat = dift.SDFeaturizer(pipe, ensemble=3, seed=5)
    image = _image(0)
    want = _per_draw_loop(feat, image, torch.Generator().manual_seed(11))
    latent, ctx, noises = feat._stage(image, "", torch.Generator().manual_seed(11))
    np.testing.assert_array_equal(feat._ensemble(latent, ctx, noises)[0].numpy(), want)
    before = dict(dift.GRAPHS)
    np.testing.assert_array_equal(feat(image, "", torch.Generator().manual_seed(11)), want)
    assert dift.GRAPHS == dict(before, eager=before["eager"] + 1)
    # without a generator: the featurizer's seed
    np.testing.assert_array_equal(feat(image), _per_draw_loop(feat, image,
                                                              torch.Generator().manual_seed(5)))


def test_staged_noises_are_draw_noises(pipe):
    feat = dift.SDFeaturizer(pipe, ensemble=4)
    latent, _, noises = feat._stage(_image(1), "", torch.Generator().manual_seed(7))
    want = feat.draw_noises(tuple(latent.shape), torch.Generator().manual_seed(7))
    assert len(noises) == 4
    for got, ref in zip(noises, want):
        torch.testing.assert_close(got, ref, rtol=0, atol=0)


class _Recorded:
    """Stands for `CapturedCall` on the CPU: records each capture and runs
    the captured function eagerly."""

    made = []

    def __init__(self, fn, inputs):
        self.fn, self.inputs = fn, list(inputs)
        _Recorded.made.append(self)

    def __call__(self, *args):
        return self.fn(*args)


def test_capture_key(pipe, monkeypatch):
    monkeypatch.setattr(dift, "CapturedCall", _Recorded)
    _Recorded.made = []
    feat = dift.SDFeaturizer(pipe, ensemble=2)
    latent, ctx, noises = feat._stage(_image(2), "", torch.Generator().manual_seed(3))
    graph = feat._captured(latent, ctx, noises)
    # the captured function is the ensemble over the static inputs
    torch.testing.assert_close(graph(latent, ctx, *noises), feat._ensemble(latent, ctx, noises),
                               rtol=0, atol=0)
    assert feat._captured(latent, ctx, noises) is graph
    assert feat._captured(latent.clone(), ctx.clone(), [n + 1 for n in noises]) is graph

    def recaptures(*args) -> bool:
        n = len(_Recorded.made)
        feat._captured(*args)
        return len(_Recorded.made) == n + 1

    small = latent[..., :4, :4, :]
    assert recaptures(small, ctx, [n[..., :4, :4, :] for n in noises])            # shape
    assert recaptures(latent, ctx, noises)
    assert recaptures(latent.double(), ctx, [n.double() for n in noises])       # dtype
    assert recaptures(latent, ctx.double(), noises)                             # context dtype
    assert recaptures(latent, ctx[:, :10], noises)                              # context shape
    assert not recaptures(latent, ctx[:, :10], noises)
    for attr, value in (("t", 500), ("up_block", 2), ("ensemble", 3)):
        setattr(feat, attr, value)
        assert recaptures(latent, ctx[:, :10], noises), attr
    old = pipe.unet
    pipe.unet = torch.nn.Identity()
    try:
        assert recaptures(latent, ctx[:, :10], noises)                          # the UNet
    finally:
        pipe.unet = old
    assert recaptures(latent, ctx[:, :10], noises)


def _kernel(name, grid=(1, 1, 1)):
    return {"ph": "X", "cat": "kernel", "name": name, "args": {"grid": list(grid)}}


def test_traced_launches_count_the_device_records():
    self_64, cross_64, self_32 = (5, 4096, 4096, 64), (5, 4096, 77, 64), (10, 1024, 1024, 64)
    fwd = "void (anonymous namespace)::flash_fwd_wgmma_kernel<{}, {}>(CUtensorMap, float*)"
    events = ([_kernel(fwd.format(80, 2), (32, 5, 1))] * 3
              + [_kernel(fwd.format(80, 2), (16, 10, 1)),
                 _kernel(fwd.format(40, 4), (8, 16, 1)),                 # a shape not listed
                 _kernel("void flash_fwd_kernel<float>(float const*)"),
                 _kernel("void flash_bwd_dq_wgmma_kernel<80, 2>(CUtensorMap)"),
                 _kernel("void flash_bwd_dkv_wgmma_kernel<80, 2>(CUtensorMap)"),
                 _kernel("void flash_delta_kernel<float>(float const*)"),
                 _kernel("void corr_finalize_kernel(float const*)"),
                 _kernel("void corr_combine_kernel(float const*)"),
                 _kernel("void bwd_keys_kernel<80>(CUtensorMap)"),
                 _kernel("void corr_bwd_keys_kernel<float, 2>(float const*)"),
                 _kernel("void corr_bwd_rows_kernel<float, 2>(float const*)"),
                 _kernel("splat_kernel(Splat)"),
                 _kernel("void (anonymous namespace)::gn_stats_kernel<__nv_bfloat16, 1>(Geo)"),
                 _kernel("void (anonymous namespace)::gn_apply_kernel<__nv_bfloat16, 1, true>"
                         "(__nv_bfloat16 const*)"),
                 _kernel("void (anonymous namespace)::gn_bwd_reduce_kernel<float, 2, false>"
                         "(float const*)"),
                 _kernel("void (anonymous namespace)::gn_bwd_apply_kernel<float, 2, false>"
                         "(float const*)"),
                 {"ph": "X", "cat": "cpu_op", "name": "flash_fwd_wgmma_kernel<80, 2>"},
                 {"ph": "X", "cat": "gpu_user_annotation", "name": "gd.dift.replay"}])
    launches, shapes, unnamed = chip_smoke.traced_launches(events, [self_64, self_32, self_64])
    assert launches == {"flash_fwd": 6, "flash_bwd": 1, "corr_fwd": 2, "corr_bwd": 2,
                        "splat_fused": 1, "group_norm_fwd": 1, "group_norm_bwd": 1}
    assert shapes == {("flash_fwd", *self_64): 3, ("flash_fwd", *self_32): 1}
    assert unnamed == {(40, 4, (8, 16, 1)): 1}
    # self and cross attention at one grid: not told apart
    _, shapes, unnamed = chip_smoke.traced_launches(events[:1], [self_64, cross_64])
    assert shapes == {} and unnamed == {(80, 2, (32, 5, 1)): 1}
