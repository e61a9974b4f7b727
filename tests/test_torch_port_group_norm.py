"""The channels-last GroupNorm (+ SiLU) and the UNet's and VAE's layout on
the CPU: float32, one torch thread.

`group_norm_plain` (the CPU route of `kernels/group_norm.group_norm`, and
what chip_smoke.py holds the CUDA kernels against on the card) must match
`F.group_norm` on NCHW, with and without the SiLU, values and gradients;
the kernels' tiling must cover every pixel once; every convolution and
GroupNorm of a tiny UNet and VAE must see a channels-last input, whatever
the filters' layout, and give the same result with either layout.
"""

import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from geodiffuser_tpu_torch.config import ModelConfig
from geodiffuser_tpu_torch.core.pipeline import Pipeline
from geodiffuser_tpu_torch.kernels import group_norm as gn
from geodiffuser_tpu_torch.models import layers
from geodiffuser_tpu_torch.models.unet import UNet2DCondition
from geodiffuser_tpu_torch.models.vae import AutoencoderKL

CL = torch.channels_last


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _inputs(c: int, seed: int):
    g = torch.Generator().manual_seed(seed)
    # an offset mean, as activations have: the variance must not cancel
    x = (torch.randn(2, c, 5, 7, generator=g) * 3.0 + 2.0).to(memory_format=CL)
    w = torch.randn(c, generator=g) * 0.2 + 1.0
    b = torch.randn(c, generator=g) * 0.1
    dy = torch.randn(2, c, 5, 7, generator=g)
    return x, w, b, dy


@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("per_group", [4, 10, 30, 60])
def test_plain_matches_group_norm(per_group, silu):
    """Values and gradients of x, weight and bias against autograd of
    `F.group_norm` (+ `F.silu`) on the NCHW copy; the output channels-last."""
    groups = 8
    x, w, b, dy = _inputs(per_group * groups, per_group)
    leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
    got = gn.group_norm_plain(*leaves, groups, 1e-5, silu)
    ref_leaves = [t.contiguous().clone().requires_grad_(True) for t in (x, w, b)]
    ref = F.group_norm(ref_leaves[0], groups, ref_leaves[1], ref_leaves[2], 1e-5)
    if silu:
        ref = F.silu(ref)
    assert got.is_contiguous(memory_format=CL) and not got.is_contiguous()
    torch.testing.assert_close(got, ref, atol=2e-6, rtol=1e-5)
    grads = torch.autograd.grad(got, leaves, dy)
    ref_grads = torch.autograd.grad(ref, ref_leaves, dy)
    for a, r in zip(grads, ref_grads):
        torch.testing.assert_close(a, r, atol=1e-5, rtol=1e-5)
    # the CPU route of the wrapper is the plain version
    torch.testing.assert_close(gn.group_norm(x, w, b, groups, 1e-5, silu), got.detach())


@pytest.mark.parametrize("shape", [(1, 320, 64 * 64), (1, 1280, 8 * 8), (1, 2560, 8 * 8),
                                   (24, 320, 64 * 64), (24, 1920, 32 * 32), (1, 128, 512 * 512),
                                   (16, 128, 512 * 512), (2, 16, 1), (3, 40, 7)])
@pytest.mark.parametrize("elem_size", [2, 4])
def test_plan_covers_every_pixel(shape, elem_size):
    """Tiles of `tile` pixels cover [0, HW) once, none empty; the threads
    cover every 16-byte chunk of a pixel; batch 1 gets a block a streaming
    multiprocessor (as near as whole pixels allow) where the activation is
    large enough, the edit groups' 24 streams fewer tiles a sample."""
    n, c, hw = shape
    p = gn.plan(n, c, hw, elem_size)
    assert (p["tiles"] - 1) * p["tile"] < hw <= p["tiles"] * p["tile"]
    assert 1 <= p["tiles"] <= gn.MAX_TILES
    chunks = c * elem_size // 16
    assert p["rows"] * p["cols"] <= gn.THREADS
    assert p["cols"] * p["per_thread"] >= chunks > p["cols"] * (p["per_thread"] - 1)
    if n == 1 and hw * c * elem_size >= gn.SMS * gn.MIN_TILE_BYTES:
        assert p["tile"] == -(-hw // gn.SMS)
    if n == 24:
        assert p["tiles"] * n >= gn.SMS and p["tiles"] < gn.SMS


def test_norm_modules_stay_group_norms():
    """The UNet's and VAE's norms are `nn.GroupNorm`s with the parameters
    `weight` and `bias` and no buffers (what seeded initialisations and
    checkpoints read)."""
    cfg = ModelConfig.tiny()
    for model in (UNet2DCondition(cfg), AutoencoderKL(cfg)):
        norms = [m for m in model.modules() if isinstance(m, nn.GroupNorm)]
        assert norms and all(isinstance(m, layers.GroupNorm) for m in norms)
        for m in norms:
            assert [n for n, _ in m.named_parameters()] == ["weight", "bias"]
            assert not list(m.buffers())


def _layouts(models, run):
    """`run()` with a pre-hook on every Conv2d and GroupNorm of `models`:
    the names of those whose input was not channels-last."""
    seen, wrong, hooks = [], [], []

    def hook(name):
        def check(_, args):
            x = args[0]
            seen.append(name)
            unambiguous = x.shape[2] * x.shape[3] == 1 or not x.is_contiguous()
            if not (x.is_contiguous(memory_format=CL) and unambiguous):
                wrong.append(name)
        return check

    for prefix, model in models.items():
        for name, m in model.named_modules():
            if isinstance(m, (nn.Conv2d, nn.GroupNorm)):
                hooks.append(m.register_forward_pre_hook(hook(f"{prefix}.{name}")))
    try:
        out = run()
    finally:
        for h in hooks:
            h.remove()
    return out, seen, wrong


@torch.no_grad()
def test_unet_and_vae_run_channels_last():
    """A tiny UNet pass (down to 1 x 1) and a VAE encode and decode: every
    convolution and GroupNorm input channels-last, with the pipeline's
    channels-last filters and with NCHW ones (a model built directly), and
    the same results both ways."""
    pipe = Pipeline.create(ModelConfig.tiny(), image_size=64, device="cpu")
    assert all(p.is_contiguous(memory_format=CL) for m in (pipe.unet, pipe.vae)
               for p in m.parameters() if p.dim() == 4)
    g = torch.Generator().manual_seed(0)
    latent = torch.randn(2, 8, 8, 4, generator=g)
    context = torch.randn(2, 77, 32, generator=g)
    image = torch.rand(1, 64, 64, 3, generator=g) * 2.0 - 1.0

    def run(unet, vae):
        eps, taps = unet(latent, 500, context, features=True)
        z = vae.encode(image)
        return eps, taps, z, vae.decode(z)

    outs = {}
    for weights in ("channels_last", "nchw"):
        unet, vae = pipe.unet, pipe.vae
        if weights == "nchw":
            unet, vae = UNet2DCondition(pipe.config), AutoencoderKL(pipe.config)
            unet.load_state_dict({k: v.contiguous() for k, v in pipe.unet.state_dict().items()})
            vae.load_state_dict({k: v.contiguous() for k, v in pipe.vae.state_dict().items()})
            assert not unet.conv_in.weight.is_contiguous(memory_format=CL)
        out, seen, wrong = _layouts({"unet": unet, "vae": vae}, lambda: run(unet, vae))
        assert len(seen) > 100 and not wrong, wrong
        eps, taps, z, dec = out
        assert eps.shape == latent.shape and z.shape == (1, 8, 8, 4) and dec.shape == image.shape
        # NHWC views of the channels-last activations (z, a channel slice, is not)
        assert all(t.is_contiguous() for t in [eps, dec, *taps.values()])
        outs[weights] = out
    a, b = outs["channels_last"], outs["nchw"]
    for x, y in zip([a[0], a[2], a[3], *a[1].values()], [b[0], b[2], b[3], *b[1].values()]):
        torch.testing.assert_close(x, y, atol=1e-5, rtol=1e-5)
