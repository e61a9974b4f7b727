"""The port's fused splat and stitch against the JAX package, on the CPU.

The fused splat's plain version is held against the JAX Pallas kernel in
interpret mode on the cases of tests/test_splat_kernel.py and on fields with
many points a cell; the stitch composite's one 4-channel splat against
separate image and mask splats, bit for bit; the stitch's
adaptive weights, its pre-composite and one whole tiny stitch against the
JAX package's (ModelConfig.tiny(), float32, weights carried over as in
tests/test_torch_port_edit.py).  The CUDA kernel is held against the plain
version on the card by chip_smoke.py.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from geodiffuser_tpu.config import EditConfig as JEditConfig
from geodiffuser_tpu.config import ModelConfig as JModelConfig
from geodiffuser_tpu.core import editor as jeditor
from geodiffuser_tpu.core import optimization as jopt
from geodiffuser_tpu.core.pipeline import Pipeline as JPipeline
from geodiffuser_tpu.kernels.splat import splat_image_fused
from geodiffuser_tpu.ops import camera as jcam
from geodiffuser_tpu.ops import splat as jsplat
from geodiffuser_tpu_torch.config import EditConfig, ModelConfig
from geodiffuser_tpu_torch.core import editor, optimization
from geodiffuser_tpu_torch.core.pipeline import Pipeline
from geodiffuser_tpu_torch.kernels import splat as ks
from geodiffuser_tpu_torch.models.weights import from_jax_params

torch.set_num_threads(1)

SIZE = 128
# the tests/test_editor.py:101-111 stitch schedule, with the stitch's own
# loss weights and adaptive schedule
STITCH = dict(edit_type="geometry_stitch", num_ddim_steps=2, skip_optim_steps=1,
              optimize_steps=0.65)
STITCH_SIM = EditConfig(**STITCH).resolved_loss_weights()["self"]["sim"]
# float32 on both sides; softmax sums in another order
SPLAT_TOL = dict(atol=2e-6, rtol=0)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _field(rng, h, w, shift=0.1, zrand=True):
    """tests/test_splat_kernel.py's field: identity plus random shifts and depths."""
    tc = np.asarray(jcam.identity_field(h, w)).copy()
    tc[..., 0] += rng.rand(h, w) * 2 * shift - shift
    tc[..., 1] += rng.rand(h, w) * 2 * shift - shift
    if zrand:
        tc[..., 2] = rng.rand(h, w)
    return tc.astype(np.float32)


def _pallas(src, tc, radius, tau, block_o, out_hw=None):
    fn = jax.jit(functools.partial(splat_image_fused, radius=radius, tau=tau, out_hw=out_hw,
                                   interpret=True, block_o=block_o, block_s=128))
    return np.asarray(fn(jnp.asarray(src), jnp.asarray(tc)))


@pytest.mark.parametrize("radius,tau", [(1.3, 1.0), (1.0, 0.1), (2.5, 0.5)])
def test_splat_plain_matches_pallas(radius, tau):
    rng = np.random.RandomState(0)
    src = rng.rand(16, 16, 3).astype(np.float32)
    tc = _field(rng, 16, 16)
    got = ks.splat_fused(_t(src), _t(tc), radius, tau).numpy()
    np.testing.assert_allclose(got, _pallas(src, tc, radius, tau, 64), **SPLAT_TOL)


def test_splat_plain_occlusion():
    """Two sources collapse onto one cell: the nearer (smaller z) wins."""
    rng = np.random.RandomState(1)
    src = rng.rand(8, 8, 2).astype(np.float32)
    tc = np.asarray(jcam.identity_field(8, 8)).copy()
    tc[0, 1, 0] = tc[0, 0, 0]          # pixel (0, 1) lands on (0, 0)
    tc[..., 2] = 1.0
    tc[0, 1, 2] = 0.1
    got = ks.splat_fused(_t(src), _t(tc), 1.0, 1.0).numpy()
    np.testing.assert_allclose(got, _pallas(src, tc, 1.0, 1.0, 16), **SPLAT_TOL)
    np.testing.assert_allclose(got[0, 0], src[0, 1], atol=2e-4)


def test_splat_plain_rect_and_out_hw():
    """A rectangular grid, and coordinates mapped to a smaller output."""
    rng = np.random.RandomState(2)
    src = rng.rand(12, 20, 1).astype(np.float32)
    tc = _field(rng, 12, 20, shift=0.05)
    got = ks.splat_fused(_t(src), _t(tc), 1.3, 1.0).numpy()
    np.testing.assert_allclose(got, _pallas(src, tc, 1.3, 1.0, 32), **SPLAT_TOL)
    got = ks.splat_fused(_t(src), _t(tc), 1.3, 1.0, out_hw=(6, 10)).numpy()
    assert got.shape == (6, 10, 1)
    np.testing.assert_allclose(got, _pallas(src, tc, 1.3, 1.0, 16, out_hw=(6, 10)), **SPLAT_TOL)


@pytest.mark.parametrize("field", ["shrink", "collapse"])
def test_splat_plain_matches_pallas_many_points_per_cell(field):
    """Many points a cell: a 32^2 field scaled by 0.25 about the centre
    (16 points a cell), and 256 points collapsed onto one cell beside the
    rest of the identity."""
    rng = np.random.RandomState(3)
    src = rng.rand(32, 32, 4).astype(np.float32)
    tc = _field(rng, 32, 32, shift=0.01)
    if field == "shrink":
        tc[..., :2] *= 0.25
    else:
        tc[8:24, 8:24, :2] = tc[16, 16, :2]
    got = ks.splat_fused(_t(src), _t(tc), 1.3, 1.0).numpy()
    np.testing.assert_allclose(got, _pallas(src, tc, 1.3, 1.0, 1024), **SPLAT_TOL)


def test_splat_plain_equal_bits_twice_at_eight_threads():
    """The plain splat sums each cell in an order fixed by its inputs (a
    binary tree over the cell's contributions sorted by point), so two calls
    at 8 threads give equal bits, on a 256^2 field (2^18 corner terms; an
    op of fewer than 2^15 elements runs on one thread) and with every point
    of a 64^2 block collapsed onto one cell; the tree's sums agree with a
    float64 sum of the same terms to float32 rounding.  The worker threads
    first run one vectorized exp: on some hosts PyTorch's first vectorized
    transcendental op in a new worker thread returns values off by 2^-12 in
    that thread's chunk (exp, log, sqrt, pow alike), which is no property of
    the splat and would otherwise decide the first call's bits."""
    threads = torch.get_num_threads()
    torch.set_num_threads(8)
    try:
        torch.exp(torch.rand(1 << 20))
        rng = np.random.RandomState(11)
        for n, collapse in ((256, False), (128, True)):
            tc = _field(rng, n, n, shift=0.05)
            if collapse:
                tc[40:104, 40:104, :2] = tc[30, 30, :2]
            src, coords = _t(rng.rand(n, n, 4)), _t(tc)
            a = ks.splat_fused_plain(src, coords, 1.3, 1.0, 20.0)
            b = ks.splat_fused_plain(src, coords, 1.3, 1.0, 20.0)
            assert torch.equal(a, b), n
        idx = torch.as_tensor(rng.randint(0, 40, size=5000))
        vals = torch.as_tensor(rng.rand(5000, 3).astype(np.float32))
        exact = torch.zeros(41, 3, dtype=torch.float64).index_add_(0, idx, vals.double())
        np.testing.assert_allclose(ks._cell_sums(idx, vals, 41).numpy(), exact.numpy(),
                                   rtol=1e-5, atol=0)
    finally:
        torch.set_num_threads(threads)


def test_adaptive_step_stitching_matches_jax():
    """The sim-weight schedule over all three phases, with logged sim values
    behind, far ahead of and near the expected loss."""
    defaults = {b: dict(t) for b, t in EditConfig(**STITCH).resolved_loss_weights().items()}
    n, skip = 50, 2
    for sims in ((0.5, 0.05, 0.1, 0.3), (0.01, 0.19, 0.25, 0.0)):
        wj = wt = defaults
        for step in range(0, n, skip):
            sim = sims[(step // skip) % len(sims)]
            wj = jopt.adaptive_step_stitching(wj, defaults, step, skip, n, sim)
            wt = optimization.adaptive_step_stitching(wt, defaults, step, skip, n, sim)
            assert wt == wj, (step, sim)


@pytest.fixture(scope="module")
def stitch_scene():
    """The tests/test_editor.py:27-34 scene as foreground and a second
    seeded image as background.  tx=0.02 moves the object 22 pixels at this
    size (test_editor.py's tx=0.1 moves it out of the 128^2 frame)."""
    rng = np.random.RandomState(0)
    image = rng.rand(SIZE, SIZE, 3).astype(np.float32)
    yy, xx = np.mgrid[0:SIZE, 0:SIZE]
    mask = (((xx - 50) ** 2 + (yy - 70) ** 2) < 25 ** 2).astype(np.float32)
    depth = np.full((SIZE, SIZE), 0.5, np.float32)
    background = np.random.RandomState(7).rand(SIZE, SIZE, 3).astype(np.float32)
    return background, image, mask, depth, jcam.compose_transform(tx=0.02)


def test_stitch_composite_matches_jax(stitch_scene):
    """The composite to 1e-5; the warped mask equal except where its
    splatted value lies within 1e-5 of the binarize threshold, where the
    fused splat and the JAX package's z-min splat may fall apart."""
    bg, fg, mask, depth, transform = stitch_scene
    cj, mj = jeditor.stitch_composite(JEditConfig(**STITCH), bg, fg, mask, depth, transform)
    ct, mt = editor.stitch_composite(EditConfig(**STITCH), bg, fg, mask, depth, transform,
                                     device="cpu")
    assert ct.shape == (SIZE, SIZE, 3) and mt.shape == (SIZE, SIZE)
    # the splatted mask before binarizing, through the port's transform field
    tf = editor.tf_ops.build_transform_field(_t(fg), _t(depth), _t(mask), _t(transform))
    raw = ks.splat_fused(_t(mask)[..., None], tf.coords).numpy()[..., 0]
    near = np.abs(raw - 0.5) <= 1e-5
    assert near.sum() <= 8, near.sum()
    differ = np.asarray(mj) != mt
    assert not (differ & ~near).any()
    assert 0 < mt.sum() < mask.size
    ok = ~(differ[..., None].repeat(3, -1))
    np.testing.assert_allclose(ct[ok], np.asarray(cj)[ok], atol=1e-5, rtol=0)


def test_stitch_composite_uses_the_fused_splat(stitch_scene):
    """The composite's two splats are the fused splat: its plain version on
    the CPU (no kernel launch), within 2e-6 of the z-min splat."""
    bg, fg, mask, depth, transform = stitch_scene
    tf = editor.tf_ops.build_transform_field(_t(fg), _t(depth), _t(mask), _t(transform))
    counts = dict(ks.LAUNCHES)
    fused = ks.splat_fused(_t(fg), tf.coords).numpy()
    assert ks.LAUNCHES == counts
    ref = np.asarray(jax.jit(jsplat.splat_image)(jnp.asarray(fg), jnp.asarray(tf.coords.numpy())))
    np.testing.assert_allclose(fused, ref, atol=2e-6, rtol=0)


def test_stitch_composite_splats_once(stitch_scene, monkeypatch):
    """The composite splats image and mask in one 4-channel call, which
    equals separate image (C=3) and mask (C=1) splats bit for bit."""
    bg, fg, mask, depth, transform = stitch_scene
    calls = []
    splat = ks.splat_fused

    def record(src, coords, *args):
        calls.append((src, coords, args))
        return splat(src, coords, *args)

    monkeypatch.setattr(editor.splat_kernel, "splat_fused", record)
    comp, warped_mask = editor.stitch_composite(EditConfig(**STITCH), bg, fg, mask, depth,
                                                transform, device="cpu")
    assert len(calls) == 1
    src, coords, args = calls[0]
    assert src.shape == (SIZE, SIZE, 4)
    both = splat(src, coords, *args)
    img = splat(src[..., :3].contiguous(), coords, *args)
    msk = splat(src[..., 3:].contiguous(), coords, *args)
    assert torch.equal(both[..., :3], img) and torch.equal(both[..., 3:], msk)
    assert np.array_equal(warped_mask, (msk[..., 0] > 0.5).float().numpy())
    m3 = (msk > 0.5).float()
    want = torch.clamp(img * m3 + _t(bg) * (1.0 - m3), 0, 1).numpy()
    assert np.array_equal(comp, want)


def test_stitch_matches_jax(stitch_scene):
    """One whole tiny perform_stitch at lr=0 (see
    test_torch_port_edit.test_edit_slice_matches_jax): loss logs, the
    stitch's adaptive sim weight, final latents, images and edited image."""
    bg, fg, mask, depth, transform = stitch_scene
    jp = JPipeline.create(JModelConfig.tiny(), image_size=SIZE)
    tp = Pipeline.create(ModelConfig.tiny(), image_size=SIZE, device="cpu")
    tp.load_state_dicts(from_jax_params(jax.tree.map(np.asarray, jp.params), ModelConfig.tiny()))
    js = jeditor.EditSession(jp, JEditConfig(**STITCH, lr=0.0))
    decode = js._decode_bundle_fn()
    final = []   # the JAX run's final [base, edit] latents, as decoded
    js._decode_bundle = lambda p, lat, *a: (final.append(np.asarray(lat)), decode(p, lat, *a))[1]
    jr = jeditor.perform_stitch(jp, bg, fg, mask, depth, transform, cfg=js.cfg, prompt="obj",
                                session=js)
    tr = editor.perform_stitch(tp, bg, fg, mask, depth, transform,
                               cfg=EditConfig(**STITCH, lr=0.0), prompt="obj", device="cpu")
    assert set(tr.loss_log) == set(jr.loss_log) == {0, 1}
    for i in jr.loss_log:
        assert tr.loss_log[i]["num_layers"] == jr.loss_log[i]["num_layers"] > 0
        for key, val in jr.loss_log[i].items():
            tol = dict(rtol=1e-2, atol=1e-4) if key.endswith("removal") else dict(rtol=1e-4, atol=1e-6)
            np.testing.assert_allclose(tr.loss_log[i][key], val, err_msg=f"{i} {key}", **tol)
    assert set(tr.weight_log) == set(jr.weight_log)
    for i, w in jr.weight_log.items():
        assert tr.weight_log[i] == pytest.approx(w, rel=1e-6)
    # the sim weight left its default: the stitch schedule ran
    assert tr.weight_log[0]["self/sim"] != STITCH_SIM
    np.testing.assert_allclose(tr.latents.numpy(), final[0], atol=1e-4, rtol=1e-4)
    assert np.abs(tr.images.astype(int) - jr.images.astype(int)).max() <= 2
    assert np.abs(tr.edited_image.astype(int) - jr.edited_image.astype(int)).max() <= 4

