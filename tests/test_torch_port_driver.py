"""The port's batch driver and its pieces against the JAX package, on the CPU:
`Pipeline.create` from a checkpoint, the process share and the driver's
per-type configs, a tiny folder sweep end to end (ModelConfig.tiny(), 64^2,
2 DDIM steps) and the remaining ops of `ops/splat.py`, `ops/camera.py` and
`ops/image.py`.
"""

import dataclasses
import functools
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from geodiffuser_tpu.config import ModelConfig as JModelConfig
from geodiffuser_tpu.config import SchedulerConfig as JSchedulerConfig
from geodiffuser_tpu.core import editor as jeditor
from geodiffuser_tpu.core import scheduler as jsched
from geodiffuser_tpu.core.pipeline import Pipeline as JPipeline
from geodiffuser_tpu.models import tokenizer as jtok
from geodiffuser_tpu.models import weights as jweights
from geodiffuser_tpu.models.clip_text import CLIPTextEncoder as JCLIPTextEncoder
from geodiffuser_tpu.models.unet import UNet2DCondition as JUNet
from geodiffuser_tpu.models.vae import AutoencoderKL as JVAE
from geodiffuser_tpu.ops import camera as jcam
from geodiffuser_tpu.ops import image as jimage
from geodiffuser_tpu.ops import splat as jsplat
from geodiffuser_tpu.parallel import driver as jdriver
from geodiffuser_tpu.parallel import sharding as jsharding
from geodiffuser_tpu_torch.config import ModelConfig
from geodiffuser_tpu_torch.core import inversion
from geodiffuser_tpu_torch.core.editor import EditSession
from geodiffuser_tpu_torch.core.pipeline import Pipeline
from geodiffuser_tpu_torch.kernels import splat as ks
from geodiffuser_tpu_torch.models.tokenizer import CLIPTokenizer
from geodiffuser_tpu_torch.ops import camera, splat
from geodiffuser_tpu_torch.ops import image as image_ops
from geodiffuser_tpu_torch.ops import transform_field as tf_ops
from geodiffuser_tpu_torch.parallel import driver, sharding
from geodiffuser_tpu_torch.utils import exp_io, png
from test_torch_port_io import _jax_init_params, write_checkpoint, write_toy_tokenizer

torch.set_num_threads(1)

SIZE = 64
STEPS = dict(num_ddim_steps=2)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def test_pipeline_from_checkpoint_encodes_text_as_jax(tmp_path):
    """Pipeline.create(checkpoint_dir=...) loads the weights and the BPE
    tokenizer; its encode_text equals the JAX pipeline's on the same
    checkpoint (atol 1e-5, float32)."""
    ckpt = str(tmp_path)
    write_checkpoint(ckpt, seed=3)
    write_toy_tokenizer(ckpt)
    pipe = Pipeline.create(ModelConfig.tiny(), image_size=SIZE, checkpoint_dir=ckpt,
                           device="cpu")
    assert isinstance(pipe.tokenizer, CLIPTokenizer)
    jcfg = JModelConfig.tiny()
    jpipe = JPipeline(
        config=jcfg, unet=JUNet(jcfg), vae=JVAE(jcfg), text_encoder=JCLIPTextEncoder(jcfg),
        params=jweights.load_sd_checkpoint(ckpt, _jax_init_params(jcfg), jcfg),
        tokenizer=jtok.load_tokenizer(ckpt, jcfg.text_vocab_size, jcfg.text_max_length),
        schedule=jsched.make_schedule(JSchedulerConfig()), image_size=SIZE)
    prompts = ["a photo of the cat", "", "the dog's big red house, on a mat!"]
    got = pipe.encode_text(prompts).numpy()
    want = np.asarray(jpipe.encode_text(prompts))
    assert got.shape == want.shape == (3, 77, jcfg.cross_attention_dim)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    images = np.random.RandomState(0).rand(2, SIZE, SIZE, 3).astype(np.float32)
    batch = pipe.encode_images(_t(images))
    assert batch.shape == (2, SIZE // 8, SIZE // 8, 4)
    for i in range(2):
        assert torch.equal(batch[i:i + 1], pipe.encode_image(_t(images[i])))


def test_partition_and_group_size_match_jax(monkeypatch):
    items = [("geometry_editor", f"f{i}") for i in range(11)]
    for n_proc in range(1, 5):
        shares = []
        for pid in range(n_proc):
            got = sharding.partition_for_process(items, n_proc, pid)
            assert got == jsharding.partition_for_process(items, n_proc, pid), (n_proc, pid)
            shares += got
        assert sorted(shares) == sorted(items)
    assert sharding.auto_group_size(512) == 0 == sharding.auto_group_size(256)
    assert (sharding.process_count(), sharding.process_index()) == (1, 0)
    monkeypatch.setenv("GEODIFF_NUM_PROCESSES", "3")
    monkeypatch.setenv("GEODIFF_PROCESS_ID", "2")
    assert sharding.partition_for_process(items) == items[2::3]
    monkeypatch.setenv("GEODIFF_PROCESS_ID", "3")
    with pytest.raises(ValueError, match="GEODIFF_PROCESS_ID"):
        sharding.process_index()


def _plain(value):
    """dataclasses.asdict values with dtypes by name."""
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    if isinstance(value, (torch.dtype, np.dtype)) or type(value).__name__ == "_ScalarMeta":
        return str(value).replace("torch.", "")
    return value


@pytest.mark.parametrize("edit_type", ["geometry_editor", "geometry_remover", "geometry_stitch"])
def test_config_for_edit_type_matches_jax(edit_type):
    got = _plain(dataclasses.asdict(driver.config_for_edit_type(edit_type, 37)))
    want = _plain(dataclasses.asdict(jdriver.config_for_edit_type(edit_type, 37)))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == want[k], k
    assert driver.REMOVER_SWEEP_WEIGHTS == jdriver.REMOVER_SWEEP_WEIGHTS


# ---------------------------------------------------------------------------
# The sweep
# ---------------------------------------------------------------------------

def _scene(seed=0):
    rng = np.random.RandomState(seed)
    image = (rng.rand(SIZE, SIZE, 3) * 255).astype(np.uint8)
    yy, xx = np.mgrid[0:SIZE, 0:SIZE]
    mask = (((xx - 25) ** 2 + (yy - 35) ** 2) < 12 ** 2).astype(np.float32)
    depth = np.full((SIZE, SIZE), 0.5, np.float32)
    background = (rng.rand(SIZE, SIZE, 3) * 255).astype(np.uint8)
    return image, depth, mask, background


FOLDERS = {"editor": "Translation_3D/0", "remover": "Removal/0", "stitch": "stitch/0"}


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    """An experiment tree (editor, remover, stitch folders, a skipped
    Scaling folder and a non-experiment directory) swept once with the
    native prefetcher."""
    root = str(tmp_path_factory.mktemp("exps"))
    image, depth, mask, background = _scene()
    exp_io.save_exp(os.path.join(root, FOLDERS["editor"]), image, depth, mask,
                    camera.compose_transform(tx=0.05), image_shape=(48, 80))
    exp_io.save_exp(os.path.join(root, FOLDERS["remover"]), image, depth, mask, np.eye(4),
                    image_shape=(SIZE, SIZE))
    exp_io.save_exp(os.path.join(root, FOLDERS["stitch"]), image, depth, mask,
                    camera.compose_transform(tx=0.02), background_image=background,
                    image_shape=(SIZE, SIZE))
    exp_io.save_exp(os.path.join(root, "Scaling/0"), image, depth, mask, np.eye(4))
    os.makedirs(os.path.join(root, "Mix", "notes"))
    pipe = Pipeline.create(ModelConfig.tiny(), image_size=SIZE, device="cpu")
    times = driver.run_folder_sweep(root, pipe=pipe, config_overrides=STEPS, use_native=True,
                                    device="cpu")
    return root, pipe, times


def _folder(root, kind):
    return os.path.join(root, FOLDERS[kind])


def test_sweep_writes_results_and_skips_them(sweep):
    root, pipe, times = sweep
    assert sorted(times) == sorted(_folder(root, k) for k in FOLDERS)
    for kind in FOLDERS:
        folder = _folder(root, kind)
        result = png.read_png(os.path.join(folder, "result_ls.png"))
        assert result.shape == (SIZE, SIZE, 3) and result.std() > 0
        with open(os.path.join(folder, "loss_log.json")) as f:
            logs = json.load(f)
        assert logs and all(np.isfinite(v) for lg in logs.values() for v in lg.values())
        assert os.path.exists(os.path.join(folder, exp_io.INVERSION_CACHE_FILE))
    resized = png.read_png(os.path.join(_folder(root, "editor"), "resized_result_ls.png"))
    assert resized.shape == (48, 80, 3)
    assert not os.path.exists(os.path.join(root, "Scaling/0", "result_ls.png"))
    assert driver.run_folder_sweep(root, pipe=pipe, config_overrides=STEPS, device="cpu") == {}


def test_rerun_reads_every_inversion_from_the_cache(sweep, monkeypatch):
    """skip_existing=False runs all three again, in new sessions, and none
    inverts: every trajectory comes from its folder's inversion.npz; the
    results are those of the first sweep."""
    root, pipe, _ = sweep
    before = {k: png.read_png(os.path.join(_folder(root, k), "result_ls.png")) for k in FOLDERS}
    calls = []
    invert = inversion.ddim_invert
    monkeypatch.setattr(inversion, "ddim_invert", lambda *a, **kw: (calls.append(1),
                                                                    invert(*a, **kw))[1])
    times = driver.run_folder_sweep(root, pipe=pipe, config_overrides=STEPS, use_native=False,
                                    skip_existing=False, device="cpu")
    assert len(times) == 3 and calls == []
    for kind in FOLDERS:
        after = png.read_png(os.path.join(_folder(root, kind), "result_ls.png"))
        np.testing.assert_array_equal(after, before[kind], err_msg=kind)


def test_sweep_editor_equals_a_direct_session(sweep):
    root, pipe, _ = sweep
    folder = _folder(root, "editor")
    exp = exp_io.read_exp(folder)
    cfg = dataclasses.replace(driver.config_for_edit_type("geometry_editor"), **STEPS)
    res = EditSession(pipe, cfg, device="cpu").run(exp.input_image, exp.depth, exp.input_mask,
                                                   exp.transform)
    np.testing.assert_array_equal(png.read_png(os.path.join(folder, "result_ls.png")),
                                  res.edited_image)


def test_stitch_inputs_match_jax_driver(sweep):
    """The stitch folder's pre-composite equals the JAX driver's (its
    stitch_composite, 64^2, the tuned stitch config): the composite to
    1e-5 and the warped mask exactly, except where the splatted mask lies
    within 1e-5 of the binarize threshold (tests/test_torch_port_stitch.py)."""
    root, _, _ = sweep
    exp = exp_io.read_exp(_folder(root, "stitch"))
    cfg = driver.config_for_edit_type("geometry_stitch")
    comp, dep, wmask, eye = driver.edit_inputs("geometry_stitch", exp, cfg, device="cpu")
    jcfg = jdriver.config_for_edit_type("geometry_stitch")
    jcomp, jwmask = jeditor.stitch_composite(jcfg, exp.background_image, exp.input_image,
                                             exp.input_mask, exp.depth, exp.transform)
    np.testing.assert_array_equal(dep, np.full((SIZE, SIZE), 0.5, np.float32))
    np.testing.assert_array_equal(eye, np.eye(4, dtype=np.float32))
    s = cfg.splat
    fg = _t(exp.input_image.astype(np.float32) / 255.0)
    tf = tf_ops.build_transform_field(fg, _t(exp.depth), _t(exp.input_mask), _t(exp.transform),
                                      focal_length=cfg.focal_length, splat_radius=s.radius,
                                      splat_tau=s.tau, z_beta=s.z_beta)
    raw = ks.splat_fused(_t(exp.input_mask)[..., None], tf.coords, s.radius, s.tau,
                         s.z_beta).numpy()[..., 0]
    near = np.abs(raw - 0.5) <= 1e-5
    differ = np.asarray(jwmask) != wmask
    assert not (differ & ~near).any() and 0 < wmask.sum() < wmask.size
    ok = ~differ[..., None].repeat(3, -1)
    np.testing.assert_allclose(comp[ok], np.asarray(jcomp)[ok], atol=1e-5, rtol=0)
    image, _, mask, transform = driver.edit_inputs("geometry_editor", exp, cfg, device="cpu")
    assert image is exp.input_image and transform is exp.transform


def test_driver_refuses_the_lockstep_batch_and_a_missing_card(tmp_path, monkeypatch):
    """group_size > 1 raises (the lockstep batch is not ported) rather than
    running the sequential path; the default device is the card, which
    raises without one."""
    with pytest.raises(NotImplementedError, match="lockstep"):
        driver.run_folder_sweep(str(tmp_path), group_size=2, device="cpu")
    with pytest.raises(NotImplementedError, match="lockstep"):
        driver.main([str(tmp_path), "--group-size", "2", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        driver.run_folder_sweep(str(tmp_path))


# ---------------------------------------------------------------------------
# The remaining ops, each against its JAX counterpart (jitted)
# ---------------------------------------------------------------------------

def _field(rng, h, w, shift=0.15):
    tc = np.asarray(jcam.identity_field(h, w)).copy()
    tc[..., :2] += rng.rand(h, w, 2) * 2 * shift - shift
    tc[..., 2] = 0.5 + rng.rand(h, w)
    return tc.astype(np.float32)


def test_splat_batch_and_warp_field_match_jax():
    """float32 scatter sums in another order: atol 2e-6 on [0, 1] values."""
    rng = np.random.RandomState(0)
    src = rng.rand(2, 12, 12, 3).astype(np.float32)
    coords = np.stack([_field(rng, 12, 12), _field(rng, 12, 12)])
    kw = dict(radius=1.3, tau=0.5, z_beta=20.0)
    want = jax.jit(functools.partial(jsplat.splat_batch, **kw))(src, coords)
    np.testing.assert_allclose(splat.splat_batch(_t(src), _t(coords), **kw).numpy(),
                               np.asarray(want), atol=2e-6, rtol=0)
    for use_splat in (True, False):
        fn = jax.jit(functools.partial(jsplat.warp_field, use_splat=use_splat, **kw))
        got = splat.warp_field(_t(src[0]), _t(coords[0]), use_splat=use_splat, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(fn(src[0], coords[0])), atol=2e-6,
                                   rtol=0)


@pytest.mark.parametrize("padding", ["zeros", "reflection"])
def test_grid_sample_matches_jax(padding):
    """Sampling points up to 0.3 past the border (bilinear weights computed
    in another order: atol 1e-5)."""
    rng = np.random.RandomState(1)
    src = rng.rand(10, 14, 3).astype(np.float32)
    coords = (rng.rand(9, 11, 2) * 2.6 - 1.3).astype(np.float32)
    coords[0, :3] = [[-1, -1], [1, 1], [0.5, -1]]          # on the border
    want = jax.jit(functools.partial(jsplat.grid_sample, padding=padding))(src, coords)
    got = splat.grid_sample(_t(src), _t(coords), padding=padding)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="padding"):
        splat.grid_sample(_t(src), _t(coords), padding="border")


SOFTSPLAT_MODES = [m + e for m in ("avg", "linear", "soft")
                   for e in ("", "-addeps", "-zeroeps", "-clipeps")] + ["sum"]


@pytest.mark.parametrize("mode", SOFTSPLAT_MODES)
def test_softsplat_matches_jax(mode):
    """A flow of up to 4 pixels, half the corners outside the image on the
    border rows; atol 1e-5, rtol 1e-5 (normalised sums of float32 scatter
    adds in another order)."""
    rng = np.random.RandomState(2)
    src = rng.rand(10, 12, 3).astype(np.float32)
    flow = (rng.rand(10, 12, 2) * 8 - 4).astype(np.float32)
    flow[:3] = np.round(flow[:3])                           # integer flows: exact hits
    metric = None if mode.split("-")[0] in ("sum", "avg") else rng.randn(10, 12).astype(
        np.float32)
    fn = jax.jit(functools.partial(jsplat.softsplat, mode=mode))
    want = fn(src, flow, metric)
    got = splat.softsplat(_t(src), _t(flow), None if metric is None else _t(metric), mode=mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_softsplat_refuses_unknown_modes_and_metrics():
    src, flow = torch.zeros(4, 4, 3), torch.zeros(4, 4, 2)
    for mode in ("max", "soft-noeps"):
        with pytest.raises(ValueError, match="unknown softsplat"):
            splat.softsplat(src, flow, torch.zeros(4, 4), mode=mode)
    with pytest.raises(ValueError, match="needs a metric"):
        splat.softsplat(src, flow, mode="soft")
    with pytest.raises(ValueError, match="takes no metric"):
        splat.softsplat(src, flow, torch.zeros(4, 4), mode="avg")


def _camera_case(rng, h=12, w=16):
    depth = (0.5 + rng.rand(h, w)).astype(np.float32)
    intrinsics = np.asarray(jcam.camera_matrix(20.0, h, w))
    transform = jcam.compose_transform(tx=0.05, ry=10.0, sz=1.1).astype(np.float32)
    mask = np.zeros((h, w), np.float32)
    mask[3:8, 4:10] = 1.0
    return depth, intrinsics, transform, mask


def test_transform_field_matches_jax():
    """atol 1e-5 on NDC coordinates and depths (matrix products in another
    order)."""
    args = _camera_case(np.random.RandomState(3))
    want = jax.jit(jcam.transform_field)(*args)
    got = camera.transform_field(*map(_t, args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_cam2pixel_occlusion_and_backward_warp_match_jax():
    """The field exactly where both round every target to the same cell (a
    point that lands within 1e-4 of a rounding edge may pick its
    neighbour), then the warp of an image by the JAX field, atol 1e-5."""
    depth, intrinsics, transform, _ = _camera_case(np.random.RandomState(4))
    cam = jcam.pixel2cam(jnp.asarray(depth), jnp.linalg.inv(intrinsics))
    rot, tr = transform[:3, :3], transform[:3, 3:4]
    want = np.asarray(jax.jit(jcam.cam2pixel_occlusion)(cam, rot, tr, intrinsics))
    got = camera.cam2pixel_occlusion(_t(cam), _t(rot), _t(tr), _t(intrinsics)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    image = np.random.RandomState(5).rand(12, 16, 3).astype(np.float32)
    warped = camera.backward_warp(_t(image), _t(want)).numpy()
    np.testing.assert_allclose(warped, np.asarray(jax.jit(jcam.backward_warp)(image, want)),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("k", [1, 2])
def test_max_pool_same_matches_jax(k):
    mask = (np.random.RandomState(6).rand(9, 13) > 0.8).astype(np.float32) * 0.7
    want = jax.jit(functools.partial(jimage.max_pool_same, k=k))(mask)
    np.testing.assert_array_equal(image_ops.max_pool_same(_t(mask), k).numpy(),
                                  np.asarray(want))


def test_adain_matches_jax():
    """Per-channel statistics over the token axis (atol 1e-5: float32
    means and variances summed in another order)."""
    rng = np.random.RandomState(7)
    feat = rng.randn(2, 50, 8).astype(np.float32)
    ref = (rng.randn(2, 50, 8) * 3 + 1).astype(np.float32)
    for axis in (-2, -1):
        want = jax.jit(functools.partial(jimage.adain, axis=axis))(feat, ref)
        got = image_ops.adain(_t(feat), _t(ref), dim=axis)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
