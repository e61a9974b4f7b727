"""The port's SD-2.1 geometry and evaluation package against the JAX package,
on the CPU: ModelConfig.tiny_sd21() in float32 (the UNet with its up-block
taps, the gelu text tower, the DIFT per-draw features and the MD metric),
the CLIP vision tower and LPIPS, each on seeded random weights in its
published layout; the offline metrics, keypoints, FID/IS math, the study
tools, the attention visualization and the evaluation CLI's JSON;
Pillow-exact bilinear and nearest resizes against PIL.

The tiny SD-2.1 pipeline's weights are the port's seeded random init,
carried into the JAX package by its own diffusers-layout converters
(`models/weights.py`: convert_unet, convert_vae, convert_clip_text), so no
JAX init program is compiled; `from_jax_params` on the SD-2.1 layout is held
by test_sd21_checkpoint_loads_as_jax.  Each JAX program is jitted once in
this module.
"""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from geodiffuser_tpu.config import ModelConfig as JModelConfig
from geodiffuser_tpu.config import SchedulerConfig as JSchedulerConfig
from geodiffuser_tpu.core import scheduler as jsched
from geodiffuser_tpu.core.pipeline import Pipeline as JPipeline
from geodiffuser_tpu.evaluation import dift as jdift
from geodiffuser_tpu.evaluation import fid as jfid
from geodiffuser_tpu.evaluation import lpips as jlpips
from geodiffuser_tpu.evaluation import metrics as jmetrics
from geodiffuser_tpu.evaluation import study as jstudy
from geodiffuser_tpu.evaluation import __main__ as jcli
from geodiffuser_tpu.models import tokenizer as jtok
from geodiffuser_tpu.models import weights as jweights
from geodiffuser_tpu.models.clip_text import CLIPTextEncoder as JCLIPTextEncoder
from geodiffuser_tpu.models.clip_vision import CLIPVisionConfig as JCLIPVisionConfig
from geodiffuser_tpu.models.clip_vision import CLIPVisionEncoder as JCLIPVisionEncoder
from geodiffuser_tpu.models.clip_vision import preprocess_clip_image as jpreprocess
from geodiffuser_tpu.models.unet import UNet2DCondition as JUNet
from geodiffuser_tpu.models.vae import AutoencoderKL as JVAE
from geodiffuser_tpu.ops import camera as jcam
from geodiffuser_tpu.utils import attention_vis as jav
from geodiffuser_tpu.utils import exp_io as jexp_io
from geodiffuser_tpu_torch.config import ModelConfig
from geodiffuser_tpu_torch.core.pipeline import Pipeline
from geodiffuser_tpu_torch.evaluation import dift, fid, lpips, metrics, study
from geodiffuser_tpu_torch.evaluation import __main__ as cli
from geodiffuser_tpu_torch.models import weights
from geodiffuser_tpu_torch.models.clip_text import CLIPTextEncoder
from geodiffuser_tpu_torch.models.clip_vision import (CLIPVisionConfig, CLIPVisionEncoder,
                                                      preprocess_clip_image)
from geodiffuser_tpu_torch.models.unet import UNet2DCondition
from geodiffuser_tpu_torch.utils import attention_vis as av
from geodiffuser_tpu_torch.utils import png

pytest_plugins = ("heap_trim",)

torch.set_num_threads(1)

SIZE = 64
# float32 models on both sides, summed in another order
MODEL_TOL = dict(atol=2e-5, rtol=1e-4)
# float32 metrics computed in another order (splat sums, box filters)
METRIC_TOL = dict(atol=1e-6, rtol=1e-5)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


@pytest.fixture(scope="module")
def pipes():
    """(JAX pipeline, port pipeline) on the port's random init from seed 0."""
    tp = Pipeline.create(ModelConfig.tiny_sd21(), image_size=SIZE, seed=0, device="cpu")
    state = {name: {k: v.numpy() for k, v in m.state_dict().items()}
             for name, m in tp.modules().items()}
    jcfg = JModelConfig.tiny_sd21()
    params = {"unet": jweights.convert_unet(state["unet"]),
              "vae": jweights.convert_vae(state["vae"]),
              "text": jweights.convert_clip_text(state["text"])}
    jp = JPipeline(config=jcfg, unet=JUNet(jcfg), vae=JVAE(jcfg),
                   text_encoder=JCLIPTextEncoder(jcfg), params=jax.tree.map(jnp.asarray, params),
                   tokenizer=jtok.load_tokenizer(None, jcfg.text_vocab_size, jcfg.text_max_length),
                   schedule=jsched.make_schedule(JSchedulerConfig()), image_size=SIZE)
    return jp, tp


@pytest.fixture(scope="module")
def jax_featurizer(pipes):
    """The JAX featurizer (its per-draw program compiles once)."""
    return jdift.SDFeaturizer(pipes[0], t=261, up_block=1, ensemble=2)


def _scene(rng, size=SIZE):
    """A dim noise background and a brighter textured box, the box's mask."""
    y0, y1, x0, x1 = size // 4, size * 11 // 16, size * 5 // 16, size * 5 // 8
    img = rng.rand(size, size, 3).astype(np.float32) * 0.3
    img[y0:y1, x0:x1] += 0.7 * rng.rand(y1 - y0, x1 - x0, 3)
    mask = np.zeros((size, size), np.float32)
    mask[y0:y1, x0:x1] = 1.0
    return np.clip(img, 0, 1), mask


# ---------------------------------------------------------------------------
# SD-2.1 geometry
# ---------------------------------------------------------------------------

def test_sd21_unet_and_up_block_taps_match_jax(pipes):
    """Per-block heads (1, 2, 2, 2), Linear projections: the noise
    prediction and every up block's tap (before its upsampler) against the
    JAX UNet applied with mutable=["features"]."""
    jp, tp = pipes
    unet = tp.unet
    assert isinstance(unet.down_blocks[0].attentions[0].proj_in, torch.nn.Linear)
    heads = [unet.down_blocks[i].attentions[0].transformer_blocks[0].attn1.heads for i in range(3)]
    heads += [unet.mid_block.attentions[0].transformer_blocks[0].attn1.heads]
    heads += [unet.up_blocks[i].attentions[0].transformer_blocks[0].attn1.heads for i in (1, 2, 3)]
    assert heads == [1, 2, 2, 2, 2, 2, 1]
    rng = np.random.RandomState(0)
    lat = rng.randn(2, SIZE // 8, SIZE // 8, 4).astype(np.float32)
    ctx = rng.randn(2, 77, 32).astype(np.float32)
    eps_j, aux = jax.jit(lambda p, x, c: jp.unet.apply(p, x, jnp.int32(261), c,
                                                       mutable=["features"]))(
        jp.params["unet"], jnp.asarray(lat), jnp.asarray(ctx))
    eps_t, taps = tp.unet(_t(lat), 261, _t(ctx), features=True)
    np.testing.assert_allclose(eps_t.numpy(), np.asarray(eps_j), **MODEL_TOL)
    assert set(taps) == set(aux["features"]) == {f"up_block_{i}" for i in range(4)}
    for name, (tap_j,) in aux["features"].items():
        np.testing.assert_allclose(taps[name].numpy(), np.asarray(tap_j), err_msg=name,
                                   **MODEL_TOL)
    assert taps["up_block_1"].shape == (2, 2, 2, 64)   # 1/4 of the latent, before upsampling
    np.testing.assert_array_equal(tp.unet(_t(lat), 261, _t(ctx)).numpy(), eps_t.numpy())


def test_sd21_text_tower_gelu_matches_jax(pipes):
    jp, tp = pipes
    prompts = ["a photo of a cat", ""]
    np.testing.assert_allclose(tp.encode_text(prompts).numpy(),
                               np.asarray(jp.encode_text(prompts)), **MODEL_TOL)
    assert ModelConfig.sd21().text_hidden_act == JModelConfig.sd21().text_hidden_act == "gelu"


def test_sd21_config_and_checkpoint_manifests():
    """`sd21()` equals the JAX config field for field (dtypes aside), and a
    Linear-projection config loads its checkpoint against the SD-2.1
    manifests, whose keys and shapes the full-size modules have."""
    a, b = ModelConfig.sd21(), JModelConfig.sd21()
    for f in ("attention_head_dims", "cross_attention_dim", "use_linear_projection",
              "text_hidden_size", "text_layers", "text_heads", "text_hidden_act",
              "block_out_channels", "num_attention_heads"):
        assert getattr(a, f) == getattr(b, f), f
    assert [a.heads_for_block(i) for i in range(4)] == [b.heads_for_block(i) for i in range(4)]
    assert weights.components(a)["unet"][1] == "sd21_unet.json"
    assert weights.components(ModelConfig())["unet"][1] == "sd14_unet.json"
    with torch.device("meta"):
        pipe_mods = {"unet": UNet2DCondition(a), "text": CLIPTextEncoder(a)}
    for name, module in pipe_mods.items():
        manifest = weights.components(a)[name][1]
        with open(weights.MANIFESTS / manifest) as f:
            m = json.load(f)
        want = {k: tuple(s) for k, s in m["keys"].items() if k not in m["unconsumed"]}
        assert {k: tuple(v.shape) for k, v in module.state_dict().items()} == want, name


def test_sd21_checkpoint_loads_as_jax(tmp_path):
    """A tiny SD-2.1 diffusers checkpoint (the text encoder with its unused
    position_ids) through `Pipeline.create(checkpoint_dir=...)` equals the
    JAX loader's result carried over by from_jax_params."""
    from safetensors.numpy import save_file

    from test_torch_port_io import _jax_init_params

    cfg = ModelConfig.tiny_sd21()
    rng = np.random.RandomState(3)
    pipe = Pipeline.create(cfg, image_size=SIZE, device="cpu")
    states = {name: {k: (rng.randn(*v.shape) * 0.1).astype(np.float32)
                     for k, v in m.state_dict().items()} for name, m in pipe.modules().items()}
    states["text"]["text_model.embeddings.position_ids"] = np.arange(77)[None]
    for name, (rel, _) in weights.components(cfg).items():
        os.makedirs(os.path.dirname(tmp_path / rel), exist_ok=True)
        save_file(states[name], str(tmp_path / rel))
    loaded = Pipeline.create(cfg, image_size=SIZE, checkpoint_dir=str(tmp_path), device="cpu")
    jcfg = JModelConfig.tiny_sd21()
    jparams = jweights.load_sd_checkpoint(str(tmp_path), _jax_init_params(jcfg), jcfg)
    ref = weights.from_jax_params(jax.tree.map(np.asarray, jparams), cfg)
    for name, module in loaded.modules().items():
        got = module.state_dict()
        assert set(got) == set(ref[name]), name
        for k, v in ref[name].items():
            assert torch.equal(got[k], v), (name, k)


# ---------------------------------------------------------------------------
# Pretrained towers on random weights in their published layouts
# ---------------------------------------------------------------------------

def test_clip_vision_matches_jax():
    """CLIPVisionConfig.tiny(): an HF-layout state_dict (with the unused
    position_ids) loads into the port as it is and into the JAX tower by
    its converter; preprocessing and embeddings agree."""
    torch.manual_seed(0)
    model = CLIPVisionEncoder(CLIPVisionConfig.tiny()).eval()
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    published = dict(state, **{"vision_model.embeddings.position_ids": torch.arange(17)[None]})
    model.load_state_dict(weights.convert_clip_vision(published), strict=True)
    jparams = jweights.convert_clip_vision({k: v.numpy() for k, v in published.items()})
    rng = np.random.RandomState(1)
    imgs = [(rng.rand(48, 40, 3) * 255).astype(np.uint8), rng.rand(20, 30, 3).astype(np.float32)]
    jmodel = JCLIPVisionEncoder(JCLIPVisionConfig.tiny())
    apply = jax.jit(jmodel.apply)
    for img in imgs:
        x_j = jpreprocess(img, 32)
        x_t = preprocess_clip_image(img, 32)
        np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), atol=1e-5, rtol=1e-5)
        with torch.no_grad():
            e_t = model(x_t).numpy()
        np.testing.assert_allclose(e_t, np.asarray(apply(jparams, x_j)), **MODEL_TOL)


def _alexnet_state(rng):
    """torchvision AlexNet (features and an unused classifier entry) and the
    lpips linear heads, He-scaled random weights."""
    alex = {}
    for idx, (cin, cout, k, _, _) in lpips.ALEX_CONVS.items():
        alex[f"features.{idx}.weight"] = rng.randn(cout, cin, k, k) * np.sqrt(2.0 / (cin * k * k))
        alex[f"features.{idx}.bias"] = rng.randn(cout) * 0.1
    alex["classifier.1.weight"] = rng.randn(4, 9216) * 0.01
    lin = {f"lin{i}.model.1.weight": np.abs(rng.randn(1, c, 1, 1)) * 0.1
           for i, c in enumerate(lpips.ALEX_CHANNELS)}
    as_t = lambda d: {k: torch.from_numpy(v.astype(np.float32)) for k, v in d.items()}
    return as_t(alex), as_t(lin)


@pytest.fixture(scope="module")
def lpips_weights(tmp_path_factory):
    """alexnet.pth and lpips_alex.pth (torch.save), and the JAX metric on
    the same weights (its program compiles once)."""
    alex, lin = _alexnet_state(np.random.RandomState(5))
    root = tmp_path_factory.mktemp("lpips_weights")
    torch.save(alex, root / "alexnet.pth")
    torch.save(lin, root / "lpips_alex.pth")
    np_state = lambda d: {k: v.numpy() for k, v in d.items()}
    jmetric = jlpips.LPIPSMetric(params=jlpips.convert_lpips(np_state(alex), np_state(lin)))
    return str(root), alex, lin, jmetric


def test_lpips_matches_jax(lpips_weights):
    """LPIPS(alex) at 224^2 on seeded image pairs, from a state_dict and
    from the .pth files; 0 for equal images."""
    root, alex, lin, jmetric = lpips_weights
    metric = lpips.LPIPSMetric(state=lpips.convert_lpips(alex, lin), device="cpu")
    rng = np.random.RandomState(6)
    a = (rng.rand(48, 40, 3) * 255).astype(np.uint8)
    b = np.clip(a.astype(int) + rng.randint(-40, 40, a.shape), 0, 255).astype(np.uint8)
    got = metric(a, b)
    np.testing.assert_allclose(got, jmetric(a, b), rtol=1e-4, atol=1e-6)
    assert got > 0 and metric(a, a) == 0.0
    np.testing.assert_allclose(metrics.lpips(a, b, weights_dir=root, device="cpu"), got,
                               rtol=1e-6)


def test_weight_gated_metrics_say_unavailable(tmp_path):
    for fn in (metrics.lpips, metrics.clip_similarity):
        with pytest.raises(metrics.PretrainedWeightsUnavailable):
            fn(np.zeros((8, 8, 3)), np.zeros((8, 8, 3)), weights_dir=None, device="cpu")
        with pytest.raises(metrics.PretrainedWeightsUnavailable, match="does not exist"):
            fn(np.zeros((8, 8, 3)), np.zeros((8, 8, 3)), weights_dir=str(tmp_path), device="cpu")
    with pytest.raises(metrics.PretrainedWeightsUnavailable):
        fid.CLIPFeatureExtractor(weights_dir=str(tmp_path), device="cpu")


# ---------------------------------------------------------------------------
# Offline metrics, keypoints, FID
# ---------------------------------------------------------------------------

def test_psnr_ssim_background_match_jax():
    rng = np.random.RandomState(7)
    a = rng.rand(40, 48, 3).astype(np.float32)
    b = np.clip(a + rng.randn(*a.shape).astype(np.float32) * 0.05, 0, 1)
    mask = (rng.rand(40, 48) > 0.6).astype(np.float32)
    assert metrics.psnr(a, b) == jmetrics.psnr(a, b)
    assert metrics.psnr(a * 255, b * 255, mask) == jmetrics.psnr(a * 255, b * 255, mask)
    np.testing.assert_allclose(metrics.ssim(a, b, device="cpu"), jmetrics.ssim(a, b), **METRIC_TOL)
    np.testing.assert_allclose(metrics.ssim(a * 255, b * 255, window=5, device="cpu"),
                               jmetrics.ssim(a * 255, b * 255, window=5), **METRIC_TOL)
    assert metrics.background_preservation(a, b, mask) == \
        jmetrics.background_preservation(a, b, mask)


def test_warp_error_and_bundle_match_jax():
    """The splat-warped source's masked L1 and the offline bundle of one
    experiment, on a transform field built by the JAX package."""
    rng = np.random.RandomState(8)
    img, mask = _scene(rng, 32)
    t_coords = np.asarray(jcam.identity_field(32, 32)) + np.array([0.1, -0.05, 0.0], np.float32)
    warped = np.roll(mask, (-1, 2), axis=(0, 1))
    edited = np.clip(img + rng.randn(*img.shape).astype(np.float32) * 0.1, 0, 1)
    np.testing.assert_allclose(metrics.warp_error(edited, img, t_coords, warped, device="cpu"),
                               jmetrics.warp_error(edited, img, t_coords, warped), **METRIC_TOL)
    exp = jexp_io.Experiment(input_image=(img * 255).astype(np.uint8), input_mask=mask,
                             depth=np.full((32, 32), 0.5, np.float32), transform=np.eye(4),
                             image_shape=np.array([32, 32]))
    got = metrics.evaluate_experiment(exp, (edited * 255).astype(np.uint8), t_coords, warped,
                                      device="cpu")
    ref = jmetrics.evaluate_experiment(exp, (edited * 255).astype(np.uint8), t_coords, warped)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], err_msg=k, **METRIC_TOL)


def test_frechet_distance_and_inception_score_match_jax():
    rng = np.random.RandomState(9)
    fa, fb = rng.randn(20, 6), rng.randn(24, 6) * 1.3 + 0.2
    assert fid.fid_score(fa, fb) == jfid.fid_score(fa, fb)
    mu, sigma = fid.fit_gaussian(fa)
    np.testing.assert_array_equal(sigma, jfid.fit_gaussian(fa)[1])
    assert fid.frechet_distance(mu, sigma, mu, sigma) == jfid.frechet_distance(mu, sigma, mu, sigma)
    logits = rng.randn(30, 10)
    assert fid.inception_score(logits, splits=3) == jfid.inception_score(logits, splits=3)


def test_keypoints_equal_jax():
    """The DoG detector, Harris corners and the fallback between them give
    the JAX package's arrays."""
    rng = np.random.RandomState(10)
    img = np.zeros((64, 64))
    img[20:40, 18:41] = 1.0
    img += rng.rand(64, 64) * 0.05
    mask = np.zeros((64, 64))
    mask[:, :36] = 1.0
    np.testing.assert_array_equal(dift.sift_keypoints(img), jdift.sift_keypoints(img))
    np.testing.assert_array_equal(dift.detect_keypoints(img, mask),
                                  jdift.detect_keypoints(img, mask))
    color = (rng.rand(48, 48, 3) * 255).astype(np.float32)
    np.testing.assert_array_equal(dift.harris_keypoints(color, max_points=12),
                                  jdift.harris_keypoints(color, max_points=12))
    flat = rng.rand(64, 64) * 0.01   # no DoG extremum: the Harris fallback
    kps = dift.detect_keypoints(flat, mask, max_points=5)
    np.testing.assert_array_equal(kps, jdift.detect_keypoints(flat, mask, max_points=5))
    assert len(kps) and len(dift.sift_keypoints(flat, mask)) == 0


# ---------------------------------------------------------------------------
# DIFT
# ---------------------------------------------------------------------------

def test_dift_draw_matches_jax(pipes, jax_featurizer):
    """One draw of the featurizer with the same noise: up block 1's features
    of the latent noised to t = 261."""
    jp, tp = pipes
    rng = np.random.RandomState(11)
    img, _ = _scene(rng)
    latent = jp.encode_image(jnp.asarray(img))
    ctx = jp.encode_text([""])
    noise = rng.randn(*latent.shape).astype(np.float32)
    ref = jax_featurizer._feat(jp.params["unet"], latent, ctx, jnp.asarray(noise), jnp.int32(261))
    feat = dift.SDFeaturizer(tp, t=261, up_block=1, ensemble=2)
    got = feat.features(_t(latent), _t(ctx), _t(noise), 261)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **MODEL_TOL)
    np.testing.assert_allclose(tp.encode_image(_t(img)).numpy(), np.asarray(latent), **MODEL_TOL)


def test_mean_distance_metric_matches_jax(pipes, jax_featurizer):
    """MD end to end on a 64^2 scene whose object moved by a known field:
    the JAX featurizer's PRNGKey(i) draws fed to the port; with the port's
    own generator the metric runs on the same keypoints and is finite."""
    jp, tp = pipes
    rng = np.random.RandomState(12)
    src, mask = _scene(rng)
    edited = np.roll(src, 4, axis=1)
    t_coords = np.asarray(jcam.identity_field(SIZE, SIZE)) + np.array([8.0 / 63, 0, 0], np.float32)
    ref = jdift.mean_distance_metric(jax_featurizer, src, edited, mask, t_coords, max_points=12)
    feat = dift.SDFeaturizer(tp, t=261, up_block=1, ensemble=2)
    jax_draws = [torch.from_numpy(np.asarray(jax.random.normal(jax.random.PRNGKey(i), shape)))
                 for shape in [(1, SIZE // 8, SIZE // 8, 4)] for i in range(2)]
    own = dift.mean_distance_metric(feat, src, edited, mask, t_coords, max_points=12)
    feat.draw_noises = lambda shape, generator: jax_draws
    got = dift.mean_distance_metric(feat, src, edited, mask, t_coords, max_points=12)
    assert got[1] == ref[1] == own[1] > 0
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-5)
    assert np.isfinite(own[0])


# ---------------------------------------------------------------------------
# The CLI, study tools, attention visualization, resizes
# ---------------------------------------------------------------------------

def _write_tree(root, rng, size=32):
    """Translation_2D (2), Rotation_3D, Removal: inputs, `ours` results (one
    at another size, so that it is resized) and one zero123 result."""
    for cat, n in (("Translation_2D", 2), ("Rotation_3D", 1), ("Removal", 1)):
        for i in range(n):
            folder = os.path.join(root, cat, str(i))
            img = (rng.rand(size, size, 3) * 255).astype(np.uint8)
            mask = np.zeros((size, size), np.float32)
            mask[8:18, 10:20] = 1.0
            jexp_io.save_exp(folder, img, np.full((size, size), 0.5, np.float32), mask,
                             jcam.compose_transform(tx=0.05 * (i + 1)), image_shape=(size, size))
            res_size = 48 if (cat, i) == ("Translation_2D", 1) else size
            res = (rng.rand(res_size, res_size, 3) * 255).astype(np.uint8)
            Image.fromarray(res).save(os.path.join(folder, "result_ls.png"))
            if cat == "Translation_2D":
                os.makedirs(os.path.join(folder, "zero123"))
                Image.fromarray(np.roll(img, 2, axis=1)).save(
                    os.path.join(folder, "zero123", "lama_followed_by_zero123_result.png"))


def _run_both(args, tmp_path, name):
    out_j, out_t = str(tmp_path / f"{name}_jax.json"), str(tmp_path / f"{name}_port.json")
    assert jcli.main(args + ["--output", out_j]) == 0
    assert cli.main(args + ["--output", out_t, "--device", "cpu"]) == 0
    with open(out_j) as fj, open(out_t) as ft:
        return json.load(fj), json.load(ft)


def test_cli_offline_and_fid_match_jax(tmp_path):
    """`--metric offline` (every category, the transform field recomputed
    from the folders) and `--metric fid` (no CLIP weights: the pixel
    embedder) write the JAX CLI's JSON; each metric and evaluation type
    keeps the JAX CLI's folders."""
    root = str(tmp_path / "exps")
    _write_tree(root, np.random.RandomState(13))
    ref, got = _run_both(["--exp_root", root, "--metric", "offline"], tmp_path, "offline")
    assert set(got) == set(ref) == {"Translation_2D/ours", "Translation_2D/zero123",
                                    "Rotation_3D/ours", "Removal/ours"}
    for key in ref:
        assert set(got[key]) == set(ref[key]), key
        for k in ref[key]:
            np.testing.assert_allclose(got[key][k], ref[key][k], err_msg=f"{key} {k}",
                                       **METRIC_TOL)
    ref, got = _run_both(["--exp_root", root, "--metric", "fid"], tmp_path, "fid")
    assert set(got) == set(ref) == {"ours"}
    np.testing.assert_allclose(got["ours"]["fid"], ref["ours"]["fid"], rtol=1e-6)
    # the folders and categories each metric and --evaluation_type keeps
    for metric in ("md", "offline"):
        for kind in ("2D", "3D", "all"):
            keep = lambda m, c: [f for cat, f in m._experiments(root)
                                 if m._keep_category(cat, kind, metric)]
            assert keep(cli, cli) == keep(jcli, jcli), (metric, kind)
    assert list(cli._experiments(os.path.join(root, "Rotation_3D"))) == \
        list(jcli._experiments(os.path.join(root, "Rotation_3D")))


def test_cli_lpips_and_pairwise_folders(tmp_path, lpips_weights):
    """`--metric lpips` with AlexNet/lpips weights and no CLIP file reports
    LPIPS and IF (the JAX metric on the same files) and no CLIP similarity;
    `--path_1/--path_2` without weights writes the JAX CLI's JSON."""
    weights_dir, _, _, jmetric = lpips_weights
    root = str(tmp_path / "exps")
    _write_tree(root, np.random.RandomState(14))
    out = str(tmp_path / "lpips.json")
    assert cli.main(["--exp_root", root, "--metric", "lpips", "--evaluation_type", "3D",
                     "--weights_dir", weights_dir, "--output", out, "--device", "cpu"]) == 0
    with open(out) as f:
        got = json.load(f)
    folder = os.path.join(root, "Rotation_3D", "0")
    src = np.asarray(Image.open(os.path.join(folder, "input_image.png")).convert("RGB"))
    res = np.asarray(Image.open(os.path.join(folder, "result_ls.png")).convert("RGB"))
    lp = jmetric(src.astype(np.float32) / 255.0, res.astype(np.float32) / 255.0)
    assert set(got) == {"Rotation_3D/ours"}
    assert set(got["Rotation_3D/ours"]) == {"psnr", "ssim", "lpips", "if"}
    np.testing.assert_allclose(got["Rotation_3D/ours"]["lpips"], lp, rtol=1e-4)
    np.testing.assert_allclose(got["Rotation_3D/ours"]["if"], 1.0 - lp, rtol=1e-4)

    p1, p2 = tmp_path / "p1", tmp_path / "p2"
    p1.mkdir()
    p2.mkdir()
    rng = np.random.RandomState(15)
    for i, hw in enumerate(((32, 32), (24, 40))):
        a = (rng.rand(*hw, 3) * 255).astype(np.uint8)
        Image.fromarray(a).save(p1 / f"{i}.png")
        Image.fromarray((rng.rand(36, 30, 3) * 255).astype(np.uint8)).save(p2 / f"{i}.png")
    ref, got = _run_both(["--path_1", str(p1), "--path_2", str(p2)], tmp_path, "pairwise")
    assert set(got) == set(ref) == {"pairwise"}
    assert set(got["pairwise"]) == set(ref["pairwise"]) == {"psnr", "ssim"}
    for k in ref["pairwise"]:
        np.testing.assert_allclose(got["pairwise"][k], ref["pairwise"][k], **METRIC_TOL)


def test_cli_needs_a_card_unless_asked_for_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--path_1", str(tmp_path), "--path_2", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        metrics.ssim(np.zeros((8, 8)), np.zeros((8, 8)))


def test_study_and_gallery_match_jax(tmp_path):
    csv_path = tmp_path / "study.csv"
    csv_path.write_text("ours,dragon\nours,ours\nzero123,ours\n, ours\n")
    for names in (["ours", "dragon", "zero123"], None):
        assert study.analyze_study_csv([str(csv_path)], names) == \
            jstudy.analyze_study_csv([str(csv_path)], names)
    root = str(tmp_path / "exps")
    _write_tree(root, np.random.RandomState(16))
    ref = jstudy.build_gallery(root, str(tmp_path / "jax.png"), max_rows=3)
    got = study.build_gallery(root, str(tmp_path / "port.png"), max_rows=3)
    np.testing.assert_array_equal(np.asarray(Image.open(got)), np.asarray(Image.open(ref)))


def test_attention_vis_matches_jax():
    rng = np.random.RandomState(17)
    maps = {"up/attn2/map": rng.rand(2, 16, 5).astype(np.float32),
            "down/attn2/map": rng.rand(2, 16, 5).astype(np.float32),
            "down/attn1/map": rng.rand(2, 16, 16).astype(np.float32)}
    np.testing.assert_array_equal(av.aggregate_cross_attention(maps, res=4, token=2),
                                  jav.aggregate_cross_attention(maps, res=4, token=2))
    np.testing.assert_array_equal(av.colorize(maps["up/attn2/map"][0], size=37),
                                  jav.colorize(maps["up/attn2/map"][0], size=37))
    img = (rng.rand(20, 20, 3) * 255).astype(np.uint8)
    masks = [rng.rand(20, 20) > 0.5, rng.rand(20, 20) > 0.7]
    np.testing.assert_array_equal(av.overlay_masks(img, masks), jav.overlay_masks(img, masks))
    tiles = [img, img[:12], img[:, :15]]
    np.testing.assert_array_equal(av.view_images(tiles, cols=2), jav.view_images(tiles, cols=2))
    rec_t, rec_j = av.AttentionRecorder(), jav.AttentionRecorder()
    for step in range(2):
        tree = {"down_blocks_0": {"attn2": {"map": rng.rand(2, 16, 5).astype(np.float32) + step}}}
        rec_t.update(tree)
        rec_j.update(tree)
    got, ref = rec_t.averaged(), rec_j.averaged()
    assert set(got) == set(ref) == {"down_blocks_0/attn2/map"}
    np.testing.assert_array_equal(got["down_blocks_0/attn2/map"], ref["down_blocks_0/attn2/map"])


RESIZE_CASES = [((32, 32), (48, 48)), ((48, 40), (32, 32)), ((17, 23), (224, 224)),
                ((256, 256), (16, 16)), ((100, 7), (13, 29))]


@pytest.mark.parametrize("kind", ["bilinear", "nearest"])
@pytest.mark.parametrize("src_hw,out_hw", RESIZE_CASES)
def test_resize_matches_pil_exactly(kind, src_hw, out_hw):
    """Pillow's BILINEAR (the CLI's resize to the input's size and the FID
    fallback's thumbnail) and NEAREST (the attention heat map) resizes,
    equal to PIL on RGB and gray images."""
    rng = np.random.RandomState(sum(src_hw) + sum(out_hw))
    fn = {"bilinear": png.resize_bilinear, "nearest": png.resize_nearest}[kind]
    resample = {"bilinear": Image.BILINEAR, "nearest": Image.NEAREST}[kind]
    for shape in (src_hw + (3,), src_hw):
        img = (rng.rand(*shape) * 255).astype(np.uint8)
        ref = np.asarray(Image.fromarray(img).resize(out_hw[::-1], resample))
        np.testing.assert_array_equal(fn(img, *out_hw), ref)
