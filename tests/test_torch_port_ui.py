"""The port's UI slice against the JAX package, on the CPU: DINOv2, Depth
Anything and SAM at tiny widths in float32, the depth utilities, the UI
callbacks, and the whole slice over HTTP on the tiny pipeline at 64^2.

The tiny perception weights are the port's seeded random init, written as
the published files (SAM's `.pth` with its mask-prompt keys, Depth
Anything's safetensors with DINOv2's mask token and refinenet4's unused
fusion unit), read back by the port's loaders and carried into JAX by the
JAX package's own converters (`convert_sam`, `convert_depth_anything`), so
no JAX init program is compiled.  The HTTP slice's edit and inpaint are
held against direct port `EditSession.run`s (the port's tiny edits are held
against JAX by test_torch_port_edit.py and test_torch_port_remover.py); no
JAX edit runs here.
"""

import base64
import dataclasses
import difflib
import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image
from safetensors.numpy import save_file

import jax
import jax.numpy as jnp

from geodiffuser_tpu.config import EditConfig as JEditConfig
from geodiffuser_tpu.models import weights as jweights
from geodiffuser_tpu.models.dinov2 import DinoConfig as JDinoConfig
from geodiffuser_tpu.models.dinov2 import DinoViT as JDinoViT
from geodiffuser_tpu.models.sam import SamConfig as JSamConfig
from geodiffuser_tpu.ops import camera as jcam
from geodiffuser_tpu.ui import callbacks as jcb
from geodiffuser_tpu.utils import depth as jdepth
from geodiffuser_tpu.utils import exp_io as jexp_io
from geodiffuser_tpu.utils.segmentation import SamPredictor as JSamPredictor
from geodiffuser_tpu_torch.config import ModelConfig
from geodiffuser_tpu_torch.core.editor import EditSession
from geodiffuser_tpu_torch.core.pipeline import Pipeline
from geodiffuser_tpu_torch.models import weights
from geodiffuser_tpu_torch.models.dinov2 import resize_cubic_jax
from geodiffuser_tpu_torch.models.sam import SamConfig
from geodiffuser_tpu_torch.ui import callbacks as cb
from geodiffuser_tpu_torch.ui import serve
from geodiffuser_tpu_torch.utils import depth as depth_utils
from geodiffuser_tpu_torch.utils import exp_io, png
from geodiffuser_tpu_torch.utils.depth import DepthAnythingPredictor
from geodiffuser_tpu_torch.utils.segmentation import SamPredictor

pytest_plugins = ("heap_trim",)

torch.set_num_threads(1)

SIZE = 64
# float32 models on both sides, summed in another order
MODEL_TOL = dict(rtol=1e-4, atol=1e-5)
# a SAM mask bit may differ only where the logit is this close to 0
MASK_LOGIT_TOL = 1e-4
# the preview: uint8 levels, on at most this share of the pixels
PREVIEW_LEVELS, PREVIEW_SHARE = 1, 1e-3
# windows of 3 over SAM tiny's 8-token grid: padded to 9, as ViT-H pads 64 to 70
SAM_CFG = dataclasses.replace(SamConfig.tiny(), window_size=3)
JSAM_CFG = dataclasses.replace(JSamConfig.tiny(), window_size=3)


def _np(state):
    return {k: v.numpy() for k, v in state.items()}


@pytest.fixture(scope="module")
def sam_pair(tmp_path_factory):
    """(port SamPredictor read from a published-layout .pth, JAX SamPredictor
    on the same weights, the state_dict as written)."""
    seeded = SamPredictor(SAM_CFG, device="cpu", seed=0)
    state = dict(seeded.model.state_dict())
    # the published file's mask-prompt path, which neither package consumes
    state["prompt_encoder.mask_downscaling.0.weight"] = torch.ones(4, 1, 2, 2)
    state["prompt_encoder.mask_downscaling.1.bias"] = torch.ones(4)
    path = tmp_path_factory.mktemp("sam") / "sam_tiny.pth"
    torch.save(state, path)
    port = SamPredictor(SAM_CFG, checkpoint_path=str(path), device="cpu")
    params = jax.tree.map(jnp.asarray, jweights.convert_sam(_np(state)))
    return port, JSamPredictor(params=params, config=JSAM_CFG), state


@pytest.fixture(scope="module")
def da_pair(tmp_path_factory):
    """(port DepthAnythingPredictor read from a published-layout safetensors
    file, JAX DepthAnythingPredictor on the same weights, the state_dict)."""
    seeded = DepthAnythingPredictor("tiny", device="cpu", seed=1)
    state = _np(seeded.model.state_dict())
    state["pretrained.mask_token"] = np.ones((1, 32), np.float32)
    for conv in ("conv1", "conv2"):
        state[f"depth_head.scratch.refinenet4.resConfUnit1.{conv}.weight"] = np.ones(
            (16, 16, 3, 3), np.float32)
        state[f"depth_head.scratch.refinenet4.resConfUnit1.{conv}.bias"] = np.ones(16, np.float32)
    path = tmp_path_factory.mktemp("da") / "depth_anything_tiny.safetensors"
    save_file(state, str(path))
    port = DepthAnythingPredictor("tiny", checkpoint_path=str(path), device="cpu")
    params = jax.tree.map(jnp.asarray, jweights.convert_depth_anything(state))
    return port, jdepth.DepthAnythingPredictor(params=params, encoder="tiny"), state


def _image(h, w, seed=0):
    return (np.random.RandomState(seed).rand(h, w, 3) * 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------

def test_loaders_take_published_names_and_bridges_invert_the_jax_converters(sam_pair, da_pair):
    """The loaders drop exactly the keys no module consumes and load the rest
    strictly; `*_from_jax_params` gives back the port's state_dict from the
    JAX converters' trees; a missing key is named."""
    sam_extra = {k for k in sam_pair[2] if k.startswith("prompt_encoder.mask_downscaling.")}
    da_extra = {k for k in da_pair[2] if k == "pretrained.mask_token"
                or k.startswith("depth_head.scratch.refinenet4.resConfUnit1.")}
    for (port, _, state), extra, bridge, convert in (
            (sam_pair, sam_extra, weights.sam_from_jax_params, jweights.convert_sam),
            (da_pair, da_extra, weights.depth_anything_from_jax_params,
             jweights.convert_depth_anything)):
        state = {k: np.asarray(v) for k, v in state.items()}
        loaded = _np(port.model.state_dict())
        assert extra and set(state) - set(loaded) == extra and set(loaded) <= set(state)
        back = _np(bridge(convert(state)))
        assert set(back) == set(loaded)
        for k in loaded:
            np.testing.assert_array_equal(loaded[k], state[k])
            np.testing.assert_array_equal(back[k], loaded[k])
        short = {k: torch.from_numpy(v) for k, v in list(loaded.items())[1:]}
        with pytest.raises(ValueError, match=list(loaded)[0].replace(".", r"\.")):
            weights.load_perception_model(port.model, short, "perception")


# ---------------------------------------------------------------------------
# Models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hw", [(40, 48), (20, 24)], ids=["grow", "shrink"])
def test_dinov2_off_the_position_grid_matches_jax(da_pair, hw):
    """DINOv2 tiny (grid 8) at a 10x12 and a 5x6 token grid: the position
    grid resized as jax.image.resize(method="cubic") resizes it (upsampled,
    and downsampled with the widened kernel), the four taps and class
    tokens."""
    port, jpred, _ = da_pair
    grid = np.random.RandomState(2).randn(8, 8, 5).astype(np.float32)
    want = jax.image.resize(jnp.asarray(grid), (hw[0] // 4, hw[1] // 4, 5), method="cubic")
    got = resize_cubic_jax(torch.from_numpy(grid), hw[0] // 4, hw[1] // 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)

    x = np.random.RandomState(3).randn(1, *hw, 3).astype(np.float32)
    jparams = {"params": jpred.params["params"]["pretrained"]}
    want = jax.jit(JDinoViT(JDinoConfig.tiny()).apply)(jparams, jnp.asarray(x))
    with torch.inference_mode():
        got = port.model.pretrained(torch.from_numpy(x))
    assert len(got) == len(want) == 4
    for (t, c), (jt, jc) in zip(got, want):
        np.testing.assert_allclose(t.numpy(), np.asarray(jt), **MODEL_TOL)
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), **MODEL_TOL)


def test_depth_anything_predictor_matches_jax(da_pair):
    """Depth Anything tiny end to end on a 50x60 image: the lower bound and
    multiple of the patch, ImageNet normalization, the bilinear resizes,
    the DPT head (transposed convs, align_corners fusion), the inversion and
    push-back."""
    port, jpred, _ = da_pair
    image = _image(50, 60)
    got = port(image, translate_factor=0.7)
    want = np.asarray(jpred(image, translate_factor=0.7))
    assert got.shape == (50, 60)
    np.testing.assert_allclose(got, want, **MODEL_TOL)


def test_sam_matches_jax(sam_pair):
    """SAM tiny: the image embedding (windows padded 8 -> 9, the decomposed
    relative position bias, the neck), the decoder's mask logits and IoU for
    a positive and a negative point, and the click mask (bits may differ only
    where |logit| < MASK_LOGIT_TOL)."""
    port, jpred, _ = sam_pair
    image = _image(48, 56, seed=4)
    port.set_image(image)
    jpred.set_image(image)
    np.testing.assert_allclose(port._embedding.numpy(), np.asarray(jpred._embedding),
                               **MODEL_TOL)
    pts, labels = np.array([[20.0, 30.0], [40.0, 10.0]]), np.array([1, 0])
    with torch.inference_mode():
        low, iou = port.model.predict_masks(
            port._embedding, torch.from_numpy(pts[None].astype(np.float32) * port._scale),
            torch.from_numpy(labels[None].astype(np.int32)))
    jlow, jiou = jpred._decode(jpred.params, jpred._embedding,
                               jnp.asarray(pts[None] * jpred._scale, jnp.float32),
                               jnp.asarray(labels[None], jnp.int32))
    np.testing.assert_allclose(low.numpy(), np.asarray(jlow), **MODEL_TOL)
    np.testing.assert_allclose(iou.numpy(), np.asarray(jiou), **MODEL_TOL)

    mask = port.mask_from_click(image, 0.4, 0.6)
    want = jpred.mask_from_click(image, 0.4, 0.6)
    logits, _ = port.predict_logits(np.array([[56 * 0.4, 48 * 0.6]]), np.array([1]))
    differ = mask != want
    assert mask.shape == (48, 56) and 0 < want.mean() < 1
    assert np.all(np.abs(logits[-1].numpy()[differ]) < MASK_LOGIT_TOL), int(differ.sum())


# ---------------------------------------------------------------------------
# Depth utilities and callbacks
# ---------------------------------------------------------------------------

def test_depth_utilities_match_jax():
    rng = np.random.RandomState(5)
    depth = rng.rand(24, 20).astype(np.float32)
    depth[5:12, 4:9] = 0.4                      # flat: |x|' at 0 is JAX's
    image = _image(24, 20, seed=6)
    mask = (rng.rand(24, 20) > 0.6).astype(np.float32)
    np.testing.assert_array_equal(depth_utils.constant_depth(7, 9), jdepth.constant_depth(7, 9))
    np.testing.assert_allclose(depth_utils.postprocess_relative_depth(depth, 0.7),
                               jdepth.postprocess_relative_depth(depth, 0.7), rtol=1e-6)
    for kind in ("gaussian", "median"):
        np.testing.assert_array_equal(depth_utils.depth_corrector(depth, kind),
                                      jdepth.depth_corrector(depth, kind))
    np.testing.assert_array_equal(depth_utils.disparity_to_depth(depth),
                                  jdepth.disparity_to_depth(depth))
    np.testing.assert_array_equal(depth_utils.depth_scaler(depth), jdepth.depth_scaler(depth))
    np.testing.assert_array_equal(depth_utils.fill_background_depth(depth, mask),
                                  jdepth.fill_background_depth(depth, mask))
    np.testing.assert_allclose(depth_utils.depth_smoothing_tv(depth, steps=10, lr=0.1).numpy(),
                               np.asarray(jdepth.depth_smoothing_tv(depth, 10, 0.1)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(depth_utils.bilateral_depth_filter(depth, image, radius=2),
                               jdepth.bilateral_depth_filter(depth, image, radius=2),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("edit_type", ["geometry_editor", "geometry_remover"])
def test_advanced_options_to_edit_config_matches_jax(edit_type):
    """Every EditConfig field (the splat's and the loss table included), for
    the defaults, the inpaint tab's and a set with overridden weights."""
    sets = [{}, cb.REMOVER_ADVANCED_DEFAULTS,
            dict(guidance_scale=5.5, diffusion_correction=0.25, skip_steps=3.0,
                 splatting_radius=2.0, splatting_points_per_pixel=9.0, num_ddim_steps=30.0,
                 sim_loss_self=99.0, removal_loss_cross=7.0, amodal_loss_self=1.5)]
    assert cb.REMOVER_ADVANCED_DEFAULTS == jcb.REMOVER_ADVANCED_DEFAULTS
    for kw in sets:
        got = cb.AdvancedOptions(**kw).to_edit_config(edit_type)
        want = jcb.AdvancedOptions(**kw).to_edit_config(edit_type)
        for f in dataclasses.fields(JEditConfig):
            g, w = getattr(got, f.name), getattr(want, f.name)
            if dataclasses.is_dataclass(w):
                g, w = dataclasses.asdict(g), dataclasses.asdict(w)
            assert g == w and type(g) is type(w), (kw, f.name, g, w)


def _scene(size=SIZE):
    """A random image with a disk-shaped object, its mask and a depth ramp."""
    image = _image(size, size, seed=7)
    yy, xx = np.mgrid[0:size, 0:size]
    mask = (((xx - size * 0.4) ** 2 + (yy - size * 0.6) ** 2) < (size * 0.2) ** 2
            ).astype(np.float32)
    depth = (0.3 + 0.5 * yy / size).astype(np.float32)
    return image, mask, depth


def test_load_image_preview_and_save_match_jax(tmp_path):
    """load_image (Pillow's bicubic, equal bytes), the transform preview (at
    most PREVIEW_LEVELS on PREVIEW_SHARE of the pixels) and save_experiment
    read by the JAX package's read_exp."""
    state, jstate = cb.UIState(device="cpu"), jcb.UIState()
    upload = _image(80, 96, seed=8)
    np.testing.assert_array_equal(cb.load_image(state, upload, size=SIZE),
                                  jcb.load_image(jstate, upload, size=SIZE))
    _, mask, depth = _scene()
    for s, module in ((state, cb), (jstate, jcb)):
        module.set_mask(s, mask)
        s.depth = depth
        module.compose_transform_from_sliders(s, tx=0.08, ry=15.0)
    got = cb.get_transformed_preview(state)
    want = jcb.get_transformed_preview(jstate)
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= PREVIEW_LEVELS and (diff > 0).mean() <= PREVIEW_SHARE, (
        diff.max(), (diff > 0).mean())
    assert (got == cb.ORANGE).all(-1).any()

    folder = cb.save_experiment(state, str(tmp_path), "Translation_3D")
    assert folder.endswith("Translation_3D/1")
    exp = jexp_io.read_exp(folder)
    np.testing.assert_array_equal(exp.input_image, state.image)
    np.testing.assert_array_equal(exp.input_mask, state.mask)
    np.testing.assert_array_equal(exp.depth, state.depth)
    np.testing.assert_array_equal(exp.transform, state.transform)
    assert tuple(exp.image_shape) == (80, 96)
    assert cb.save_experiment(state, str(tmp_path), "Translation_3D").endswith("/2")


def test_depth_registry_dispatches():
    pred = depth_utils.get_depth_predictor("depth_anything", encoder="tiny", device="cpu")
    assert isinstance(pred, DepthAnythingPredictor)
    with pytest.raises(ValueError, match="unknown depth model"):
        depth_utils.get_depth_predictor("dpt_tiny", device="cpu")
    state = cb.UIState(device="cpu", image=_image(16, 16))
    with pytest.raises(ValueError, match="unknown depth model"):
        cb.get_depth(state, "dpt_tiny")
    assert cb.DEPTH_MODELS == jcb.DEPTH_MODELS
    np.testing.assert_array_equal(cb.get_depth(state, "constant"), np.zeros((16, 16)))
    np.testing.assert_array_equal(state.depth, np.full((16, 16), 0.5, np.float32))


def test_page_is_the_jax_page_but_for_the_upload():
    """The one change: the upload is decoded in the browser and sent as PNG
    (the JAX page sent the file's own bytes)."""
    from geodiffuser_tpu.ui import serve as jserve

    diff = [line for line in difflib.unified_diff(jserve.PAGE.splitlines(),
                                                  serve.PAGE.splitlines(), lineterm="", n=0)
            if line[:1] in "+-" and line[:3] not in ("+++", "---")]
    removed = [line[1:] for line in diff if line[0] == "-"]
    added = [line[1:] for line in diff if line[0] == "+"]
    assert len(removed) == 2 and "arrayBuffer" in removed[0], removed
    assert len(added) == 4 and "createImageBitmap" in added[1], added
    assert removed[1].replace("image:b64", "image:cv.toDataURL('image/png')") == added[3]


def test_app_gated_without_gradio():
    from geodiffuser_tpu_torch.ui import app

    with pytest.raises(RuntimeError, match="gradio"):
        app.build_app(device="cpu")


# ---------------------------------------------------------------------------
# The slice over HTTP
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def server(sam_pair, da_pair):
    pipe = Pipeline.create(ModelConfig.tiny(), image_size=SIZE, seed=0, device="cpu")
    srv = serve.make_server(pipe, port=0, sam_predictor=sam_pair[0],
                            depth_predictor=da_pair[0], device="cpu")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}", srv.RequestHandlerClass.app
    srv.shutdown()
    srv.server_close()
    thread.join(timeout=30)
    assert not thread.is_alive()


def _b64(arr) -> str:
    return base64.b64encode(png.encode_png(np.asarray(arr, np.uint8))).decode()


def _un(b64) -> np.ndarray:
    return png.decode_png(base64.b64decode(b64))


def _post(base, name, body, status=200):
    req = urllib.request.Request(f"{base}/api/{name}", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            code, out = r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        code, out = e.code, json.loads(e.read())
    assert code == status, (name, code, out)
    return out


def test_ui_slice_over_http(server, sam_pair, da_pair, tmp_path):
    """Every request of the slice in order: each output up to the edit held
    against the JAX callbacks (with the JAX predictors on the same weights),
    the edit and inpaint against direct port EditSession.run calls (equal
    bits), then save and load."""
    base, app = server
    jstate = jcb.UIState(sam_predictor=sam_pair[1], depth_predictor=da_pair[1])
    with urllib.request.urlopen(base + "/", timeout=60) as r:
        page = r.read().decode()
    assert "Editing Real Image" in page and "toDataURL('image/png')" in page
    with urllib.request.urlopen(base + "/api/state", timeout=60) as r:
        assert json.loads(r.read())["image"] is False

    upload = _image(80, 96, seed=9)
    got = _un(_post(base, "load_image", {"image": "data:image/png;base64," + _b64(upload)})["image"])
    np.testing.assert_array_equal(got, jcb.load_image(jstate, upload, size=SIZE))

    clicks = [_un(_post(base, "click", {"x": 0.4, "y": 0.6})["mask"]) for _ in range(2)]
    want = jcb.get_mask(jstate, 0.4, 0.6)
    np.testing.assert_array_equal(clicks[0], clicks[1])
    assert clicks[0].shape == (SIZE, SIZE)
    logits, _ = sam_pair[0].predict_logits(np.array([[SIZE * 0.4, SIZE * 0.6]]), np.array([1]))
    differ = (clicks[0] > 127) != (want > 0.5)
    assert np.all(np.abs(logits[-1].numpy()[differ]) < MASK_LOGIT_TOL), int(differ.sum())

    shown = _un(_post(base, "depth", {"model": "depth_anything", "translate_factor": 0.7})["depth"])
    jcb.get_depth(jstate, "depth_anything", 0.7)
    assert shown.shape == (SIZE, SIZE) and np.isfinite(app.state.depth).all()
    np.testing.assert_allclose(app.state.depth, np.asarray(jstate.depth), **MODEL_TOL)

    image, mask, depth = _scene()
    transform = jcam.compose_transform(tx=0.08, ry=15.0)
    got = _un(_post(base, "set_mask", {"mask": _b64(np.kron(mask, np.ones((2, 2))) * 255)})["mask"])
    np.testing.assert_array_equal(got, jcb.set_mask(jstate, mask) * 255)
    folder = tmp_path / "exps" / "Translation_3D" / "0"
    exp_io.save_exp(str(folder), image, depth, mask, np.asarray(transform))
    _post(base, "load", {"folder": str(folder)})
    jcb.load_experiment(jstate, str(folder))
    for field in ("image", "mask", "depth", "transform"):
        np.testing.assert_array_equal(getattr(app.state, field), getattr(jstate, field))

    got = _un(_post(base, "preview", {"tx": 0.08, "ry": 15.0})["preview"])
    jcb.compose_transform_from_sliders(jstate, tx=0.08, ry=15.0)
    diff = np.abs(got.astype(int) - jcb.get_transformed_preview(jstate).astype(int))
    assert diff.max() <= PREVIEW_LEVELS and (diff > 0).mean() <= PREVIEW_SHARE

    advanced = dict(num_ddim_steps=4, skip_steps=1)
    edited = _un(_post(base, "edit", {"prompt": "", "advanced": advanced})["edited"])
    with urllib.request.urlopen(base + "/api/state", timeout=60) as r:
        assert json.loads(r.read())["progress"] == {"frac": 1.0, "desc": "done", "running": False}
    pipe = app.state.pipeline
    cfg = cb.AdvancedOptions(**advanced).to_edit_config("geometry_editor")
    direct = EditSession(pipe, cfg, device="cpu").run(app.state.image, app.state.depth,
                                                      app.state.mask, app.state.transform)
    np.testing.assert_array_equal(edited, direct.edited_image)

    inpainted = _un(_post(base, "inpaint", {"prompt": "", "advanced": dict(
        cb.REMOVER_ADVANCED_DEFAULTS, **advanced)})["edited"])
    cfg = cb.AdvancedOptions(**cb.REMOVER_ADVANCED_DEFAULTS, **advanced).to_edit_config(
        "geometry_remover")
    direct = EditSession(pipe, cfg, device="cpu").run(
        app.state.image, np.full((SIZE, SIZE), 0.5, np.float32), app.state.mask, np.eye(4))
    np.testing.assert_array_equal(inpainted, direct.edited_image)
    assert edited.shape == inpainted.shape == (SIZE, SIZE, 3)

    saved = _post(base, "save", {"root": str(tmp_path / "saved"), "category": "Mix"})["folder"]
    loaded = _post(base, "load", {"folder": saved})
    np.testing.assert_array_equal(_un(loaded["image"]), image)
    np.testing.assert_array_equal(_un(loaded["mask"]), (mask * 255).astype(np.uint8))
    np.testing.assert_array_equal(jexp_io.read_exp(saved).depth, depth)


def test_ui_refuses_uploads_that_are_not_png(server):
    """A JPEG's bytes (the JAX page sent the file's own bytes) get a JSON
    error naming PNG, status 400; the server stays up."""
    base, _ = server
    buf = io.BytesIO()
    Image.fromarray(_image(16, 16)).save(buf, format="JPEG")
    out = _post(base, "load_image", {"image": base64.b64encode(buf.getvalue()).decode()},
                status=400)
    assert "PNG" in out["error"]
    out = _post(base, "set_mask", {"mask": "not base64!"}, status=400)
    assert "PNG" in out["error"]
    _post(base, "nothing", {}, status=404)
    with urllib.request.urlopen(base + "/api/state", timeout=60) as r:
        assert r.status == 200
