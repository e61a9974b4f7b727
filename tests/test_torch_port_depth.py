"""The port's MiDaS depth backends against the JAX package, on the CPU:
DPT-Large, DPT-Hybrid with its KITTI / NYU variants and MiDaS v2.1 at their
`tiny()` widths in float32, their predictors, the published-layout loaders,
the manifests at full geometry, and the depth registry behind the UI.

The weights are the port's seeded random init, carried into JAX by the JAX
package's own converters (`convert_dpt_large`, `convert_dpt_hybrid`,
`convert_midas_v21`), so no JAX init program is compiled; the port's models
are then built from the JAX trees by the `*_from_jax_params` bridges.  Each
JAX model is compiled once through its predictor's jitted `_apply` and at
most once more: at a shape where the position grid grows and at a
non-square one where it shrinks (MiDaS v2.1 has no grid; its head and
output resizes only grow at the sides, multiples of 32, it accepts).  The
loaders read files built from the JAX trees as the JAX package's converter
tests build them, with the manifests' unconsumed keys added.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from geodiffuser_tpu.models import midas_dpt as jmd
from geodiffuser_tpu.utils import depth as jdepth
from geodiffuser_tpu_torch.models import midas_dpt as md
from geodiffuser_tpu_torch.models import weights
from geodiffuser_tpu_torch.models import zoedepth as zd
from geodiffuser_tpu_torch.models import zoedepth_nk as znk
from geodiffuser_tpu_torch.models.depth_anything import DepthAnything, DepthAnythingConfig
from geodiffuser_tpu_torch.models.sam import Sam, SamConfig
from geodiffuser_tpu_torch.ops import image as image_ops
from geodiffuser_tpu_torch.ui import callbacks as cb
from geodiffuser_tpu_torch.utils import depth as du
from test_midas_backends import _add_scratch, _synthetic_dpt_hybrid_state

pytest_plugins = ("heap_trim",)

torch.set_num_threads(1)

# float32 models on both sides, summed in another order: the largest
# difference relative to the largest value of the JAX output
REL_TOL = 1e-4
IMAGE_HW = (50, 60)
KITTI = dict(scale=0.00006016, shift=0.00579, invert=True)
NYU = dict(scale=0.000305, shift=0.1378, invert=True)


def assert_close(got, want, rel=REL_TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert np.isfinite(got).all() and scale > 0 and err <= rel * scale, (err, scale)


def _np(state):
    return {k: v.detach().numpy() for k, v in state.items()}


def _image(h, w, seed=0):
    return (np.random.RandomState(seed).rand(h, w, 3) * 255).astype(np.uint8)


def _input(hw, seed):
    return np.random.RandomState(seed).randn(1, *hw, 3).astype(np.float32)


def unconsumed(backend):
    return weights.unconsumed_keys(f"{backend}.json")


def dpt_extras(dim, features, prefix=""):
    """The published DPT files' keys no module consumes, at tiny widths: the
    ViT's final norm and classifier, refinenet4's unused fusion unit."""
    out = {f"{prefix}pretrained.model.norm.weight": np.ones(dim, np.float32),
           f"{prefix}pretrained.model.norm.bias": np.zeros(dim, np.float32)}
    if not prefix:
        out["pretrained.model.head.weight"] = np.zeros((1000, dim), np.float32)
        out["pretrained.model.head.bias"] = np.zeros(1000, np.float32)
    for conv in ("conv1", "conv2"):
        unit = f"{prefix}scratch.refinenet4.resConfUnit1.{conv}"
        out[f"{unit}.weight"] = np.ones((features, features, 3, 3), np.float32)
        out[f"{unit}.bias"] = np.ones(features, np.float32)
    return out


def dpt_large_state(p, cfg):
    """The released dpt_large layout from a JAX tree, as
    tests/test_midas_backends.py:test_convert_dpt_large_roundtrip builds it."""
    sd = {}
    c4 = lambda a: np.asarray(a).transpose(3, 2, 0, 1)
    pm = "pretrained.model"
    sd[f"{pm}.patch_embed.proj.weight"] = c4(p["patch_embed_proj"]["kernel"])
    sd[f"{pm}.patch_embed.proj.bias"] = np.asarray(p["patch_embed_proj"]["bias"])
    sd[f"{pm}.cls_token"] = np.asarray(p["cls_token"])
    sd[f"{pm}.pos_embed"] = np.asarray(p["pos_embed"])
    for i in range(cfg.depth):
        blk, pt = p[f"blocks_{i}"], f"{pm}.blocks.{i}"
        for nrm in ("norm1", "norm2"):
            sd[f"{pt}.{nrm}.weight"] = np.asarray(blk[nrm]["scale"])
            sd[f"{pt}.{nrm}.bias"] = np.asarray(blk[nrm]["bias"])
        for ours, theirs in (("attn_qkv", "attn.qkv"), ("attn_proj", "attn.proj"),
                             ("mlp_fc1", "mlp.fc1"), ("mlp_fc2", "mlp.fc2")):
            sd[f"{pt}.{theirs}.weight"] = np.asarray(blk[ours]["kernel"]).T
            sd[f"{pt}.{theirs}.bias"] = np.asarray(blk[ours]["bias"])
    for tap in range(4):
        post = f"pretrained.act_postprocess{tap + 1}"
        sd[f"{post}.0.project.0.weight"] = np.asarray(p[f"readout_{tap}"]["kernel"]).T
        sd[f"{post}.0.project.0.bias"] = np.asarray(p[f"readout_{tap}"]["bias"])
        sd[f"{post}.3.weight"] = c4(p[f"projects_{tap}"]["kernel"])
        sd[f"{post}.3.bias"] = np.asarray(p[f"projects_{tap}"]["bias"])
    for tap in (0, 1, 3):
        post = f"pretrained.act_postprocess{tap + 1}.4"
        sd[f"{post}.weight"] = c4(p[f"resize_layers_{tap}"]["kernel"])
        sd[f"{post}.bias"] = np.asarray(p[f"resize_layers_{tap}"]["bias"])
    _add_scratch(sd, p, out_conv=True)
    return sd


def midas_v21_state(p, cfg):
    """The released midas_v21 layout from a JAX tree, as
    tests/test_midas_backends.py:test_convert_midas_v21_roundtrip builds it,
    with BatchNorm's `num_batches_tracked` buffers."""
    sd = {}
    c4 = lambda a: np.asarray(a).transpose(3, 2, 0, 1)

    def add_bn(prefix, q):
        sd[prefix + ".weight"] = np.asarray(q["scale"])
        sd[prefix + ".bias"] = np.asarray(q["bias"])
        sd[prefix + ".running_mean"] = np.asarray(q["mean"])
        sd[prefix + ".running_var"] = np.asarray(q["var"])
        sd[prefix + ".num_batches_tracked"] = np.array(7, np.int64)

    sd["pretrained.layer1.0.weight"] = c4(p["conv1"]["kernel"])
    add_bn("pretrained.layer1.1", p["bn1"])
    for s, n_blocks in enumerate(cfg.layers):
        for j in range(n_blocks):
            blk = p[f"layer{s + 1}_{j}"]
            pt = f"pretrained.layer1.4.{j}" if s == 0 else f"pretrained.layer{s + 1}.{j}"
            for c in (1, 2, 3):
                sd[f"{pt}.conv{c}.weight"] = c4(blk[f"conv{c}"]["kernel"])
                add_bn(f"{pt}.bn{c}", blk[f"bn{c}"])
            if "downsample_conv" in blk:
                sd[f"{pt}.downsample.0.weight"] = c4(blk["downsample_conv"]["kernel"])
                add_bn(f"{pt}.downsample.1", blk["downsample_bn"])
    _add_scratch(sd, p, out_conv=False)
    return sd


@dataclasses.dataclass
class Backend:
    """One model on both sides: the JAX predictor (its jitted `_apply` is the
    JAX model, run on `params`), the port predictor built through the
    bridge, the JAX tree, the input shapes, the port's seeded state_dict the
    JAX converter made `params` from, and the JAX outputs by input shape
    (computed once)."""

    jpred: object
    pred: object
    params: dict
    shapes: dict
    seeded: dict
    outs: dict = dataclasses.field(default_factory=dict)

    def jax_out(self, name):
        if name not in self.outs:
            x = _input(self.shapes[name], seed=len(name))
            self.outs[name] = (x, np.asarray(self.jpred._apply(self.params, jnp.asarray(x))))
        return self.outs[name]

    def port_out(self, name, model=None):
        x, _ = self.jax_out(name)
        with torch.inference_mode():
            return (model or self.pred.model)(torch.from_numpy(x)).numpy()


def _seeded_state(pred_cls, cfg, seed, **kw):
    return _np(pred_cls(cfg, device="cpu", seed=seed, **kw).model.state_dict())


@pytest.fixture(scope="module")
def backends():
    """name -> Backend: dpt_large, dpt_hybrid (+ _kitti, _nyu), midas_v21."""
    out = {}
    cfg = md.DPTConfig.tiny()
    seeded = _seeded_state(du.MidasDPTPredictor, cfg, 1)
    params = jmd.convert_dpt_large(seeded, jmd.DPTConfig.tiny())
    out["dpt_large"] = Backend(
        jdepth.MidasDPTPredictor(params=params, config=jmd.DPTConfig.tiny()),
        du.MidasDPTPredictor(cfg, state_dict=weights.dpt_large_from_jax_params(params),
                             device="cpu"),
        params, {"grow": (64, 64), "shrink": (24, 28)}, seeded)

    hcfg = md.DPTHybridConfig.tiny()
    seeded = _seeded_state(du.DPTHybridPredictor, hcfg, 2)
    params = jmd.convert_dpt_hybrid(seeded, jmd.DPTHybridConfig.tiny())
    state = weights.dpt_hybrid_from_jax_params(params)
    for variant, metric, shapes in (("dpt_hybrid", {}, {"grow": (96, 128), "pred": (32, 32)}),
                                    ("dpt_hybrid_kitti", KITTI,
                                     {"shrink": (32, 48), "pred": (32, 32)}),
                                    ("dpt_hybrid_nyu", NYU, {"pred": (32, 32)})):
        jcfg = dataclasses.replace(jmd.DPTHybridConfig.tiny(), **metric)
        out[variant] = Backend(
            jdepth.DPTHybridPredictor(params=params, config=jcfg, variant=variant),
            du.DPTHybridPredictor(dataclasses.replace(hcfg, **metric), variant=variant,
                                  state_dict=state, device="cpu"),
            params, shapes, seeded)

    vcfg = md.MidasV21Config.tiny()
    state = _seeded_state(du.MidasV21Predictor, vcfg, 3)
    rng = np.random.RandomState(3)
    for k in state:        # BatchNorm statistics that are not the identity
        if k.endswith("running_mean"):
            state[k] = (rng.randn(*state[k].shape) * 0.1).astype(np.float32)
        elif k.endswith("running_var"):
            state[k] = (1.0 + rng.rand(*state[k].shape)).astype(np.float32)
    params = jmd.convert_midas_v21(state, jmd.MidasV21Config.tiny())
    out["midas_v21"] = Backend(
        jdepth.MidasV21Predictor(params=params, config=jmd.MidasV21Config.tiny(), size=64),
        du.MidasV21Predictor(vcfg, size=64, state_dict=weights.midas_v21_from_jax_params(params),
                             device="cpu"),
        params, {"grow": (64, 64), "wide": (64, 96)}, state)
    return out


# ---------------------------------------------------------------------------
# The resize the position grids take
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hw", [(11, 13), (5, 3)], ids=["grow", "shrink"])
def test_resize_linear_jax_matches_jax_image_resize(hw):
    """jax.image.resize(method="linear") with its default antialiasing, from
    an 8x7 grid: growing (equal to the plain bilinear resize) and shrinking
    (the triangle widened by the reduction factor)."""
    grid = np.random.RandomState(0).randn(8, 7, 5).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(grid), (*hw, 5), method="linear"))
    got = image_ops.resize_linear_jax(torch.from_numpy(grid).permute(2, 0, 1), *hw)
    np.testing.assert_allclose(got.permute(1, 2, 0).numpy(), want, rtol=1e-5, atol=1e-6)
    plain = image_ops.resize_bilinear(torch.from_numpy(grid).permute(2, 0, 1), *hw)
    assert np.allclose(plain.permute(1, 2, 0).numpy(), want, atol=1e-5) == (hw == (11, 13))


# ---------------------------------------------------------------------------
# Models, predictors, bridges, loaders
# ---------------------------------------------------------------------------

MODEL_CASES = [("dpt_large", "grow"), ("dpt_large", "shrink"), ("dpt_hybrid", "grow"),
               ("dpt_hybrid", "pred"), ("dpt_hybrid_kitti", "shrink"),
               ("midas_v21", "grow"), ("midas_v21", "wide")]


@pytest.mark.parametrize("name,shape", MODEL_CASES, ids=["-".join(c) for c in MODEL_CASES])
def test_model_matches_jax(backends, name, shape):
    """The tiny model from the bridged JAX tree against the JAX model: DPT-
    Large's position grid grown 8 -> 16 and shrunk to 6x7; the hybrid's
    4-grid grown to 6x8 and shrunk to 2x2 (the predictor's input) and, in
    the KITTI variant's metric inversion, to 2x3; MiDaS v2.1 square and
    wide."""
    b = backends[name]
    x, want = b.jax_out(shape)
    assert want.shape == x.shape[:3]
    assert_close(b.port_out(shape), want)


PREDICTORS = ["dpt_large", "dpt_hybrid", "dpt_hybrid_kitti", "dpt_hybrid_nyu", "midas_v21"]


@pytest.mark.parametrize("name", PREDICTORS)
def test_predictor_matches_jax(backends, name):
    """The predictor on a 50x60 image: its input size and normalization, the
    resizes, then the inversion and push-back, or for KITTI / NYU the metric
    inversion times 256 / 1000 and the push-back only."""
    b = backends[name]
    image = _image(*IMAGE_HW, seed=4)
    for tf in (0.0, 0.7):
        got, want = b.pred(image, translate_factor=tf), np.asarray(b.jpred(image, tf))
        assert got.shape == IMAGE_HW
        assert_close(got, want)
    if name in ("dpt_hybrid_kitti", "dpt_hybrid_nyu"):
        raw = b.pred.model_depth(image).numpy() * b.pred.out_scale
        np.testing.assert_array_equal(b.pred(image, 0.0), raw)
        assert (raw > 0).all() and b.pred.metric


BRIDGES = {"dpt_large": weights.dpt_large_from_jax_params,
           "dpt_hybrid": weights.dpt_hybrid_from_jax_params,
           "midas_v21": weights.midas_v21_from_jax_params}


@pytest.mark.parametrize("name", sorted(BRIDGES))
def test_bridge_inverts_the_jax_converter(backends, name):
    """`*_from_jax_params` of the JAX converter's tree gives back the seeded
    port state the converter was given, every key bit for bit."""
    b = backends[name]
    state = BRIDGES[name](b.params)
    assert set(state) == set(b.seeded)
    for k, v in b.seeded.items():
        np.testing.assert_array_equal(state[k].numpy(), v, err_msg=k)


def _published(name, params):
    if name == "dpt_large":
        sd = dpt_large_state(params["params"], jmd.DPTConfig.tiny())
        return {**sd, **dpt_extras(32, 16)}
    if name == "dpt_hybrid":
        sd = _synthetic_dpt_hybrid_state(params, jmd.DPTHybridConfig.tiny())
        return {**sd, **dpt_extras(32, 16)}
    return midas_v21_state(params["params"], jmd.MidasV21Config.tiny()) | {
        k: v for k, v in dpt_extras(0, 16).items() if "refinenet4" in k}


@pytest.mark.parametrize("name", ["dpt_large", "dpt_hybrid", "midas_v21"])
def test_loader_reads_the_published_layout(backends, name, tmp_path):
    """A published-layout file built from the JAX tree, with keys of the
    manifest's `unconsumed` list, read by the port's loader (those keys
    dropped, the rest loaded strictly): the JAX model's output at both
    shapes.  A missing key is named."""
    b = backends[name]
    sd = _published(name, b.params)
    extra = set(sd) - set(b.pred.model.state_dict())
    assert extra and extra <= unconsumed(name), sorted(extra - unconsumed(name))
    path = tmp_path / f"{name}.pt"
    torch.save({"model": {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}}, path)
    assert set(weights.read_checkpoint(str(path), f"{name}.json")) == set(sd) - extra
    kw = dict(size=64) if name == "midas_v21" else {}
    pred = type(b.pred)(b.pred.cfg, checkpoint_path=str(path), device="cpu", **kw)
    for shape in b.shapes:
        assert_close(b.port_out(shape, pred.model), b.jax_out(shape)[1])
    short = dict(list(pred.model.state_dict().items())[1:])
    with pytest.raises(ValueError, match=list(pred.model.state_dict())[0].replace(".", r"\.")):
        weights.load_perception_model(pred.model, short, name)


# ---------------------------------------------------------------------------
# Full geometry on the meta device
# ---------------------------------------------------------------------------

FULL_MODULES = {
    "dpt_large": lambda: md.DPTLarge(),
    "dpt_hybrid": lambda: md.DPTHybrid(),
    "midas_v21": lambda: md.MidasNetV21(),
    "zoedepth_nk": lambda: znk.ZoeDepthNK(),
    "sam_vit_h": lambda: Sam(SamConfig.vit_h()),
    "depth_anything_vitl14": lambda: DepthAnything(DepthAnythingConfig()),
}


@pytest.mark.parametrize("name", sorted(FULL_MODULES))
def test_full_geometry_keys_equal_the_manifest(name):
    """Each full-width module built on the meta device has exactly the
    manifest's consumed keys and shapes."""
    with open(weights.MANIFESTS / f"{name}.json") as f:
        manifest = json.load(f)
    drop = set(manifest["unconsumed"])
    with torch.device("meta"):
        module = FULL_MODULES[name]()
    got = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    want = {k: tuple(s) for k, s in manifest["keys"].items() if k not in drop}
    assert got == want, (sorted(set(got) ^ set(want))[:8])


# ---------------------------------------------------------------------------
# The registry behind the UI's depth dropdown
# ---------------------------------------------------------------------------

TINY = {
    "dpt_large": dict(config=md.DPTConfig.tiny()),
    "midas": dict(config=md.DPTConfig.tiny()),
    "dpt_hybrid": dict(config=md.DPTHybridConfig.tiny()),
    "dpt_hybrid_kitti": dict(config=dataclasses.replace(md.DPTHybridConfig.tiny(), **KITTI)),
    "dpt_hybrid_nyu": dict(config=dataclasses.replace(md.DPTHybridConfig.tiny(), **NYU)),
    "midas_v21": dict(config=md.MidasV21Config.tiny(), size=64),
    "zoedepth": dict(config=zd.ZoeDepthConfig.tiny(), size=64),
    "zoedepth_nk": dict(config=znk.ZoeDepthNKConfig.tiny(), size=(32, 48)),
    "zoe_nk": dict(config=znk.ZoeDepthNKConfig.tiny(), size=(32, 48)),
}


def _jax_registry_choice(monkeypatch, name):
    """(class name, variant) the JAX registry dispatches `name` to, with the
    JAX predictor classes replaced by recorders (no JAX model is built)."""
    for cls in ("DepthAnythingPredictor", "MidasDPTPredictor", "DPTHybridPredictor",
                "MidasV21Predictor", "ZoeDepthPredictor", "ZoeDepthNKPredictor"):
        monkeypatch.setattr(jdepth, cls, lambda cls=cls, **kw: (cls, kw.get("variant")))
    return jdepth.get_depth_predictor(name)


@pytest.mark.parametrize("name", list(TINY))
def test_depth_registry_serves_every_jax_name(monkeypatch, name):
    """Every name of the JAX registry (aliases included) reaches the JAX
    registry's class (and DPT-Hybrid variant) and gives finite (H, W) depth
    on the CPU at a tiny width; the UI's get_depth serves each dropdown name
    from its predictor cache, an alias is refused there as in JAX."""
    want = _jax_registry_choice(monkeypatch, name)
    pred = du.get_depth_predictor(name, device="cpu", seed=5, **TINY[name])
    assert (type(pred).__name__, getattr(pred, "variant", None)) == want
    image = _image(*IMAGE_HW, seed=6)
    d = pred(image, translate_factor=0.7)
    assert d.shape == IMAGE_HW and np.isfinite(d).all() and d.std() > 0
    state = cb.UIState(device="cpu", image=image)
    if name in cb.DEPTH_MODELS:
        state.depth_predictors[name] = pred
        shown = cb.get_depth(state, name, translate_factor=0.7)
        assert shown.shape == IMAGE_HW and 0.0 <= shown.min() and shown.max() <= 1.0
        np.testing.assert_array_equal(state.depth, d)
    else:
        with pytest.raises(ValueError, match="unknown depth model"):
            cb.get_depth(state, name)
        assert state.depth is None


@pytest.mark.parametrize("name", list(TINY))
def test_depth_predictors_need_a_card_unless_asked_for_cpu(monkeypatch, name):
    """A predictor asked for cuda without a card raises; nothing falls back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        du.get_depth_predictor(name, **TINY[name])
