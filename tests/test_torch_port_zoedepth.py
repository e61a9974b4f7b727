"""The port's ZoeDepth and ZoeDepth-NK against the JAX package, on the CPU:
the metric-bins layers, BEiT's relative-position bias (its table resized
with the reference's (width, height) quirk, held on a non-square training
window), the router's patch transformer, both models at their `tiny()`
widths in float32 (ZoeDepth-NK through each of its two heads), their
predictors, the bridges and ZoeD-M12-NK's published-layout loader.

As in test_torch_port_depth.py, the weights are the port's seeded init
carried into JAX by a converter (`convert_zoedepth_nk`; the single-head
model, which no published file holds, by the DPT-Large converter and the
NK converter's helpers), and each JAX model compiles through its
predictor's jitted `_apply` at the predictor's input, where the position
windows grow, and at one non-square shape where they shrink.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from geodiffuser_tpu.models import midas_dpt as jmd
from geodiffuser_tpu.models import zoedepth as jzd
from geodiffuser_tpu.models import zoedepth_nk as jznk
from geodiffuser_tpu.utils import depth as jdepth
from geodiffuser_tpu_torch.models import weights
from geodiffuser_tpu_torch.models import zoedepth as zd
from geodiffuser_tpu_torch.models import zoedepth_nk as znk
from geodiffuser_tpu_torch.models.layers import seeded_init_
from geodiffuser_tpu_torch.utils import depth as du
from test_torch_port_depth import (
    IMAGE_HW, Backend, _image, _np, _seeded_state, assert_close, dpt_extras, unconsumed,
)
from test_zoedepth_nk import _invert_params_to_torch_sd

pytest_plugins = ("heap_trim",)

torch.set_num_threads(1)

JZOE, JNK = jzd.ZoeDepthConfig.tiny(), jznk.ZoeDepthNKConfig.tiny()
FLIP = ("mlp_classifier.2.weight", "mlp_classifier.2.bias")


def _seeded(module, seed):
    seeded_init_(module, torch.Generator().manual_seed(seed))
    return module.eval().requires_grad_(False)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def jax_zoedepth_params(state, cfg):
    """The JAX ZoeDepth tree from the port's state_dict: the core by
    `convert_dpt_large`, the metric head by the NK converter's helpers."""
    core = {k[len("core.core."):]: v for k, v in state.items() if k.startswith("core.core.")}
    p = {"core": jmd.convert_dpt_large(core, cfg.core)["params"],
         "conv2": jznk._conv(state, "conv2"),
         "seed_bin_regressor": jznk._net2(state, "seed_bin_regressor._net"),
         "seed_projector": jznk._net2(state, "seed_projector._net"),
         "conditional_log_binomial": {
             "mlp_0": jznk._conv(state, "conditional_log_binomial.mlp.0"),
             "mlp_2": jznk._conv(state, "conditional_log_binomial.mlp.2")}}
    for i in range(len(cfg.n_attractors)):
        p[f"projectors_{i}"] = jznk._net2(state, f"projectors.{i}._net")
        p[f"attractors_{i}"] = jznk._net2(state, f"attractors.{i}._net")
    return {"params": p}


def _flipped(state):
    """The router's last layer negated: the summed logits change sign, so the
    vote goes to the other head."""
    return {k: -v if k in FLIP else v for k, v in state.items()}


@pytest.fixture(scope="module")
def backends():
    out = {}
    cfg = zd.ZoeDepthConfig.tiny()
    seeded = _seeded_state(du.ZoeDepthPredictor, cfg, 7, size=64)
    params = jax_zoedepth_params(seeded, JZOE)
    out["zoedepth"] = Backend(
        jdepth.ZoeDepthPredictor(params=params, config=JZOE, size=64),
        du.ZoeDepthPredictor(cfg, size=64, state_dict=weights.zoedepth_from_jax_params(params),
                             device="cpu"),
        params, {"grow": (64, 64), "shrink": (24, 28)}, seeded)

    ncfg = znk.ZoeDepthNKConfig.tiny()
    state = _seeded_state(du.ZoeDepthNKPredictor, ncfg, 8)
    rng = np.random.RandomState(8)
    for k in state:        # bias tables of the size of the logits
        if k.endswith("relative_position_bias_table"):
            state[k] = rng.randn(*state[k].shape).astype(np.float32)
    for name, st in (("zoedepth_nk", state), ("zoedepth_nk_flipped", _flipped(state))):
        params = jznk.convert_zoedepth_nk(st, JNK)
        out[name] = Backend(
            jdepth.ZoeDepthNKPredictor(params=params, config=JNK, size=(40, 48)),
            du.ZoeDepthNKPredictor(ncfg, size=(40, 48), device="cpu",
                                   state_dict=weights.zoedepth_nk_from_jax_params(params)),
            params, {"grow": (40, 48), "shrink": (24, 28)}, st)
    # one JAX program serves both heads: the flipped tree goes through the
    # first predictor's jitted _apply
    out["zoedepth_nk_flipped"].jpred = out["zoedepth_nk"].jpred
    return out


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

ATTRACTORS = {"inv_mean": dict(kind="mean", attractor_type="inv"),
              "exp_sum": dict(kind="sum", attractor_type="exp")}


@pytest.mark.parametrize("kind", sorted(ATTRACTORS))
def test_attractor_layer_matches_jax(kind):
    """The bin centres after one attractor layer (NK's inv / mean and the
    defaults' exp / sum), the JAX layer configured with alpha 1000: both
    apply the reference's 300 and 2 (the port's layer takes no alpha), the
    distances dx small enough that their float32 rounding shows."""
    kw = dict(n_attractors=4, mlp_dim=16, **ATTRACTORS[kind])
    port = _seeded(zd.AttractorLayerUnnormed(10, 8, **kw), 9)
    rng = np.random.RandomState(2)
    x = rng.rand(1, 6, 6, 10).astype(np.float32)
    b_prev = rng.rand(1, 3, 3, 8).astype(np.float32)
    prev = rng.rand(1, 3, 3, 10).astype(np.float32)
    params = {"params": jznk._net2(_np(port.state_dict()), "_net")}
    want, _ = jax.jit(jzd.AttractorLayerUnnormed(n_bins=8, alpha=1000, gamma=2, **kw).apply)(
        params, jnp.asarray(x), jnp.asarray(b_prev), jnp.asarray(prev))
    with torch.inference_mode():
        got = port(_nchw(x), _nchw(b_prev), _nchw(prev))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_seed_regressor_projector_and_log_binomial_match_jax():
    """The seed bin regressor and projector (1x1 MLPs, softplus), and the
    conditional log-binomial: its float64 host table equal to the JAX one,
    its probabilities at temperature t."""
    rng = np.random.RandomState(3)
    x = rng.rand(1, 5, 6, 12).astype(np.float32)
    seed = _seeded(zd.SeedBinRegressorUnnormed(12, n_bins=8, mlp_dim=16), 10)
    proj = _seeded(zd.Projector(12, 6, mlp_dim=16), 11)
    clb = _seeded(zd.ConditionalLogBinomial(6, 10, n_classes=8, min_temp=0.0212, max_temp=50.0), 12)
    xs, cond = rng.rand(1, 4, 4, 6).astype(np.float32), rng.rand(1, 4, 4, 10).astype(np.float32)
    run = lambda mod, p, *a: np.asarray(jax.jit(mod.apply)({"params": p}, *map(jnp.asarray, a)))
    want_seed = run(jzd.SeedBinRegressorUnnormed(n_bins=8, mlp_dim=16),
                    jznk._net2(_np(seed.state_dict()), "_net"), x)
    want_proj = run(jzd.Projector(6, mlp_dim=16), jznk._net2(_np(proj.state_dict()), "_net"), x)
    sd = _np(clb.state_dict())
    want_clb = run(jzd.ConditionalLogBinomial(n_classes=8, min_temp=0.0212, max_temp=50.0),
                   {"mlp_0": jznk._conv(sd, "mlp.0"), "mlp_2": jznk._conv(sd, "mlp.2")}, xs, cond)
    with torch.inference_mode():
        np.testing.assert_allclose(_nhwc(seed(_nchw(x))), want_seed[0], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(_nhwc(proj(_nchw(x))), want_proj, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(_nhwc(clb(_nchw(xs), _nchw(cond))), want_clb,
                                   rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(clb.log_binom.numpy(),
                                  jzd._log_binom_host(7, np.arange(8, dtype=np.float64)))


def test_beit_attention_on_a_non_square_training_window_matches_jax():
    """BEiT attention with a (6, 8) training window at a (5, 9) window: the
    table's rows read as (2 tw - 1, 2 th - 1) = (15, 11) and resized to
    (9, 17), one axis shrinking and one growing; random tables, so that a
    transposed reading would show.  The index tables equal timm's."""
    for window in ((4, 5), (3, 3), (6, 8)):
        np.testing.assert_array_equal(znk.gen_relative_position_index(window),
                                      jznk.gen_relative_position_index(window))
    cfg = dataclasses.replace(znk.BEiTConfig.tiny(), embed_dim=16, train_window=(6, 8))
    jcfg = dataclasses.replace(jznk.BEiTConfig.tiny(), embed_dim=16, train_window=(6, 8))
    port = _seeded(znk.BEiTAttention(cfg), 13)
    rng = np.random.RandomState(4)
    with torch.no_grad():
        for p in (port.relative_position_bias_table, port.q_bias, port.v_bias):
            p.copy_(torch.from_numpy(rng.randn(*p.shape).astype(np.float32)))
    sd = _np(port.state_dict())
    params = {"qkv_kernel": sd["qkv.weight"].T, "q_bias": sd["q_bias"], "v_bias": sd["v_bias"],
              "relative_position_bias_table": sd["relative_position_bias_table"],
              "proj": {"kernel": sd["proj.weight"].T, "bias": sd["proj.bias"]}}
    x = rng.randn(2, 5 * 9 + 1, 16).astype(np.float32)
    want = jax.jit(jznk.BEiTAttention(jcfg, (5, 9)).apply)({"params": params}, jnp.asarray(x))
    with torch.inference_mode():
        got = port(torch.from_numpy(x), (5, 9))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_router_patch_transformer_matches_jax():
    """The router's encoder: 1x1 embedding, the zero class token, the
    concatenated sin / cos positions, four post-norm layers."""
    port = _seeded(znk.PatchTransformerEncoder(12, 16), 14)
    sd = _np(port.state_dict())
    params = {"embedding_convPxP": jznk._conv(sd, "embedding_convPxP")}
    for i in range(4):
        t = f"transformer_encoder.layers.{i}"
        params[f"layers_{i}"] = {
            "in_proj_weight": sd[f"{t}.self_attn.in_proj_weight"],
            "in_proj_bias": sd[f"{t}.self_attn.in_proj_bias"],
            "out_proj": jznk._lin(sd, f"{t}.self_attn.out_proj"),
            "linear1": jznk._lin(sd, f"{t}.linear1"), "linear2": jznk._lin(sd, f"{t}.linear2"),
            "norm1": jznk._ln(sd, f"{t}.norm1"), "norm2": jznk._ln(sd, f"{t}.norm2")}
    x = np.random.RandomState(1).rand(2, 5, 6, 12).astype(np.float32)
    want = jax.jit(jznk.PatchTransformerEncoder(16).apply)({"params": params}, jnp.asarray(x))
    with torch.inference_mode():
        got = port(_nchw(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=2e-5)
    np.testing.assert_array_equal(znk.sinusoidal_encoding_1d(31, 16),
                                  jznk.sinusoidal_encoding_1d(31, 16))


# ---------------------------------------------------------------------------
# Models, predictors, bridges, the loader
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", ["grow", "shrink"])
def test_zoedepth_matches_jax(backends, shape):
    """Single-head ZoeDepth tiny: the DPT core's position grid grown 8 -> 16
    and shrunk to 6x7, the seed bins, four attractor layers, the
    log-binomial and the expectation over the bins."""
    b = backends["zoedepth"]
    x, want = b.jax_out(shape)
    assert (want >= 0).all()
    assert_close(b.port_out(shape), want)


NK_CASES = [(s, h) for s in ("grow", "shrink") for h in ("as_drawn", "flipped")]


@pytest.mark.parametrize("shape,head", NK_CASES, ids=["-".join(c) for c in NK_CASES])
def test_zoedepth_nk_matches_jax_through_each_head(backends, shape, head):
    """ZoeDepth-NK tiny, BEiT's windows 10x12 and 6x7 against its 8x8
    training window: once with the router as drawn and once with its last
    layer negated, so that the vote takes the other head; the port runs only
    the head the vote picks, JAX both."""
    b = backends["zoedepth_nk" + ("_flipped" if head == "flipped" else "")]
    x, want = b.jax_out(shape)
    with torch.inference_mode():
        got, logits = b.pred.model(torch.from_numpy(x), return_domain_logits=True)
    assert_close(got.numpy(), want)
    other = backends["zoedepth_nk" if head == "flipped" else "zoedepth_nk_flipped"]
    with torch.inference_mode():
        _, other_logits = other.pred.model(torch.from_numpy(x), return_domain_logits=True)
    votes = {int(torch.argmax(t.sum(0))) for t in (logits, other_logits)}
    assert votes == {0, 1}
    assert not np.allclose(want, other.jax_out(shape)[1], rtol=1e-3)


@pytest.mark.parametrize("name", ["zoedepth", "zoedepth_nk"])
def test_metric_predictor_matches_jax(backends, name):
    """The predictor on a 50x60 image: ImageNet normalization, the resizes,
    metric depth out with the push-back only."""
    b = backends[name]
    image = _image(*IMAGE_HW, seed=5)
    for tf in (0.0, 0.7):
        got, want = b.pred(image, translate_factor=tf), np.asarray(b.jpred(image, tf))
        assert got.shape == IMAGE_HW and (got > 0).all()
        assert_close(got, want)


@pytest.mark.parametrize("name,bridge", [("zoedepth", weights.zoedepth_from_jax_params),
                                         ("zoedepth_nk", weights.zoedepth_nk_from_jax_params)])
def test_bridge_inverts_the_jax_tree(backends, name, bridge):
    """The bridge of the JAX tree gives back the seeded port state the tree
    was converted from, every key bit for bit."""
    b = backends[name]
    state = bridge(b.params)
    assert set(state) == set(b.seeded)
    for k, v in b.seeded.items():
        np.testing.assert_array_equal(state[k].numpy(), v, err_msg=k)


def test_nk_loader_reads_the_published_layout(backends, tmp_path):
    """ZoeD-M12-NK's layout from the JAX tree (tests/test_zoedepth_nk.py's
    inverse of the converter) with the manifest's unconsumed keys (each
    block's relative_position_index, the BEiT's final norm, refinenet4's
    unused unit), in the release's {"model": ...} wrapper: the port's loader
    gives the JAX output at both shapes."""
    b = backends["zoedepth_nk"]
    sd = _invert_params_to_torch_sd(b.params["params"], JNK)
    sd.update(dpt_extras(32, 16, prefix="core.core."))
    for i in range(JNK.core.depth):
        sd[f"core.core.pretrained.model.blocks.{i}.attn.relative_position_index"] = (
            jznk.gen_relative_position_index(JNK.core.train_window).astype(np.int64))
    extra = set(sd) - set(b.pred.model.state_dict())
    assert extra and extra <= unconsumed("zoedepth_nk"), sorted(extra - unconsumed("zoedepth_nk"))
    path = tmp_path / "ZoeD_M12_NK_tiny.pt"
    torch.save({"model": {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}}, path)
    pred = du.ZoeDepthNKPredictor(b.pred.cfg, size=(40, 48), checkpoint_path=str(path),
                                  device="cpu")
    for shape in b.shapes:
        x, want = b.jax_out(shape)
        with torch.inference_mode():
            assert_close(pred.model(torch.from_numpy(x)).numpy(), want)
