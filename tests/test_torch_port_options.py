"""The port's editor run options against the JAX package, on the CPU in
float32: the on-disk inversion cache, `reconstruct`, null-text
optimization and the attention constraints; and the run wiring of the
options at a tiny size.

One module-scoped JAX UNet (ModelConfig.tiny(), random init from a seed)
supplies the weights of the inversion tests, carried into the port's UNet
as `from_jax_params` carries them; the JAX functions read only the
pipeline's UNet and schedule.  Every JAX reference call is jitted.
"""

import functools
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from geodiffuser_tpu import config as jcfg
from geodiffuser_tpu.config import ModelConfig as JModelConfig
from geodiffuser_tpu.core import edit_attention as jea
from geodiffuser_tpu.core import edit_state as jes
from geodiffuser_tpu.core import inversion as jinv
from geodiffuser_tpu.core import scheduler as jsched
from geodiffuser_tpu.models.unet import UNet2DCondition as JUNet
from geodiffuser_tpu.ops import camera as jcam
from geodiffuser_tpu.utils import exp_io as jexp_io
from geodiffuser_tpu_torch import config as tcfg
from geodiffuser_tpu_torch.config import EditConfig, ModelConfig
from geodiffuser_tpu_torch.core import edit_attention as tea
from geodiffuser_tpu_torch.core import edit_state as tes
from geodiffuser_tpu_torch.core import editor, inversion
from geodiffuser_tpu_torch.core.pipeline import Pipeline
from geodiffuser_tpu_torch.models import weights
from geodiffuser_tpu_torch.ops import camera
from geodiffuser_tpu_torch.utils import exp_io

pytest_plugins = ("heap_trim",)

torch.set_num_threads(1)

SIZE = 64   # latent 8 x 8: the tiny UNet's smallest map is 1 x 1


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


@pytest.fixture(scope="module")
def pipes():
    """(JAX pipeline view, port pipeline) with one UNet's weights."""
    cfg = JModelConfig.tiny()
    unet = JUNet(cfg)
    params = jax.jit(unet.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 4)), jnp.int32(0),
                                jnp.zeros((1, cfg.text_max_length, cfg.cross_attention_dim)))
    jp = types.SimpleNamespace(unet=unet, schedule=jsched.make_schedule(),
                               params={"unet": params})
    tp = Pipeline.create(ModelConfig.tiny(), image_size=SIZE, device="cpu")
    tp.unet.load_state_dict(weights._convert(jax.tree.map(np.asarray, params)))
    return jp, tp


@pytest.fixture(scope="module")
def trajectory(pipes):
    """A 2-step inversion trajectory and the text contexts, from a seed."""
    jp, tp = pipes
    rng = np.random.RandomState(4)
    latents = rng.randn(3, 1, SIZE // 8, SIZE // 8, 4).astype(np.float32)
    ctx_u, ctx_c = (rng.randn(1, 77, 32).astype(np.float32) for _ in range(2))
    return latents, ctx_u, ctx_c


def test_inversion_file_round_trip_and_jax_reads_it(tmp_path):
    """save/load in the port round-trip the float32 trajectory bit for bit
    under its key, another key or a missing folder reads as a miss, and the
    JAX package's load_inversion reads the port's file with its key."""
    lat = np.random.RandomState(0).randn(3, 1, 8, 8, 4).astype(np.float32)
    folder = str(tmp_path)
    assert exp_io.load_inversion(folder, "k1") is None
    exp_io.save_inversion(folder, "k1", lat)
    np.testing.assert_array_equal(exp_io.load_inversion(folder, "k1"), lat)
    assert exp_io.load_inversion(folder, "k2") is None
    np.testing.assert_array_equal(jexp_io.load_inversion(folder, "k1"), lat)
    exp_io.save_inversion(str(tmp_path / "missing"), "k1", lat)   # no folder: nothing written
    assert not (tmp_path / "missing").exists()
    jexp_io.save_inversion(folder, "k3", lat[:2])
    np.testing.assert_array_equal(exp_io.load_inversion(folder, "k3"), lat[:2])
    (tmp_path / exp_io.INVERSION_CACHE_FILE).write_bytes(b"not a zip")
    assert exp_io.load_inversion(folder, "k3") is None


# float32 UNet passes on both sides, summed in another order (the edit
# tests' MODEL_TOL), compounded over 2 steps
STEP_TOL = dict(atol=1e-4, rtol=1e-4)


def test_reconstruct_matches_jax(pipes, trajectory):
    """CFG DDIM sampling from an inverted latent, 2 steps."""
    jp, tp = pipes
    latents, ctx_u, ctx_c = trajectory
    ref = jax.jit(lambda p, x, u, c: jinv.reconstruct(jp, p, x, u, c, 3.0, 2))(
        jp.params["unet"], jnp.asarray(latents[-1]), jnp.asarray(ctx_u), jnp.asarray(ctx_c))
    got = inversion.reconstruct(tp, _t(latents[-1]), _t(ctx_u), _t(ctx_c), 3.0, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **STEP_TOL)


def test_null_text_optimization_matches_jax(pipes, trajectory):
    """Per-timestep Adam on the uncond embedding: 2 timesteps, 2 inner
    steps each (early stop off), against the JAX package's optax loop.
    Both sides take the same Adam arithmetic on gradients that agree to
    float32 summation order, but Adam divides each gradient by its own
    magnitude: where an element's gradient is near 0 its step (up to lr =
    1e-2) follows the gradients' rounding, so the embeddings agree to 1e-4
    absolute (1 % of a step), not to float32."""
    jp, tp = pipes
    latents, ctx_u, ctx_c = trajectory
    kw = dict(guidance_scale=3.0, num_steps=2, num_inner_steps=2, early_stop_eps=-1.0)
    ref = jinv.null_text_optimization(jp, jp.params["unet"], jnp.asarray(latents),
                                      jnp.asarray(ctx_u), jnp.asarray(ctx_c), **kw)
    got = inversion.null_text_optimization(tp, _t(latents), _t(ctx_u), _t(ctx_c), **kw)
    assert got.shape == ref.shape == (2, 1, 77, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)
    # the embedding moved: each Adam step changes it by about lr
    assert float((got[0] - _t(ctx_u)).abs().max()) > 1e-3


@pytest.fixture(scope="module")
def attn_masks():
    """Masks at a 16^2 attention map (image 128), the layout of
    tests/test_torch_port_modules.py."""
    size = 128
    mask = np.zeros((size, size), np.float32)
    mask[50:80, 50:80] = 1.0
    tc = np.asarray(jcam.identity_field(size, size)).copy()
    tc[..., 0] += 0.15
    amodal = np.zeros((size, size), np.float32)
    amodal[50:80, 40:90] = 1.0
    res = (16, 8, 4, 2)
    jm = jax.jit(functools.partial(jes.build_mask_sets, resolutions=res))(
        jnp.asarray(mask), jnp.asarray(tc), jnp.asarray(amodal))
    tm = tes.build_mask_sets(_t(mask), _t(tc), _t(amodal), res)
    jw = jax.jit(functools.partial(jes.build_warp_matrices, z_beta=20.0))(jm, 1.0, 0.8)
    tw = tes.build_warp_matrices(tm, 1.0, 0.8, 20.0)
    return jm, tm, jw, tw


def test_constraint_bias_matches_jax(attn_masks):
    """The -1000 bias of the constrained self-attention, exactly, at a
    square and a narrower key count."""
    jm, tm, _, _ = attn_masks
    for lk in (256, 100):
        ref = jax.jit(jea._constraint_bias, static_argnums=1)(jm[16], lk)
        got = tea._constraint_bias(tm[16], lk)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert float(got.min()) == -1000.0 and float(got.max()) == 0.0


def _flips(got, ref, atol, rtol, share=0.01):
    """got within (atol, rtol) of ref but where a probability's bf16
    rounding flipped (float32 logits one ulp apart on either side of a bf16
    rounding boundary): at most `share` of the elements, each off by at
    most one bf16 step (2^-8) of the largest value."""
    diff = np.abs(got - ref)
    off = diff > atol + rtol * np.abs(ref)
    assert off.mean() <= share, off.mean()
    assert diff.max() <= 2.0 ** -8 * np.abs(ref).max(), (diff.max(), np.abs(ref).max())


@pytest.mark.parametrize("compute_losses", [True, False])
def test_constrained_edited_attention_matches_jax(attn_masks, compute_losses):
    """apply_constraints=True: the self layer's explicit edit attention
    (logits plus the bias, the softmax in bf16) and, in the optimize pass,
    the removal loss from the explicit maps; output, every loss term and
    the gradients of loss + <out, co> with respect to q, k, v, at the
    tolerances of tests/test_torch_port_modules.py (`_flips` adds its
    exception; the removal term rides on an argmax that may take another
    column on a near-tie)."""
    jm, tm, jw, tw = attn_masks
    kw = dict(cur_step=2, use_cfg=not compute_losses, compute_losses=compute_losses,
              self_window=True, past_obj_edit=False, splat_radius=1.0, splat_tau=0.8,
              slim_cfg=not compute_losses)
    sj = jes.make_edit_state(jcfg.EditConfig(apply_attention_constraints=True), jm,
                             warp_mats=jw, **kw)
    st = tes.make_edit_state(tcfg.EditConfig(apply_attention_constraints=True), tm,
                             warp_mats=tw, **kw)
    assert st.apply_constraints
    rng = np.random.RandomState(5)
    s = 2 if compute_losses else 3
    q, k, v = (rng.randn(s, 2, 256, 8).astype(np.float32) for _ in range(3))
    co = rng.randn(s, 2, 256, 8).astype(np.float32) * 1e-2

    def jfn(q_, k_, v_):
        out, loss, logs = jea.edited_attention(q_, k_, v_, is_cross=False, state=sj, scale=0.35)
        return loss + jnp.sum(out * co), (out, logs)

    (_, (oj, logs_j)), gj = jax.jit(jax.value_and_grad(jfn, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    qt, kt, vt = (_t(x).requires_grad_(True) for x in (q, k, v))
    ot, loss_t, logs_t = tea.edited_attention(qt, kt, vt, is_cross=False, state=st, scale=0.35)
    (loss_t + (ot * _t(co)).sum()).backward()
    _flips(ot.detach().numpy(), np.asarray(oj), atol=2e-5, rtol=1e-4)
    for key, val in logs_j.items():
        tol = dict(atol=1e-4, rtol=2e-2) if key.endswith("removal") else dict(atol=1e-6, rtol=1e-4)
        np.testing.assert_allclose(float(logs_t[key].detach() if torch.is_tensor(logs_t[key])
                                         else logs_t[key]), float(val), err_msg=key, **tol)
    for g, r in zip((qt.grad, kt.grad, vt.grad), gj):
        _flips(g.numpy(), np.asarray(r), atol=1e-4, rtol=1e-2)
    # the constraint moved the output: the unconstrained edit attention differs
    free = tea.edited_attention(_t(q), _t(k), _t(v), is_cross=False, scale=0.35,
                                state=tes.make_edit_state(tcfg.EditConfig(), tm, warp_mats=tw,
                                                          **kw))[0]
    assert float((free - ot.detach()).abs().max()) > 1e-3


def test_run_options_wiring(monkeypatch, tmp_path):
    """EditSession.run with every option on, at a tiny size: the second run
    in a new session reads the inversion from the experiment folder instead
    of inverting; null-text gives each step's two uncond streams that step's
    embedding; the fast start runs num_first_optim_steps iterations of the
    first optimize step only; the constraints reach the edit state."""
    size = 64
    pipe = Pipeline.create(ModelConfig.tiny(), image_size=size, device="cpu")
    rng = np.random.RandomState(0)
    image = rng.rand(size, size, 3).astype(np.float32)
    yy, xx = np.mgrid[0:size, 0:size]
    mask = (((xx - 25) ** 2 + (yy - 35) ** 2) < 12 ** 2).astype(np.float32)
    depth = np.full((size, size), 0.5, np.float32)
    cfg = EditConfig(num_ddim_steps=4, optimize_steps=0.65, skip_optim_steps=1,
                     fast_start_steps=0.25, num_first_optim_steps=3,
                     apply_attention_constraints=True)
    calls = {"invert": 0, "optimize": [], "cfg": []}
    invert = inversion.ddim_invert

    def count_invert(*a, **kw):
        calls["invert"] += 1
        return invert(*a, **kw)

    def tagged_null_text(pipe_, all_latents, ctx_u, ctx_c, guidance_scale, num_steps):
        # step i's embedding holds the value i everywhere
        assert all_latents.shape[0] == num_steps + 1 and guidance_scale == cfg.guidance_scale
        return torch.arange(num_steps, dtype=torch.float32)[:, None, None, None].expand(
            num_steps, *ctx_u.shape)

    optimize, cfg_step = editor.EditSession._optimize_step, editor.EditSession._cfg_step
    monkeypatch.setattr(inversion, "ddim_invert", count_invert)
    monkeypatch.setattr(inversion, "null_text_optimization", tagged_null_text)
    monkeypatch.setattr(editor.EditSession, "_optimize_step", lambda self, *a: (
        calls["optimize"].append(a[4]), optimize(self, *a))[1])
    monkeypatch.setattr(editor.EditSession, "_cfg_step", lambda self, lat, ctx, *a, **kw: (
        calls["cfg"].append((a[2], ctx[:2].clone())), cfg_step(self, lat, ctx, *a, **kw))[1])
    for run in (1, 2):
        res = editor.EditSession(pipe, cfg, device="cpu").run(
            image, depth, mask, camera.compose_transform(tx=0.05), use_null_text=True,
            exp_folder=str(tmp_path))
        assert calls["invert"] == 1, run
        assert (tmp_path / exp_io.INVERSION_CACHE_FILE).exists()
        assert np.isfinite(res.latents.numpy()).all()
    # steps 1 and 2 optimize (i >= 0.25 * 4, i < 0.65 * 4); step 1 three times
    assert calls["optimize"] == [1, 1, 1, 2] * 2
    assert sorted(res.loss_log) == [1, 2]
    for i, ctx in calls["cfg"]:
        assert torch.equal(ctx, torch.full_like(ctx, float(i))), i
