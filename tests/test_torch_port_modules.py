"""The port's config, scheduler, mask sets and edit attention against the
JAX package, on the CPU in float32 with inputs made by numpy from a seed."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from geodiffuser_tpu import config as jcfg
from geodiffuser_tpu.core import edit_attention as jea
from geodiffuser_tpu.core import edit_state as jes
from geodiffuser_tpu.core import scheduler as jsched
from geodiffuser_tpu.ops import camera as jcam
from geodiffuser_tpu_torch import config as tcfg
from geodiffuser_tpu_torch.core import edit_attention as tea
from geodiffuser_tpu_torch.core import edit_state as tes
from geodiffuser_tpu_torch.core import scheduler as tsched
from geodiffuser_tpu_torch.ops import camera as tcam

torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


@pytest.mark.parametrize("name", ["EditConfig", "SplatConfig", "SchedulerConfig", "ModelConfig"])
def test_config_fields_match(name):
    """Every field the port keeps equals the JAX default (dtype fields are
    framework types and are compared by name; tiny() too)."""
    pairs = [(getattr(jcfg, name)(), getattr(tcfg, name)())]
    if name == "ModelConfig":
        pairs.append((jcfg.ModelConfig.tiny(), tcfg.ModelConfig.tiny()))
    for j, t in pairs:
        for f in dataclasses.fields(t):
            tv, jv = getattr(t, f.name), getattr(j, f.name)
            if f.name == "dtype":
                assert str(tv).split(".")[-1] == jnp.dtype(jv).name
            elif dataclasses.is_dataclass(tv):
                assert dataclasses.asdict(tv) == dataclasses.asdict(jv), f.name
            else:
                assert tv == jv, f.name
    assert tcfg.EDITOR_LOSS_WEIGHTS == jcfg.EDITOR_LOSS_WEIGHTS


def test_scheduler_matches():
    """The alpha table is float32-exact; steps agree to float32 rounding."""
    js, ts = jsched.make_schedule(), tsched.make_schedule()
    np.testing.assert_array_equal(ts.alphas_cumprod.numpy(), np.asarray(js.alphas_cumprod))
    assert float(ts.final_alpha_cumprod) == float(js.final_alpha_cumprod)
    np.testing.assert_array_equal(tsched.timesteps(50), jsched.timesteps(50))
    np.testing.assert_array_equal(tsched.inverse_timesteps(50), jsched.inverse_timesteps(50))
    rng = np.random.RandomState(1)
    x, eps = rng.randn(2, 8, 8, 4).astype(np.float32), rng.randn(2, 8, 8, 4).astype(np.float32)
    for t in (980, 500, 20, 0):
        a = jsched.ddim_step(js, jnp.asarray(eps), jnp.int32(t), jnp.asarray(x), 50)
        b = tsched.ddim_step(ts, _t(eps), t, _t(x), 50)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5, rtol=1e-6)
        a = jsched.ddim_inverse_step(js, jnp.asarray(eps), jnp.int32(t), jnp.asarray(x), 50)
        b = tsched.ddim_inverse_step(ts, _t(eps), t, _t(x), 50)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5, rtol=1e-6)


IMG = 512                  # image size whose largest latent attention map is 64^2
RES = (64, 32, 16, 8)


def _mask_inputs():
    yy, xx = np.mgrid[0:IMG, 0:IMG]
    mask = (((xx - 200) ** 2 + (yy - 300) ** 2) < 70 ** 2).astype(np.float32)
    tc = np.asarray(jcam.identity_field(IMG, IMG)).copy()
    tc[..., 0] += 0.15
    amodal = np.zeros((IMG, IMG), np.float32)
    amodal[220:380, 110:330] = 1.0
    return mask, tc, amodal


def test_build_mask_sets_matches_at_64():
    """Every MaskSet field at a 64^2 latent, exactly: binary masks, the
    stable-sorted row budgets (ties lowest index first, as lax.top_k) and
    the amodal interpolation sources."""
    mask, tc, amodal = _mask_inputs()
    build = jax.jit(functools.partial(jes.build_mask_sets, resolutions=RES))
    jm = build(jnp.asarray(mask), jnp.asarray(tc), jnp.asarray(amodal))
    tm = tes.build_mask_sets(_t(mask), _t(tc), _t(amodal), RES)
    for res in RES:
        for f in dataclasses.fields(tes.MaskSet):
            a, b = getattr(jm[res], f.name), getattr(tm[res], f.name)
            assert (a is None) == (b is None), (res, f.name)
            if a is None:
                continue
            a, b = np.asarray(a), b.numpy()
            if f.name in ("t_coords", "pos", "interp_vals", "interp_w"):
                # bilinear weights and distances in float32, another order
                np.testing.assert_allclose(b, a, atol=1e-6, rtol=1e-6, err_msg=f"{res} {f.name}")
            else:
                np.testing.assert_array_equal(b, a, err_msg=f"{res} {f.name}")


@pytest.fixture(scope="module")
def attn_masks():
    """Masks at a 16^2 attention map (image 128; the layout of
    tests/test_edit_attention.py at half its size)."""
    size = 128
    mask = np.zeros((size, size), np.float32)
    mask[50:80, 50:80] = 1.0
    tc = np.asarray(jcam.identity_field(size, size)).copy()
    tc[..., 0] += 0.15
    amodal = np.zeros((size, size), np.float32)
    amodal[50:80, 40:90] = 1.0
    res = (16, 8, 4, 2)
    # jitted: op-by-op JAX dispatch of these builders is several times slower
    jm = jax.jit(functools.partial(jes.build_mask_sets, resolutions=res))(
        jnp.asarray(mask), jnp.asarray(tc), jnp.asarray(amodal))
    tm = tes.build_mask_sets(_t(mask), _t(tc), _t(amodal), res)
    jw = jax.jit(functools.partial(jes.build_warp_matrices, z_beta=20.0))(jm, 1.0, 0.8)
    tw = tes.build_warp_matrices(tm, 1.0, 0.8, 20.0)
    return jm, tm, jw, tw


# float32 on both sides; attention, warps and losses in another order.  The
# removal term rides on an argmax over bf16-rounded probabilities, whose
# near-ties may pick another column (another distance weight) in a few rows.
OUT_TOL = dict(atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("path", ["warped_rows", "full_blend"])
def test_edited_attention_cfg_paths_match(attn_masks, path):
    """No-loss CFG blend: the warped-row budget path and the full blend."""
    jm, tm, jw, tw = attn_masks
    cfg_j, cfg_t = jcfg.EditConfig(), tcfg.EditConfig()
    kw = dict(cur_step=3, use_cfg=True, slim_cfg=True, self_window=True, past_obj_edit=False,
              full_blend=path == "full_blend", splat_radius=1.0, splat_tau=0.8)
    sj = jes.make_edit_state(cfg_j, jm, warp_mats=jw, **kw)
    st = tes.make_edit_state(cfg_t, tm, warp_mats=tw, **kw)
    rng = np.random.RandomState(0)
    for is_cross, lk in ((False, 256), (True, 77)):
        q = rng.randn(3, 2, 256, 8).astype(np.float32)
        k, v = (rng.randn(3, 2, lk, 8).astype(np.float32) for _ in range(2))
        oj, _, _ = jax.jit(functools.partial(jea.edited_attention, is_cross=is_cross, scale=0.35))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), state=sj)
        ot, _, _ = tea.edited_attention(_t(q), _t(k), _t(v), is_cross=is_cross, state=st,
                                        scale=0.35)
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), **OUT_TOL)


@pytest.mark.parametrize("is_cross", [False, True])
def test_edited_attention_losses_and_grads_match(attn_masks, is_cross):
    """Optimize-pass attention ([base, edit] streams): output, every loss
    term and the gradients of the weighted loss with respect to q, k, v."""
    jm, tm, jw, tw = attn_masks
    kw = dict(cur_step=2, use_cfg=False, compute_losses=True, self_window=True,
              past_obj_edit=False, splat_radius=1.0, splat_tau=0.8)
    sj = jes.make_edit_state(jcfg.EditConfig(), jm, warp_mats=jw, **kw)
    st = tes.make_edit_state(tcfg.EditConfig(), tm, warp_mats=tw, **kw)
    rng = np.random.RandomState(1)
    lk = 77 if is_cross else 256
    q = rng.randn(2, 2, 256, 8).astype(np.float32)
    k, v = (rng.randn(2, 2, lk, 8).astype(np.float32) for _ in range(2))
    co = rng.randn(2, 2, 256, 8).astype(np.float32) * 1e-2

    def jfn(q_, k_, v_):
        out, loss, logs = jea.edited_attention(q_, k_, v_, is_cross=is_cross, state=sj, scale=0.35)
        return loss + jnp.sum(out * co), (out, logs)

    (_, (oj, logs_j)), gj = jax.jit(jax.value_and_grad(jfn, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    qt, kt, vt = (_t(x).requires_grad_(True) for x in (q, k, v))
    ot, loss_t, logs_t = tea.edited_attention(qt, kt, vt, is_cross=is_cross, state=st, scale=0.35)
    (loss_t + (ot * _t(co)).sum()).backward()
    np.testing.assert_allclose(ot.detach().numpy(), np.asarray(oj), **OUT_TOL)
    for key, val in logs_j.items():
        tol = dict(atol=1e-4, rtol=2e-2) if key.endswith("removal") else dict(atol=1e-6, rtol=1e-4)
        np.testing.assert_allclose(float(logs_t[key]), float(val), err_msg=key, **tol)
    assert logs_t["num_layers"] == 1.0
    for g, r, name in zip((qt.grad, kt.grad, vt.grad), gj, "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4, rtol=1e-2, err_msg=name)


def test_camera_compose_and_identity_match():
    np.testing.assert_allclose(tcam.compose_transform(tx=0.08, ry=15.0),
                               jcam.compose_transform(tx=0.08, ry=15.0))
    # linspace end points are exact; interior points may differ by an ulp
    np.testing.assert_allclose(tcam.identity_field(16, 16).numpy(),
                               np.asarray(jcam.identity_field(16, 16)), atol=3e-7)
