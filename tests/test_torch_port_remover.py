"""The port's remover mode against the JAX package: mask sets, the remover
attention stream, the step functions and one whole tiny remover edit,
ModelConfig.tiny() in float32 on the CPU.

As in tests/test_torch_port_edit.py, one module-scoped JAX pipeline (random
init from a seed) supplies the weights and the JAX package's CPU routing
(vanilla attention, `_corr_xla`) is the reference.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from geodiffuser_tpu.config import EditConfig as JEditConfig
from geodiffuser_tpu.config import ModelConfig as JModelConfig
from geodiffuser_tpu.core import edit_attention as jea
from geodiffuser_tpu.core import edit_state as jes
from geodiffuser_tpu.core import optimization as jopt
from geodiffuser_tpu.core.editor import EditSession as JEditSession
from geodiffuser_tpu.core.pipeline import Pipeline as JPipeline
from geodiffuser_tpu.ops import camera as jcam
from geodiffuser_tpu_torch.config import EditConfig, ModelConfig
from geodiffuser_tpu_torch.core import edit_attention as tea
from geodiffuser_tpu_torch.core import edit_state as tes
from geodiffuser_tpu_torch.core import optimization
from geodiffuser_tpu_torch.core.editor import EditSession
from geodiffuser_tpu_torch.core.pipeline import Pipeline
from geodiffuser_tpu_torch.models.weights import from_jax_params

torch.set_num_threads(1)

SIZE = 128
# the tests/test_editor.py:85-92 remover schedule
EDIT = dict(edit_type="geometry_remover", num_ddim_steps=4, optimize_steps=0.65,
            skip_optim_steps=2, obj_edit_step=0.5)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


@pytest.fixture(scope="module")
def pipes():
    jp = JPipeline.create(JModelConfig.tiny(), image_size=SIZE)
    params = jax.tree.map(np.asarray, jp.params)
    tp = Pipeline.create(ModelConfig.tiny(), image_size=SIZE, device="cpu")
    tp.load_state_dicts(from_jax_params(params, ModelConfig.tiny()))
    return jp, tp


@pytest.fixture(scope="module")
def sessions(pipes):
    """One JAX remover session for the step and whole-edit tests, so that
    its step programs compile once; lr=0 as in test_torch_port_edit.py."""
    jp, tp = pipes
    return (JEditSession(jp, JEditConfig(**EDIT, lr=0.0)),
            EditSession(tp, EditConfig(**EDIT, lr=0.0), device="cpu"))


@pytest.fixture(scope="module")
def scene():
    """The tests/test_editor.py:27-34 scene."""
    rng = np.random.RandomState(0)
    image = rng.rand(SIZE, SIZE, 3).astype(np.float32)
    yy, xx = np.mgrid[0:SIZE, 0:SIZE]
    mask = (((xx - 50) ** 2 + (yy - 70) ** 2) < 25 ** 2).astype(np.float32)
    depth = np.full((SIZE, SIZE), 0.5, np.float32)
    return image, depth, mask


def test_remover_mask_sets_match_jax():
    """Every remover MaskSet field at a 64^2 latent, exactly: the x5
    dilation, inpaint = the dilated mask, and the seq//2 removal-row budget
    (2048 rows at 64^2)."""
    img, res = 512, (64, 32, 16, 8)
    yy, xx = np.mgrid[0:img, 0:img]
    mask = (((xx - 200) ** 2 + (yy - 300) ** 2) < 70 ** 2).astype(np.float32)
    tc = np.asarray(jcam.identity_field(img, img))
    amodal = np.zeros((img, img), np.float32)
    jm = jax.jit(functools.partial(jes.build_mask_sets, resolutions=res, mode="remover"))(
        jnp.asarray(mask), jnp.asarray(tc), jnp.asarray(amodal))
    tm = tes.build_mask_sets(_t(mask), _t(tc), _t(amodal), res, mode="remover")
    assert tm[64].inpaint_rows.shape == (2048,)
    assert 0 < float(tm[64].inpaint_row_mask.sum()) < 2048
    for r in res:
        for f in dataclasses.fields(tes.MaskSet):
            a, b = getattr(jm[r], f.name), getattr(tm[r], f.name)
            assert (a is None) == (b is None), (r, f.name)
            if a is None:
                continue
            a, b = np.asarray(a), b.numpy()
            if f.name in ("t_coords", "pos", "interp_vals", "interp_w"):
                # bilinear weights and distances in float32, another order
                np.testing.assert_allclose(b, a, atol=1e-6, rtol=1e-6, err_msg=f"{r} {f.name}")
            else:
                np.testing.assert_array_equal(b, a, err_msg=f"{r} {f.name}")


@pytest.fixture(scope="module")
def remover_masks():
    """Remover masks at a 16^2 attention map (image 128)."""
    mask = np.zeros((128, 128), np.float32)
    mask[50:80, 50:80] = 1.0
    tc = np.asarray(jcam.identity_field(128, 128))
    res = (16, 8, 4, 2)
    jm = jax.jit(functools.partial(jes.build_mask_sets, resolutions=res, mode="remover"))(
        jnp.asarray(mask), jnp.asarray(tc), None)
    tm = tes.build_mask_sets(_t(mask), _t(tc), None, res, mode="remover")
    return jm, tm


@pytest.mark.parametrize("is_cross,past_obj", [(False, False), (True, False), (False, True)])
def test_remover_attention_losses_and_grads_match(remover_masks, is_cross, past_obj):
    """Optimize-pass remover attention ([base, edit] streams): output (with
    and without the identity blend past obj_edit_step), the sim, removal and
    smoothness terms and the gradients of the weighted loss."""
    jm, tm = remover_masks
    kw = dict(cur_step=2, use_cfg=False, compute_losses=True, self_window=True,
              past_obj_edit=past_obj)
    sj = jes.make_edit_state(JEditConfig(edit_type="geometry_remover"), jm, **kw)
    st = tes.make_edit_state(EditConfig(edit_type="geometry_remover"), tm, **kw)
    assert st.mode == "remover"
    rng = np.random.RandomState(3)
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
    np.testing.assert_allclose(ot.detach().numpy(), np.asarray(oj), atol=2e-5, rtol=1e-4)
    prefix = "cross" if is_cross else "self"
    assert float(logs_t[f"{prefix}/removal"].detach()) != 0.0
    assert logs_t[f"{prefix}/movement"] == logs_t[f"{prefix}/amodal"] == 0.0
    for key, val in logs_j.items():
        tol = dict(atol=1e-4, rtol=2e-2) if key.endswith("removal") else dict(atol=1e-6, rtol=1e-4)
        np.testing.assert_allclose(float(logs_t[key]), float(val), err_msg=key, **tol)
    for g, r, name in zip((qt.grad, kt.grad, vt.grad), gj, "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4, rtol=1e-2, err_msg=name)


def test_remover_step_functions_match(pipes, sessions, scene):
    """One remover optimize step (taps pass, sim/removal/smoothness losses,
    gradients, masked SGD update, norm projection) and the taps and slim CFG
    steps, on latents where the base and edit streams differ."""
    jp, tp = pipes
    image, depth, mask = scene
    js, ts = sessions
    eye = np.eye(4, dtype=np.float32)
    _, mj = js._preprocess(jnp.asarray(image), jnp.asarray(depth), jnp.asarray(mask),
                           jnp.asarray(eye))
    _, mt = ts._preprocess(_t(image), _t(depth), _t(mask), _t(eye))
    full_blend = ts._full_blend(mt)
    wmj = js._warp_mats(mj, np.float32(1.0), np.float32(0.8))
    rng = np.random.RandomState(2)
    lat = rng.randn(2, SIZE // 8, SIZE // 8, 4).astype(np.float32)
    ctx = rng.randn(4, 77, 32).astype(np.float32)
    pinned = rng.randn(1, SIZE // 8, SIZE // 8, 4).astype(np.float32)
    w = {b: dict(t) for b, t in JEditConfig(**EDIT).resolved_loss_weights().items()}
    wa = {b: {k: np.float32(v) for k, v in t.items()} for b, t in w.items()}
    lr = np.float32(1.5)

    oj = js._optimize_step(jp.params["unet"], jnp.asarray(lat), jnp.asarray(ctx), np.int32(750),
                           mj, np.int32(0), wa, np.float32(1.0), np.float32(0.8), lr,
                           jopt.init_sgd_state(jnp.asarray(lat[1]), jnp.asarray(ctx[3])), wmj,
                           self_window=True, past_obj=False)
    # the remover reads no warp operator: the port passes none
    ot = ts._optimize_step(_t(lat), _t(ctx), 750, mt, 0, w, 1.0, 0.8, float(lr),
                           optimization.init_sgd_state(_t(lat[1]), _t(ctx[3])), None, True, False)
    np.testing.assert_allclose(ot[0].numpy(), np.asarray(oj[0]), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(ot[1].numpy(), np.asarray(oj[1]), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(ot[2].mom_latent.numpy(), np.asarray(oj[2].mom_latent),
                               atol=1e-5, rtol=1e-4)
    log_j = np.asarray(oj[3])
    logs_j = jea.normalize_logs(dict(zip(sorted(jea.zero_logs()), log_j[1:].tolist())))
    logs_j["total"] = float(log_j[0])
    assert set(ot[3]) == set(logs_j)
    assert ot[3]["self/removal"] != 0.0 and ot[3]["self/movement"] == 0.0
    for key, val in logs_j.items():
        tol = dict(rtol=1e-2, atol=1e-4) if key.endswith("removal") else dict(rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(ot[3][key], val, err_msg=key, **tol)

    # taps CFG step inside the latent-replace window: the remover replaces nothing
    cj = js._cfg_step_taps(jp.params["unet"], oj[0], oj[1], np.int32(750), mj, np.int32(0), wa,
                           np.float32(1.0), np.float32(0.8), jnp.asarray(pinned), np.bool_(True),
                           wmj, oj[4], self_window=True, past_obj=False, full_blend=full_blend)
    ct = ts._cfg_step(ot[0], ot[1], 750, mt, 0, w, 1.0, 0.8, _t(pinned), True, None, True, False,
                      full_blend, taps=ot[4])
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-4, rtol=1e-4)
    # slim CFG step (the run's step 1, whose program test_remover_edit_matches_jax
    # reuses; the identity blend past obj_edit_step is held there)
    cj = js._cfg_step(jp.params["unet"], oj[0], oj[1], np.int32(500), mj, np.int32(1), wa,
                      np.float32(1.0), np.float32(0.8), jnp.asarray(pinned), np.bool_(False),
                      wmj, self_window=True, past_obj=False, full_blend=full_blend)
    ct = ts._cfg_step(ot[0], ot[1], 500, mt, 1, w, 1.0, 0.8, _t(pinned), False, None, True, False,
                      full_blend)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-4, rtol=1e-4)


def test_remover_edit_matches_jax(sessions, scene):
    """One whole remover EditSession.run at lr=0 (see
    test_torch_port_edit.test_edit_slice_matches_jax): loss logs of steps 0
    and 2, adaptive weights, final latents, reconstruction and the remover's
    histogram-matched image."""
    js, ts = sessions
    image, depth, mask = scene
    decode = js._decode_bundle_fn()
    final = []   # the JAX run's final [base, edit] latents, as decoded
    js._decode_bundle = lambda p, lat, *a: (final.append(np.asarray(lat)), decode(p, lat, *a))[1]
    jr = js.run(image, depth, mask, np.eye(4), prompt="")
    tr = ts.run(image, depth, mask, np.eye(4), prompt="")
    assert set(tr.loss_log) == set(jr.loss_log) == {0, 2}
    for i in (0, 2):
        assert tr.loss_log[i]["num_layers"] == jr.loss_log[i]["num_layers"] > 0
        assert tr.loss_log[i]["self/removal"] != 0.0
        for key, val in jr.loss_log[i].items():
            # near-tied removal argmaxes over bf16-rounded probabilities
            tol = dict(rtol=1e-2, atol=1e-4) if key.endswith("removal") else dict(rtol=1e-4, atol=1e-6)
            np.testing.assert_allclose(tr.loss_log[i][key], val, err_msg=f"{i} {key}", **tol)
    assert set(tr.weight_log) == set(jr.weight_log)
    for i, w in jr.weight_log.items():
        assert tr.weight_log[i] == pytest.approx(w, rel=1e-6)
    np.testing.assert_allclose(tr.latents.numpy(), final[0], atol=1e-4, rtol=1e-4)
    assert np.abs(tr.images.astype(int) - jr.images.astype(int)).max() <= 2
    assert np.abs(tr.edited_image.astype(int) - jr.edited_image.astype(int)).max() <= 4
