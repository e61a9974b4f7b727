"""The port's models, step functions and one whole edit against the JAX
package: ModelConfig.tiny(), float32, on the CPU.

One module-scoped JAX pipeline (random init from a seed) supplies the
weights; `from_jax_params` carries them into the port.  On the CPU the JAX
package routes attention through vanilla math and the removal correlation
through `_corr_xla` (`_on_tpu()` is False); that is the reference here.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from geodiffuser_tpu.config import EditConfig as JEditConfig
from geodiffuser_tpu.config import ModelConfig as JModelConfig
from geodiffuser_tpu.core import edit_attention as jea
from geodiffuser_tpu.core import optimization as jopt
from geodiffuser_tpu.core.editor import EditSession as JEditSession
from geodiffuser_tpu.core.pipeline import Pipeline as JPipeline
from geodiffuser_tpu.ops import camera as jcam
from geodiffuser_tpu_torch.config import EditConfig, ModelConfig
from geodiffuser_tpu_torch.core import edit_state, editor, optimization
from geodiffuser_tpu_torch.core.editor import EditSession
from geodiffuser_tpu_torch.core.pipeline import Pipeline
from geodiffuser_tpu_torch.models.weights import from_jax_params

torch.set_num_threads(1)

SIZE = 128
# the tests/test_editor.py:70 schedule
EDIT = dict(num_ddim_steps=4, optimize_steps=0.65, skip_optim_steps=2, latent_replace=0.3)


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
    """One JAX session for the step and slice tests, so that its step
    programs compile once.  lr=0 (see test_edit_slice_matches_jax); the step
    test passes its own step size."""
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


# float32 models on both sides, summed in another order
MODEL_TOL = dict(atol=2e-5, rtol=1e-4)


def test_models_match_with_carried_weights(pipes):
    """CLIP text, VAE encode/decode and the UNet with `from_jax_params` weights."""
    jp, tp = pipes
    prompts = ["a cat on a mat", ""]
    np.testing.assert_allclose(tp.encode_text(prompts).numpy(),
                               np.asarray(jp.encode_text(prompts)), **MODEL_TOL)
    rng = np.random.RandomState(1)
    img = rng.rand(SIZE, SIZE, 3).astype(np.float32)
    np.testing.assert_allclose(tp.encode_image(_t(img)).numpy(),
                               np.asarray(jp.encode_image(jnp.asarray(img))), **MODEL_TOL)
    lat = rng.randn(2, SIZE // 8, SIZE // 8, 4).astype(np.float32)
    decoded = tp.vae.decode(_t(lat)).numpy()
    ref = jax.jit(lambda p, z: jp.vae.apply(p, z, method=jp.vae.decode))(jp.params["vae"],
                                                                        jnp.asarray(lat))
    np.testing.assert_allclose(decoded, np.asarray(ref), **MODEL_TOL)
    ctx = rng.randn(2, 77, 32).astype(np.float32)
    out = tp.unet(_t(lat), 500, _t(ctx)).numpy()
    ref = jax.jit(jp.unet.apply)(jp.params["unet"], jnp.asarray(lat), jnp.int32(500),
                                 jnp.asarray(ctx))
    np.testing.assert_allclose(out, np.asarray(ref), **MODEL_TOL)


def test_step_functions_match(pipes, sessions, scene):
    """One optimize step (taps pass, loss, gradients, masked SGD update,
    norm projection) and the taps and slim CFG steps, on latents where the
    base and edit streams differ."""
    jp, tp = pipes
    image, depth, mask = scene
    js, ts = sessions
    transform = jcam.compose_transform(tx=0.05)
    _, mj = js._preprocess(jnp.asarray(image), jnp.asarray(depth), jnp.asarray(mask),
                           jnp.asarray(transform, jnp.float32))
    _, mt = ts._preprocess(_t(image), _t(depth), _t(mask), _t(transform))
    full_blend = ts._full_blend(mt)   # the run's CFG variant (compiled once)
    wmj = js._warp_mats(mj, np.float32(1.0), np.float32(0.8))
    wmt = edit_state.build_warp_matrices(mt, 1.0, 0.8, 20.0)
    rng = np.random.RandomState(2)
    lat = rng.randn(2, SIZE // 8, SIZE // 8, 4).astype(np.float32)
    ctx = rng.randn(4, 77, 32).astype(np.float32)
    pinned = rng.randn(1, SIZE // 8, SIZE // 8, 4).astype(np.float32)
    w = {b: dict(t) for b, t in JEditConfig().resolved_loss_weights().items()}
    wa = {b: {k: np.float32(v) for k, v in t.items()} for b, t in w.items()}
    lr = np.float32(1.5)

    oj = js._optimize_step(jp.params["unet"], jnp.asarray(lat), jnp.asarray(ctx), np.int32(750),
                           mj, np.int32(0), wa, np.float32(1.0), np.float32(0.8), lr,
                           jopt.init_sgd_state(jnp.asarray(lat[1]), jnp.asarray(ctx[3])), wmj,
                           self_window=True, past_obj=False)
    ot = ts._optimize_step(_t(lat), _t(ctx), 750, mt, 0, w, 1.0, 0.8, float(lr),
                           optimization.init_sgd_state(_t(lat[1]), _t(ctx[3])), wmt, True, False)
    # the update is lr * (1 + mask) * gradient: float32 gradients through the
    # UNet agree to ~1e-5 relative
    np.testing.assert_allclose(ot[0].numpy(), np.asarray(oj[0]), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(ot[1].numpy(), np.asarray(oj[1]), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(ot[2].mom_latent.numpy(), np.asarray(oj[2].mom_latent),
                               atol=1e-5, rtol=1e-4)
    log_j = np.asarray(oj[3])
    logs_j = jea.normalize_logs(dict(zip(sorted(jea.zero_logs()), log_j[1:].tolist())))
    logs_j["total"] = float(log_j[0])
    assert set(ot[3]) == set(logs_j)
    for key, val in logs_j.items():
        tol = dict(rtol=1e-2, atol=1e-4) if key.endswith("removal") else dict(rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(ot[3][key], val, err_msg=key, **tol)

    cj = js._cfg_step_taps(jp.params["unet"], oj[0], oj[1], np.int32(750), mj, np.int32(0), wa,
                           np.float32(1.0), np.float32(0.8), jnp.asarray(pinned), np.bool_(True),
                           wmj, oj[4], self_window=True, past_obj=False, full_blend=full_blend)
    ct = ts._cfg_step(ot[0], ot[1], 750, mt, 0, w, 1.0, 0.8, _t(pinned), True, wmt, True, False,
                      full_blend, taps=ot[4])
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-4, rtol=1e-4)
    cj = js._cfg_step(jp.params["unet"], oj[0], oj[1], np.int32(500), mj, np.int32(1), wa,
                      np.float32(1.0), np.float32(0.8), jnp.asarray(pinned), np.bool_(False),
                      wmj, self_window=True, past_obj=False, full_blend=full_blend)
    ct = ts._cfg_step(ot[0], ot[1], 500, mt, 1, w, 1.0, 0.8, _t(pinned), False, wmt, True, False,
                      full_blend)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-4, rtol=1e-4)


def test_fast_start_keeps_the_lowest_loss_snapshot(pipes, sessions, scene):
    """The fast start's inner loop (`optimize_iterations`, two iterations of
    the first optimize step) on the inputs of test_step_functions_match,
    where base and edit streams differ: each iteration's loss against two
    chained JAX optimize steps, and the state kept against the one the JAX
    editor keeps (editor.py:1011-1047): the pre-update (latents, context)
    of the iteration whose logged loss is lowest; the SGD state is the last
    iteration's.  Tolerances of test_step_functions_match."""
    jp, tp = pipes
    image, depth, mask = scene
    js, ts = sessions
    transform = jcam.compose_transform(tx=0.05)
    _, mj = js._preprocess(jnp.asarray(image), jnp.asarray(depth), jnp.asarray(mask),
                           jnp.asarray(transform, jnp.float32))
    _, mt = ts._preprocess(_t(image), _t(depth), _t(mask), _t(transform))
    wmj = js._warp_mats(mj, np.float32(1.0), np.float32(0.8))
    wmt = edit_state.build_warp_matrices(mt, 1.0, 0.8, 20.0)
    rng = np.random.RandomState(2)
    lat = rng.randn(2, SIZE // 8, SIZE // 8, 4).astype(np.float32)
    ctx = rng.randn(4, 77, 32).astype(np.float32)
    w = {b: dict(t) for b, t in JEditConfig().resolved_loss_weights().items()}
    wa = {b: {k: np.float32(v) for k, v in t.items()} for b, t in w.items()}
    lr = np.float32(1.5)
    # the JAX editor's inner loop, step by step
    states, totals = [(jnp.asarray(lat), jnp.asarray(ctx),
                       jopt.init_sgd_state(jnp.asarray(lat[1]), jnp.asarray(ctx[3])))], []
    for _ in range(2):
        out = js._optimize_step(jp.params["unet"], *states[-1][:2], np.int32(750), mj, np.int32(0),
                                wa, np.float32(1.0), np.float32(0.8), lr, states[-1][2], wmj,
                                self_window=True, past_obj=False)
        states.append(out[:3])
        totals.append(float(np.asarray(out[3])[0]))
    kept_j = states[int(np.argmin(totals))]

    logged = []

    def step(lat2, ctx4, sgd):
        out = ts._optimize_step(lat2, ctx4, 750, mt, 0, w, 1.0, 0.8, float(lr), sgd, wmt,
                                True, False)
        logged.append(out[3]["total"])
        return out

    lat_t, ctx_t, sgd_t, logs_t, _ = editor.optimize_iterations(
        step, 2, _t(lat), _t(ctx), optimization.init_sgd_state(_t(lat[1]), _t(ctx[3])))
    np.testing.assert_allclose(logged, totals, rtol=1e-4, atol=1e-6)
    assert logs_t["total"] == logged[-1]
    np.testing.assert_allclose(lat_t.numpy(), np.asarray(kept_j[0]), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(ctx_t.numpy(), np.asarray(kept_j[1]), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(sgd_t.mom_latent.numpy(), np.asarray(states[-1][2].mom_latent),
                               atol=1e-5, rtol=1e-4)
    # one iteration keeps the post-update state
    one = editor.optimize_iterations(step, 1, _t(lat), _t(ctx),
                                     optimization.init_sgd_state(_t(lat[1]), _t(ctx[3])))
    np.testing.assert_allclose(one[0].numpy(), np.asarray(states[1][0]), atol=1e-4, rtol=1e-4)


def test_edit_slice_matches_jax(sessions, scene):
    """One whole EditSession.run (the test_editor.py:70 schedule): loss logs
    of steps 0 and 2, final latents, reconstruction and edited image.

    lr=0: at step 0 the base and edit streams are equal, so the background
    and placement L1 losses sit at a zero residual and their gradient is the
    sign of rounding noise (the JAX run's two XLA programs round the base
    and edit UNet passes apart by ~1e-7; the port's eager passes agree
    exactly).  That sign, times lr_eff = 37.5, decides the whole trajectory,
    so the runs are compared with the update off; the update itself is held
    against JAX in test_step_functions_match on non-degenerate inputs."""
    js, ts = sessions
    image, depth, mask = scene
    transform = jcam.compose_transform(tx=0.05)
    decode = js._decode_bundle_fn()
    final = []   # the JAX run's final [base, edit] latents, as decoded
    js._decode_bundle = lambda p, lat, *a: (final.append(np.asarray(lat)), decode(p, lat, *a))[1]
    jr = js.run(image, depth, mask, transform, prompt="a thing")
    tr = ts.run(image, depth, mask, transform, prompt="a thing")
    assert set(tr.loss_log) == set(jr.loss_log) == {0, 2}
    for i in (0, 2):
        assert tr.loss_log[i]["num_layers"] == jr.loss_log[i]["num_layers"] > 0
        for key, val in jr.loss_log[i].items():
            # the removal term's argmax over bf16-rounded probabilities may
            # pick another column on a near-tie in a few rows
            tol = dict(rtol=1e-2, atol=1e-4) if key.endswith("removal") else dict(rtol=1e-4, atol=1e-6)
            np.testing.assert_allclose(tr.loss_log[i][key], val, err_msg=f"{i} {key}", **tol)
    # uint8 images: a float32 difference can cross a rounding boundary, and
    # the histogram-matching lookup can move a level by a few steps
    assert np.abs(tr.images.astype(int) - jr.images.astype(int)).max() <= 2
    assert np.abs(tr.edited_image.astype(int) - jr.edited_image.astype(int)).max() <= 4
    # the weight schedule followed the same logged losses
    assert set(tr.weight_log) == set(jr.weight_log)
    for i, w in jr.weight_log.items():
        assert tr.weight_log[i] == pytest.approx(w, rel=1e-6)
    # final latents: float32 UNet passes of the loop, compounded over 4 steps
    np.testing.assert_allclose(tr.latents.numpy(), final[0], atol=1e-4, rtol=1e-4)
