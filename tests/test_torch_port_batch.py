"""The lockstep multi-edit batch (`parallel/batch.py`) on the CPU:
ModelConfig.tiny(), float32, one torch thread.

A group's reference is the port's own sequential `EditSession.run` of
each of its edits (held against the JAX package by the edit, remover and
stitch files); the JAX package is compared only where it has a per-edit
counterpart: the removal correlation under `jax.vmap` (interpret mode) and
the per-edit step functions.  No JAX `ShardedEditSession` is built.

Tolerances against the sequential runs: a group's UNet and attention calls
run at batch E where the sequential run's run at batch 1, so float32 sums
are blocked differently (~1e-6 a call).  An optimize step turns such
differences into differences of its update: the L1 losses' gradient is the
sign of each residual, and residuals at rounding level take either sign
(the step-0 sign noise of tests/test_torch_port_edit.py), and the removal
loss's bf16 probabilities may pick another argmax row on a near-tie.  So
each whole-edit comparison runs twice: with the update off (lr = 0), where
the 4-step edits below stay within 2e-5 of a final latent (values up to
~6), 5e-5 of a loss log and 5 uint8 levels of an edited image (mean under
0.01), held elementwise; and with the update on, where they stay within a
relative RMS of 5e-3 (bound 5e-2), the step-0 logs
(before any update) and the adaptive weights agree as above, and the
images move by a few uint8 levels.  The update itself is held against the
JAX step functions per edit (test_batched_step_functions_match_jax_per_edit)
on inputs where base and edit streams differ.  The group starts from the
trajectories the sequential runs wrote to their experiment folders (the
inversion cache `run_batch` reads per folder): its own inversion, at batch
E, lies ~2e-6 away, which the first update amplifies; it is held against
the sequential inversion separately.
"""

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from geodiffuser_tpu.config import EditConfig as JEditConfig
from geodiffuser_tpu.core import optimization as jopt
from geodiffuser_tpu.core.editor import EditSession as JEditSession
from geodiffuser_tpu.kernels import removal_corr as jrc
from geodiffuser_tpu.ops import camera as jcam
from geodiffuser_tpu.parallel import sharding as jsharding
from geodiffuser_tpu_torch.config import EditConfig, ModelConfig
from geodiffuser_tpu_torch.core import edit_state, optimization
from geodiffuser_tpu_torch.core.editor import EditSession, stitch_composite
from geodiffuser_tpu_torch.core.pipeline import Pipeline
from geodiffuser_tpu_torch.kernels import removal_corr as rc
from geodiffuser_tpu_torch.models.weights import from_jax_params
from geodiffuser_tpu_torch.ops import camera
from geodiffuser_tpu_torch.parallel import driver, sharding
from geodiffuser_tpu_torch.parallel.batch import ShardedEditSession
from geodiffuser_tpu_torch.utils import exp_io, png
from test_torch_port_edit import tiny_pipeline
from test_torch_port_kernels import _removal_loss, _scene as _corr_scene

torch.set_num_threads(1)

SIZE = 64
STEPS = dict(num_ddim_steps=4)
# against the sequential runs (see the module docstring): final latents,
# loss logs and weights with the update off; the final latents' relative
# RMS with it on; the edited images' largest and mean uint8 difference
LATENT_TOL = dict(atol=1e-4, rtol=1e-4)
LOG_TOL = dict(atol=2e-4, rtol=1e-4)
LATENT_REL_RMS = 5e-2
IMAGE_LEVELS = {"off": (8, 0.05), "on": (24, 1.0)}
UPDATE = {"off": dict(lr=0.0), "on": {}}


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


@pytest.fixture(scope="module")
def pipe():
    return Pipeline.create(ModelConfig.tiny(), image_size=SIZE, device="cpu")


def _disk(cx, cy, r):
    yy, xx = np.mgrid[0:SIZE, 0:SIZE]
    return (((xx - cx) ** 2 + (yy - cy) ** 2) < r ** 2).astype(np.float32)


def _image(seed):
    return np.random.RandomState(seed).rand(SIZE, SIZE, 3).astype(np.float32)


DEPTH = np.full((SIZE, SIZE), 0.5, np.float32)


def _edits(edit_type, transforms, masks=None, seeds=(0, 1)):
    """(images, depths, masks, transforms) of a group; a stitch's inputs are
    its pre-composites run as identity edits, as perform_stitch runs them."""
    masks = masks or [_disk(25, 35, 12)] * len(transforms)
    images = [_image(s) for s in seeds]
    if edit_type == "geometry_stitch":
        cfg = EditConfig(edit_type=edit_type)
        out = [stitch_composite(cfg, _image(s + 10), im, m, DEPTH, tr, device="cpu")
               for s, im, m, tr in zip(seeds, images, masks, transforms)]
        return ([c for c, _ in out], [DEPTH] * len(out), [w for _, w in out],
                [np.eye(4)] * len(out))
    return images, [DEPTH] * len(images), masks, transforms


def _sequential(pipe, cfg, edits, folders):
    """Each edit run alone, its inversion written to its folder."""
    return [EditSession(pipe, cfg, device="cpu").run(*args, exp_folder=str(f))
            for args, f in zip(zip(*edits), folders)]


def _group(pipe, cfg, edits, **kw):
    return ShardedEditSession(pipe, cfg, device="cpu").run_batch(
        *(np.stack(x) for x in edits), **kw)


def _folders(tmp_path, n=2):
    out = [tmp_path / f"edit{e}" for e in range(n)]
    for f in out:
        f.mkdir()
    return [str(f) for f in out]


def _rel_rms(a, b):
    return float(torch.sqrt(((a - b) ** 2).mean() / (b ** 2).mean()))


def _assert_matches(group, seq, name, update="off"):
    for e, ref in enumerate(seq):
        if update == "off":
            np.testing.assert_allclose(group.latents[e].numpy(), ref.latents.numpy(),
                                       err_msg=f"{name} edit {e} latents", **LATENT_TOL)
        else:
            gap = _rel_rms(group.latents[e], ref.latents)
            assert gap <= LATENT_REL_RMS, (name, e, gap)
        loss_log, weight_log = group.edit_logs(e)
        assert sorted(loss_log) == sorted(ref.loss_log), name
        for i in ref.loss_log:
            assert set(loss_log[i]) == set(ref.loss_log[i])
            for key, val in ref.loss_log[i].items():
                if update == "off" or i == min(ref.loss_log):
                    np.testing.assert_allclose(loss_log[i][key], val,
                                               err_msg=f"{name} {e} {i} {key}", **LOG_TOL)
            for key, val in ref.weight_log[i].items():
                np.testing.assert_allclose(weight_log[i][key], val, err_msg=f"{name} {e} {i} {key}",
                                           **LOG_TOL)
        diff = np.abs(group.edited_images[e].astype(int) - ref.edited_image.astype(int))
        most, mean = IMAGE_LEVELS[update]
        assert diff.max() <= most and diff.mean() <= mean, (name, e, diff.max(), diff.mean())


# moves that keep the object in the 64^2 frame at depth 0.5
TRANSFORMS = [camera.compose_transform(tx=0.01), camera.compose_transform(tx=-0.01, ry=5.0)]


@pytest.mark.parametrize("update", ["off", "on"])
@pytest.mark.parametrize("edit_type", ["geometry_editor", "geometry_remover", "geometry_stitch"])
def test_group_equals_sequential_runs(pipe, edit_type, update, tmp_path):
    """(a) An E = 2 group of each type against the sequential run of each
    edit: final latents, loss logs and adaptive weights.  The editor's two
    edits move the object differently, the remover's remove it from two
    photos, the stitch pastes it with two transforms; the stitch's weights
    follow its own rule (the background-similarity weight moves, the
    removal weight stays), as its sequential run's do.  With the update
    off and on (see the module docstring)."""
    cfg = EditConfig(edit_type=edit_type, **STEPS, **UPDATE[update])
    transforms = [np.eye(4)] * 2 if edit_type == "geometry_remover" else TRANSFORMS
    edits = _edits(edit_type, transforms)
    folders = _folders(tmp_path)
    seq = _sequential(pipe, cfg, edits, folders)
    group = _group(pipe, cfg, edits, exp_folders=folders)
    assert group.images.shape == (2, 2, SIZE, SIZE, 3) and len(group.edited_images) == 2
    _assert_matches(group, seq, edit_type, update)
    if edit_type == "geometry_stitch":
        defaults = cfg.resolved_loss_weights()
        for e in range(2):
            loss_log, weight_log = group.edit_logs(e)
            w = {b: dict(t) for b, t in defaults.items()}
            for i in sorted(loss_log):
                w = optimization.adaptive_step_stitching(
                    w, defaults, i, cfg.skip_optim_steps, cfg.num_ddim_steps,
                    loss_log[i]["self/sim"])
                assert weight_log[i]["self/sim"] == pytest.approx(w["self"]["sim"], rel=1e-6)
                assert weight_log[i]["self/removal"] == defaults["self"]["removal"]
            assert weight_log[0]["self/sim"] != defaults["self"]["sim"]


def test_group_of_one_is_the_sequential_run(pipe, tmp_path):
    """`run` and `run_batch` share one denoising loop: a group of one edit,
    from the inversion its sequential run wrote, equals that run bit for
    bit (final latents, loss logs, adaptive weights, edited image)."""
    cfg = EditConfig(**STEPS)
    edits = _edits("geometry_editor", TRANSFORMS[:1], seeds=(0,))
    folders = _folders(tmp_path, 1)
    seq = _sequential(pipe, cfg, edits, folders)[0]
    group = _group(pipe, cfg, edits, exp_folders=folders)
    assert torch.equal(group.latents[0], seq.latents)
    assert group.edit_logs(0) == (seq.loss_log, seq.weight_log)
    np.testing.assert_array_equal(group.edited_images[0], seq.edited_image)


def test_edits_of_a_group_are_independent(pipe):
    """(b) Changing edit 1's transform leaves edit 0's results unchanged,
    bit for bit: each edit's streams see only its own masks, rows, taps and
    weights."""
    cfg = EditConfig(**STEPS, cache_inversion=False)
    a = _group(pipe, cfg, _edits("geometry_editor", TRANSFORMS))
    b = _group(pipe, cfg, _edits("geometry_editor",
                                 [TRANSFORMS[0], camera.compose_transform(ty=0.01, ry=-5.0)]))
    assert torch.equal(a.latents[0], b.latents[0])
    assert not torch.equal(a.latents[1], b.latents[1])
    assert a.edit_logs(0) == b.edit_logs(0)
    np.testing.assert_array_equal(a.edited_images[0], b.edited_images[0])


@pytest.mark.parametrize("update", ["off", "on"])
def test_group_mixing_an_overflowing_warped_mask(pipe, update, tmp_path):
    """(c) Edit 0's object covers over a quarter of the picture, so its
    warped mask overflows the no-loss blend's row budget and the group runs
    the full-row blend; edit 1 fits the budget, and its sequential run takes
    the budgeted blend on the CFG step before the obj-edit step.  Both equal
    their sequential runs, with the update off and on."""
    cfg = EditConfig(**STEPS, **UPDATE[update])
    edits = _edits("geometry_editor", TRANSFORMS, masks=[_disk(32, 32, 22), _disk(25, 35, 12)])
    assert all(m.sum() > 0 for m in edits[2])
    sess = ShardedEditSession(pipe, cfg, device="cpu")
    args = [(_t(im), _t(d), _t(m), _t(tr)) for im, d, m, tr in zip(*edits)]
    alone = [sess._full_blend(sess._preprocess(*a)[1]) for a in args]
    assert alone == [True, False]
    assert sess._full_blend(sess.preprocess_batch(*(torch.stack(x) for x in zip(*args)))[1])
    folders = _folders(tmp_path)
    seq = _sequential(pipe, cfg, edits, folders)
    _assert_matches(_group(pipe, cfg, edits, exp_folders=folders), seq, "mixed overflow",
                    update)


def test_group_inversion_and_its_cache(pipe, tmp_path, monkeypatch):
    """The group's own inversion (one call for the group; a prompt equal to
    the unconditional text inverts without guidance, as `run` inverts it)
    against each edit's sequential inversion, each trajectory written to
    its folder; a second group reads every folder and inverts nothing; with
    one folder's cache missing the whole group is inverted again (all or
    nothing)."""
    from geodiffuser_tpu_torch.core import inversion

    cfg = EditConfig(**STEPS)
    edits = _edits("geometry_editor", TRANSFORMS)
    prompts = ["", "a photo"]
    calls = []
    invert = inversion.ddim_invert
    monkeypatch.setattr(inversion, "ddim_invert", lambda p, lat, *a, **kw: (
        calls.append((lat.shape[0], kw.get("cfg_free"))), invert(p, lat, *a, **kw))[1])
    folders = _folders(tmp_path)
    sess = ShardedEditSession(pipe, cfg, device="cpu")
    _group(pipe, cfg, edits, prompts=prompts, exp_folders=folders)
    assert sorted(calls) == [(1, False), (1, True)]
    for e, folder in enumerate(folders):
        image = edits[0][e]
        key = sess.inversion_key(np.asarray(image, np.float32), prompts[e])
        cached = exp_io.load_inversion(folder, key)
        latent0 = pipe.encode_image(_t(image))
        ctx_u, ctx_c = pipe.encode_text([cfg.uncond_text]), pipe.encode_text([prompts[e]])
        ref, _ = invert(pipe, latent0, ctx_u, ctx_c, guidance_scale=cfg.guidance_scale,
                        num_steps=cfg.num_ddim_steps, cfg_free=prompts[e] == cfg.uncond_text)
        assert cached.shape == tuple(ref.shape)
        np.testing.assert_allclose(cached, ref.numpy(), atol=1e-5, rtol=1e-5)
    calls.clear()
    _group(pipe, cfg, edits, prompts=prompts, exp_folders=folders)
    assert calls == []
    os.remove(os.path.join(folders[1], exp_io.INVERSION_CACHE_FILE))
    _group(pipe, cfg, edits, prompts=["a photo"] * 2, exp_folders=folders)
    assert calls == [(2, False)]


def _vmapped_corr_case(lk):
    """Two edits of two heads each, with their own masks and live rows."""
    rng = np.random.RandomState(7)
    cases = [_corr_scene(rng, 2, 32, 128, lk, 24) for _ in range(2)]
    row_mask = np.stack([(np.arange(32) < n).astype(np.float32) for n in (20, 27)])
    dist_w = rng.rand(2, 2, 32).astype(np.float32)
    stack = lambda i: np.stack([c[i] for c in cases])
    return [stack(i) for i in range(6)], row_mask, dist_w


@pytest.mark.parametrize("lk", [128, 77])
def test_batched_plain_correlation_matches_vmapped_jax(lk):
    """(d) The plain correlation forward and backward over a group (heads
    E x 2, masks (E, L) and (E, K)) against the JAX package's
    `removal_correlation(impl="pallas", interpret=True)` under `jax.vmap`
    over the edit axis (what the JAX batch runs), at the tolerances of
    test_torch_port_kernels.py's single-edit comparison (the gradients over
    the rows whose argmax both pick); and against one plain call per
    edit."""
    (qe, ke, qb, kb, inp, bg), row_mask, dist_w = _vmapped_corr_case(lk)
    scale = 24 ** -0.5

    def jloss(qe_, ke_, w):
        corr = lambda *a: jrc.removal_correlation(*a, scale, "pallas", True)
        out = jax.vmap(corr)(qe_, ke_, jnp.asarray(qb), jnp.asarray(kb), jnp.asarray(inp),
                             jnp.asarray(bg), jnp.asarray(row_mask))
        loss = sum(_removal_loss(out[0][e], out[1][e], w[e], row_mask[e], jnp.log,
                                 lambda x: jnp.maximum(x, 0.0), jnp.asarray) for e in range(2))
        return loss, out

    flat = lambda x: _t(x.reshape(4, *x.shape[2:]))
    qt, kt = flat(qe).requires_grad_(True), flat(ke).requires_grad_(True)
    got = rc.removal_correlation(qt, kt, flat(qb), flat(kb), _t(inp), _t(bg), _t(row_mask), scale)
    grad_fn = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))
    (_, out_ref), _ = grad_fn(jnp.asarray(qe), jnp.asarray(ke), dist_w)
    # a row whose argmax differs between the Pallas kernel and the port (a
    # near-tie of bf16-rounded sums) carries no loss on either side, so
    # that the gradients compare the same rows
    same = np.ones((2, 2, 32), bool)
    for g, r in zip(got[2:], out_ref[2:]):
        same &= g.reshape(2, 2, 32).numpy() == np.asarray(r)
    assert same[row_mask[:, None, :].repeat(2, 1) > 0.5].mean() >= 0.97
    w_same = (dist_w * same).astype(np.float32)
    (v_ref, _), g_ref = grad_fn(jnp.asarray(qe), jnp.asarray(ke), w_same)
    p_in, p_bg = (x.reshape(2, 2, 32) for x in got[:2])
    v = sum(_removal_loss(p_in[e], p_bg[e], w_same[e], row_mask[e], torch.log,
                          lambda x: torch.clamp(x, min=0.0), _t) for e in range(2))
    v.backward()
    np.testing.assert_allclose(v.item(), float(v_ref), rtol=2e-2)
    for e, live in enumerate((20, 27)):
        for g, r in zip(got[:2], out_ref[:2]):
            np.testing.assert_allclose(g.detach().reshape(2, 2, 32)[e, :, :live].numpy(),
                                       np.asarray(r)[e, :, :live], atol=2e-3, rtol=2e-3)
            assert np.all(g.detach().reshape(2, 2, 32)[e, :, live:].numpy() == rc.NEG_INF)
        for g, r in zip(got[2:], out_ref[2:]):
            agree = (g.reshape(2, 2, 32)[e, :, :live].numpy() == np.asarray(r)[e, :, :live]).mean()
            assert agree >= 0.97, agree
    for g, r, name in zip((qt.grad, kt.grad), g_ref, ("dqe", "dke")):
        np.testing.assert_allclose(g.reshape(r.shape).numpy(), np.asarray(r), err_msg=name,
                                   atol=3e-3, rtol=3e-2)
    # the group's call against one call per edit with its (L,) and (K,) masks
    for e in range(2):
        one = rc.removal_correlation(_t(qe[e]), _t(ke[e]), _t(qb[e]), _t(kb[e]), _t(inp[e]),
                                     _t(bg[e]), _t(row_mask[e]), scale)
        for g, o in zip(got, one):
            np.testing.assert_allclose(g.detach().reshape(2, 2, 32)[e].numpy(), o.numpy(),
                                       rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="edits"):
        rc.corr_fwd_plain(flat(qe)[:3], flat(ke)[:3], flat(qb)[:3], flat(kb)[:3], _t(inp),
                          _t(bg), _t(row_mask), scale)


@pytest.fixture(scope="module")
def step_sessions():
    """The JAX and port sessions of the step test at 128^2, with the JAX
    tiny pipeline of test_torch_port_edit.py and its weights carried over."""
    jp, params = tiny_pipeline(128)
    tp = Pipeline.create(ModelConfig.tiny(), image_size=128, device="cpu")
    tp.load_state_dicts(from_jax_params(params, ModelConfig.tiny()))
    edit = dict(num_ddim_steps=4, optimize_steps=0.65, skip_optim_steps=2, latent_replace=0.3,
                lr=0.0)
    return jp, JEditSession(jp, JEditConfig(**edit)), EditSession(tp, EditConfig(**edit),
                                                                   device="cpu")


def test_batched_step_functions_match_jax_per_edit(step_sessions):
    """(e) The port's optimize step and slim CFG step on an E = 2 group
    (two transforms, latents where base and edit streams differ, the
    group's own weights) against the JAX `_optimize_step` and `_cfg_step`,
    jitted, called on each edit; tolerances of test_torch_port_edit.py's
    single-edit step test."""
    jp, js, ts = step_sessions
    rng = np.random.RandomState(2)
    image = rng.rand(128, 128, 3).astype(np.float32)
    yy, xx = np.mgrid[0:128, 0:128]
    mask = (((xx - 50) ** 2 + (yy - 70) ** 2) < 25 ** 2).astype(np.float32)
    depth = np.full((128, 128), 0.5, np.float32)
    transforms = [jcam.compose_transform(tx=0.05), jcam.compose_transform(tx=-0.02, ry=5.0)]
    lat = rng.randn(2, 2, 16, 16, 4).astype(np.float32)
    ctx = rng.randn(2, 4, 77, 32).astype(np.float32)
    pinned = rng.randn(2, 1, 16, 16, 4).astype(np.float32)
    w = [{b: dict(t) for b, t in JEditConfig().resolved_loss_weights().items()}
         for _ in range(2)]
    w[1]["self"]["removal"] *= 1.3
    lr = np.float32(1.5)
    masks_t, ref = [], []
    for e, transform in enumerate(transforms):
        _, mj = js._preprocess(jnp.asarray(image), jnp.asarray(depth), jnp.asarray(mask),
                               jnp.asarray(transform, jnp.float32))
        masks_t.append(ts._preprocess(_t(image), _t(depth), _t(mask), _t(transform))[1])
        wa = {b: {k: np.float32(v) for k, v in t.items()} for b, t in w[e].items()}
        wmj = js._warp_mats(mj, np.float32(1.0), np.float32(0.8))
        oj = js._optimize_step(jp.params["unet"], jnp.asarray(lat[e]), jnp.asarray(ctx[e]),
                               np.int32(750), mj, np.int32(0), wa, np.float32(1.0),
                               np.float32(0.8), lr,
                               jopt.init_sgd_state(jnp.asarray(lat[e, 1]), jnp.asarray(ctx[e, 3])),
                               wmj, self_window=True, past_obj=False)
        cj = js._cfg_step(jp.params["unet"], oj[0], oj[1], np.int32(500), mj, np.int32(1), wa,
                          np.float32(1.0), np.float32(0.8), jnp.asarray(pinned[e]),
                          np.bool_(True), wmj, self_window=True, past_obj=False,
                          full_blend=False)
        ref.append((oj, cj))
    assert all(m[16].mask_new_warped.sum() > 0 for m in masks_t)
    masks = edit_state.stack_mask_sets(masks_t)
    wm = edit_state.build_warp_matrices(masks, 1.0, 0.8, 20.0)
    wt = {b: {k: torch.tensor([w[0][b][k], w[1][b][k]]) for k in t} for b, t in w[0].items()}
    ot = ts._optimize_step(_t(lat), _t(ctx), 750, masks, 0, wt, 1.0, 0.8, float(lr),
                           optimization.init_sgd_state(_t(lat[:, 1]), _t(ctx[:, 3])), wm,
                           True, False)
    ct = ts._cfg_step(ot[0], ot[1], 500, masks, 1, wt, 1.0, 0.8, _t(pinned), True, wm, True,
                      False, False)
    for e, (oj, cj) in enumerate(ref):
        np.testing.assert_allclose(ot[0][e].numpy(), np.asarray(oj[0]), atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(ot[1][e].numpy(), np.asarray(oj[1]), atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(ot[2].mom_latent[e].numpy(), np.asarray(oj[2].mom_latent),
                                   atol=1e-5, rtol=1e-4)
        log_j = np.asarray(oj[3])
        keys = sorted(ot[3][e])
        assert keys == sorted(ot[3][1 - e])
        assert ot[3][e]["total"] == pytest.approx(float(log_j[0]), rel=1e-4)
        np.testing.assert_allclose(ct[e].numpy(), np.asarray(cj), atol=1e-4, rtol=1e-4)


def test_driver_group_sweep_equals_the_sequential_sweep(pipe, tmp_path, monkeypatch):
    """(f) `run_folder_sweep(group_size=2)` over two editor folders and a
    remover folder (a group of two, then a group of one padded by its own
    edit) writes what the sequential sweep writes, within the group
    tolerances with the update off (from the sequential sweep's cached
    inversions), and writes each real folder's results once: none for the
    pad."""
    root = tmp_path / "seq"
    for name, transform in (("Translation_3D/0", TRANSFORMS[0]),
                            ("Translation_3D/1", TRANSFORMS[1]), ("Removal/0", np.eye(4))):
        exp_io.save_exp(str(root / name), (_image(len(name)) * 255).astype(np.uint8), DEPTH,
                        _disk(25, 35, 12), transform, image_shape=(SIZE, SIZE))
    steps = dict(num_ddim_steps=4, **UPDATE["off"])
    seq = driver.run_folder_sweep(str(root), pipe=pipe, config_overrides=steps,
                                  use_native=False, device="cpu")
    # the group starts from the trajectories the sequential sweep cached
    shutil.copytree(root, tmp_path / "group")
    saved = []
    save = exp_io.save_results
    monkeypatch.setattr(exp_io, "save_results", lambda exp, *a: (saved.append(exp.path),
                                                                 save(exp, *a))[1])
    grouped = driver.run_folder_sweep(str(tmp_path / "group"), pipe=pipe, group_size=2,
                                      config_overrides=steps, use_native=False,
                                      skip_existing=False, device="cpu")
    assert sorted(os.path.relpath(f, tmp_path / "group") for f in grouped) == \
        sorted(os.path.relpath(f, root) for f in seq)
    assert sorted(saved) == sorted(grouped)
    for folder in seq:
        rel = os.path.relpath(folder, root)
        a = png.read_png(os.path.join(folder, "result_ls.png")).astype(int)
        b = png.read_png(str(tmp_path / "group" / rel / "result_ls.png")).astype(int)
        most, mean = IMAGE_LEVELS["off"]
        assert np.abs(a - b).max() <= most and np.abs(a - b).mean() <= mean
        logs = [json.load(open(os.path.join(r, rel, "loss_log.json")))
                for r in (root, tmp_path / "group")]
        assert logs[0].keys() == logs[1].keys()
        for i in logs[0]:
            for key, val in logs[0][i].items():
                np.testing.assert_allclose(logs[1][i][key], val, err_msg=f"{rel} {i} {key}",
                                           **LOG_TOL)


@pytest.mark.parametrize("image_size", [128, 256, 512, 1024])
def test_per_chip_packing_matches_jax(image_size):
    """(g) The packing table against the JAX package's on the same inputs;
    a CPU device has no card memory."""
    for gib in (None, 4.0, 8.0, 13.9, 14.0, 16.0, 79.6):
        assert sharding.per_chip_packing(gib, image_size) == \
            jsharding.per_chip_packing(gib, image_size)
    assert sharding.device_hbm_gib("cpu") is None
    assert sharding.auto_group_size(image_size) == 0


@pytest.mark.parametrize("option", [dict(perform_inversion=True), dict(fast_start_steps=0.25)])
def test_run_batch_refuses_what_it_would_change(pipe, option):
    """(h) Null-text inversion and the fast start are refused: the JAX
    batch ignores the one and skips the other's inner loop."""
    sess = ShardedEditSession(pipe, EditConfig(**option), device="cpu")
    with pytest.raises(ValueError, match="one at a time"):
        sess.run_batch(*(np.stack(x) for x in _edits("geometry_editor", TRANSFORMS)))


def test_mask_sets_stack_per_edit(pipe):
    """Stacked mask sets keep every field of each edit, and the warp
    operators of a group are each edit's own."""
    sess = EditSession(pipe, EditConfig(), device="cpu")
    sets = [sess._preprocess(_t(_image(0)), _t(DEPTH), _t(_disk(25, 35, 12)), _t(tr))[1]
            for tr in TRANSFORMS]
    group = edit_state.stack_mask_sets(sets)
    assert edit_state.is_batched(group) and not edit_state.is_batched(sets[0])
    assert edit_state.as_batched(group) is group
    for res, ms in group.items():
        for f in dataclasses.fields(edit_state.MaskSet):
            for e in range(2):
                one = getattr(sets[e][res], f.name)
                assert (one is None) == (getattr(ms, f.name) is None)
                if one is not None:
                    assert torch.equal(getattr(ms, f.name)[e], one), (res, f.name)
    ops = edit_state.build_warp_matrices(group, 1.0, 0.8, 20.0)
    for e in range(2):
        for res, op in edit_state.build_warp_matrices(sets[e], 1.0, 0.8, 20.0).items():
            assert torch.equal(ops[res][e], op)
