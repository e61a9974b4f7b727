"""Each cell at a tiny size on the CPU, through the whole harness: a sound
run is correct; the control (the reference in fp8) fails the cell's limits;
and with the timed path broken underneath, `correct` comes out false, once
for each fault the cell can have.  The cells run on one chip, so no
exchange between chips can be left out."""

import functools

import pytest
import torch

from portbench import compare, readings, run

import tiny

SEED = 2 ** 31 + 99
EDIT_CELLS = ["sd14-editor-e8", "sd14-remover-e8"]
CELLS = EDIT_CELLS + ["sd21-dift"]


def run_tiny(name):
    w, c, t = tiny.cell(name)
    return run.run_cell(w, c, t, SEED, 0.0, False, "cpu", run.benchmark())


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    res = run_tiny(name)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    assert res["attempted"] >= 1 and res["failed"] == 0


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_the_limits(name):
    w, c, t = tiny.cell(name)
    got = readings.readings(name, SEED, 0.0, "cpu", c, t)
    lims = compare.limits(name)
    assert compare.judge(got["program"], lims)[0]
    assert not compare.judge(got["control"], lims)[0]


# --------------------------------------------------------------- faults

def _cfg_step_unchanged(monkeypatch):
    from geodiffuser_tpu_torch.core.editor import EditSession

    @functools.wraps(EditSession._cfg_step)
    def unchanged(self, latents2, *args, **kwargs):
        return latents2

    monkeypatch.setattr(EditSession, "_cfg_step", unchanged)


def _optimize_step_unchanged(monkeypatch):
    from geodiffuser_tpu_torch.core.editor import EditSession

    real = EditSession._optimize_step

    @functools.wraps(real)
    def unchanged(self, latents2, context4, *args, **kwargs):
        out = real(self, latents2, context4, *args, **kwargs)
        return (latents2, context4, *out[2:])

    monkeypatch.setattr(EditSession, "_optimize_step", unchanged)


def _attention_dq_dropped(monkeypatch):
    from geodiffuser_tpu_torch.core import edit_attention

    real = edit_attention.fast_attention

    def no_dq(q, k, v, scale):
        return real(q.detach(), k, v, scale)

    monkeypatch.setattr(edit_attention, "fast_attention", no_dq)


def _inversion_unchanged(monkeypatch):
    from geodiffuser_tpu_torch.core import inversion

    real = inversion.ddim_invert

    @functools.wraps(real)
    def stuck(pipeline, latent, *a, **k):
        lats, noise = real(pipeline, latent, *a, **k)
        return latent.float()[None].expand_as(lats).clone(), noise

    monkeypatch.setattr(inversion, "ddim_invert", stuck)


def _half_the_group(monkeypatch):
    from geodiffuser_tpu_torch.models.unet import UNet2DCondition

    real = UNet2DCondition.forward

    def half(self, sample, *a, **k):
        eps = real(self, sample, *a, **k)
        n = eps.shape[0] // 2
        if n == 0:
            return eps
        keep = eps[:n]
        return torch.cat([keep, keep.mean(0, keepdim=True).expand(eps.shape[0] - n, *eps.shape[1:])])

    monkeypatch.setattr(UNet2DCondition, "forward", half)


def _decode_altered(monkeypatch):
    from geodiffuser_tpu_torch.core.pipeline import Pipeline

    real = Pipeline.decode_latents

    def altered(self, latents):
        images = real(self, latents)
        images[0] = 255 - images[0]
        return images

    monkeypatch.setattr(Pipeline, "decode_latents", altered)


EDIT_FAULTS = {"cfg step returns its state unchanged": _cfg_step_unchanged,
               "optimize step returns its latents and embeddings unchanged":
                   _optimize_step_unchanged,
               "attention's backward leaves out the queries' gradient": _attention_dq_dropped,
               "inversion step returns its state unchanged": _inversion_unchanged,
               "half the group left out, the rest's mean in its place": _half_the_group,
               "decoded image altered": _decode_altered}


@pytest.mark.parametrize("fault", list(EDIT_FAULTS))
@pytest.mark.parametrize("name", EDIT_CELLS)
def test_an_edit_fault_fails(monkeypatch, name, fault):
    EDIT_FAULTS[fault](monkeypatch)
    assert not run_tiny(name)["correct"]


def _features_unchanged(monkeypatch):
    from geodiffuser_tpu_torch.evaluation.dift import SDFeaturizer

    # the latent is never noised: the step that noises it returns it as it was
    real = SDFeaturizer.features
    monkeypatch.setattr(SDFeaturizer, "features",
                        lambda self, latent, ctx, noise, t: real(self, latent, ctx, 0 * noise, t))


def _half_the_ensemble(monkeypatch):
    from geodiffuser_tpu_torch.evaluation.dift import SDFeaturizer

    real = SDFeaturizer.draw_noises

    def half(self, shape, generator):
        noises = real(self, shape, generator)
        n = max(1, len(noises) // 2)
        return (noises[:n] * len(noises))[:len(noises)]

    monkeypatch.setattr(SDFeaturizer, "draw_noises", half)


def _features_altered(monkeypatch):
    from geodiffuser_tpu_torch.evaluation.dift import SDFeaturizer

    real = SDFeaturizer.features
    monkeypatch.setattr(SDFeaturizer, "features", lambda self, *a: -real(self, *a))


DIFT_FAULTS = {"noising step returns the latent unchanged": _features_unchanged,
               "half the ensemble left out, the rest's mean in its place": _half_the_ensemble,
               "features altered": _features_altered}


@pytest.mark.parametrize("fault", list(DIFT_FAULTS))
def test_a_dift_fault_fails(monkeypatch, fault):
    DIFT_FAULTS[fault](monkeypatch)
    assert not run_tiny("sd21-dift")["correct"]
