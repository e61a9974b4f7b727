"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain versions; the JAX kernels run
in interpret mode, as tests/test_flash_attention.py and
tests/test_removal_corr.py run them.  Inputs are made with numpy from a
seed and fed to both.  The CUDA kernels themselves are held against these
plain versions on the card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from geodiffuser_tpu.kernels import flash_attention as jfa
from geodiffuser_tpu.kernels import removal_corr as jrc
from geodiffuser_tpu_torch.kernels import flash_attention as fa
from geodiffuser_tpu_torch.kernels import removal_corr as rc

torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


# float32 on both sides: the two differ only in summation order
FLASH_TOL = dict(atol=2e-5, rtol=1e-4)
GRAD_TOL = dict(atol=5e-4, rtol=1e-3)


@pytest.mark.parametrize("b,h,lq,lk,d", [(1, 2, 256, 256, 40), (1, 2, 256, 512, 80)])
def test_flash_forward_matches_pallas(b, h, lq, lk, d):
    rng = np.random.RandomState(0)
    q, k, v = (rng.randn(b, h, n, d).astype(np.float32) for n in (lq, lk, lk))
    scale = d ** -0.5
    # jitted: interpret-mode Pallas dispatched op by op is several times slower
    ref, (_, lse_ref) = jax.jit(lambda q_, k_, v_: (
        jfa.flash_attention(q_, k_, v_, scale, block_q=256, block_k=256, interpret=True),
        # the forward's saved LSE (natural log) as the Pallas kernel emits it
        jfa._flash_fwd_impl(q_, k_, v_, scale, 256, 256, True)))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    out = fa.flash_attention(_t(q), _t(k), _t(v), scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **FLASH_TOL)
    flat = lambda x: _t(x).reshape(b * h, -1, d)
    _, lse = fa.flash_fwd_plain(flat(q), flat(k), flat(v), scale)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref)[..., 0], atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("lq,lk,d", [(256, 256, 40), (256, 512, 80)])
def test_flash_backward_matches_pallas(lq, lk, d):
    """Gradients through the port's wrapper (autograd of the plain version)
    and its plain backward formula against the Pallas backward."""
    rng = np.random.RandomState(2)
    b, h = 1, 2
    q, k, v = (rng.randn(b, h, n, d).astype(np.float32) for n in (lq, lk, lk))
    co = rng.randn(b, h, lq, d).astype(np.float32)
    scale = d ** -0.5

    def loss_flash(q_, k_, v_):
        return jnp.sum(jfa.flash_attention(q_, k_, v_, scale, 256, 256, True) * co)

    g_ref = jax.jit(jax.grad(loss_flash, argnums=(0, 1, 2)))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    qt, kt, vt = (_t(x).requires_grad_(True) for x in (q, k, v))
    (fa.flash_attention(qt, kt, vt, scale) * _t(co)).sum().backward()
    for got, ref, name in zip((qt.grad, kt.grad, vt.grad), g_ref, "qkv"):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), err_msg=name, **GRAD_TOL)

    flat = lambda x: _t(x).reshape(b * h, -1, d)
    o, lse = fa.flash_fwd_plain(flat(q), flat(k), flat(v), scale)
    got = fa.flash_bwd_plain(flat(q), flat(k), flat(v), o, lse, flat(co), scale)
    for g, ref, name in zip(got, g_ref, "qkv"):
        np.testing.assert_allclose(g.reshape(ref.shape).numpy(), np.asarray(ref), err_msg=name,
                                   **GRAD_TOL)


def _scene(rng, h, k_rows, l, lk, d):
    qe, ke, qb, kb = (rng.randn(h, n, d).astype(np.float32) for n in (k_rows, lk, l, lk))
    inpaint = (rng.rand(l) < 0.2).astype(np.float32)
    inpaint[:4] = 1.0
    background = ((rng.rand(l) < 0.5) & (inpaint < 0.5)).astype(np.float32)
    background[-4:] = 1.0
    return qe, ke, qb, kb, inpaint, background


# Probabilities are rounded to bf16 before the product on both sides; the
# two softmax formulations may round a probability to neighbouring bf16
# values, so maxima agree to a few bf16 steps of a sum, not to float32.
CORR_TOL = dict(atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("lk", [256, 77])
def test_corr_forward_matches_pallas(lk):
    """Live rows match the Pallas kernel; rows of dead blocks return the
    NEG_INF / index-0 sentinel on both; argmax indices agree."""
    rng = np.random.RandomState(3)
    h, k_rows, l, d = 2, 512, 256, 40
    qe, ke, qb, kb, inp, bg = _scene(rng, h, k_rows, l, lk, d)
    live = 100
    row_mask = (np.arange(k_rows) < live).astype(np.float32)
    scale = d ** -0.5
    ref = jrc._corr_pallas(*(jnp.asarray(x) for x in (qe, ke, qb, kb, inp, bg, row_mask)),
                           scale, interpret=True)
    got = rc.removal_correlation(*(_t(x) for x in (qe, ke, qb, kb, inp, bg, row_mask)), scale)
    for g, r, name in zip(got[:2], ref[:2], ("p_in", "p_bg")):
        np.testing.assert_allclose(g.numpy()[:, :live], np.asarray(r)[:, :live],
                                   err_msg=name, **CORR_TOL)
        # rows 256.. lie in fully dead 256-row Pallas blocks
        assert np.all(g.numpy()[:, live:] == rc.NEG_INF)
        assert np.all(np.asarray(r)[:, 256:] <= jrc.NEG_INF * 0.5)
    for g, r in zip(got[2:], ref[2:]):
        agree = (g.numpy()[:, :live] == np.asarray(r)[:, :live]).mean()
        assert agree >= 0.97, agree      # near-ties under bf16 rounding may differ
        assert np.all(g.numpy()[:, live:] == 0)


def test_corr_forward_matches_xla_exactly_on_dead_rows_and_ties():
    """Against the JAX XLA path: the per-row dead sentinel, and ties, which
    must resolve to the lowest index: every background base row is made
    identical, so every live row's background maximum is a tie."""
    rng = np.random.RandomState(4)
    h, k_rows, l, lk, d = 2, 16, 64, 64, 16
    qe, ke, qb, kb, inp, bg = _scene(rng, h, k_rows, l, lk, d)
    bg_rows = np.flatnonzero(bg > 0.5)
    qb[:, bg_rows] = qb[:, bg_rows[:1]]
    row_mask = np.ones(k_rows, np.float32)
    row_mask[[3, 7]] = 0.0
    scale = d ** -0.5
    p_in, p_bg, j_in, j_bg = jrc._corr_xla(*(jnp.asarray(x) for x in (qe, ke, qb, kb, inp, bg)),
                                           scale)
    got = rc.removal_correlation(*(_t(x) for x in (qe, ke, qb, kb, inp, bg, row_mask)), scale)
    live = row_mask > 0.5
    assert np.all(np.asarray(j_bg) == bg_rows[0])
    assert np.all(got[3].numpy()[:, live] == bg_rows[0])
    for g, r in zip(got, (p_in, p_bg, j_in, j_bg)):
        g, r = g.numpy(), np.asarray(r)
        assert np.all(g[:, ~live] == (0 if g.dtype.kind == "i" else rc.NEG_INF))
        # float32 sums of identical bf16 probabilities, in another order
        np.testing.assert_allclose(g[:, live], r[:, live], atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("lk", [128, 77])
def test_corr_gradients_match_jax(lk):
    """d/dqe and d/dke of a removal-style loss through the port's autograd
    Function against removal_correlation(impl="pallas", interpret=True) with
    the JAX package's own Pallas-vs-XLA tolerances (the Pallas kernel rounds
    unnormalized exponentials to bf16, the XLA path and the port normalized
    probabilities), and against impl="xla" at float32 tolerance."""
    rng = np.random.RandomState(5)
    h, k_rows, l, d = 2, 32, 128, 24
    qe, ke, qb, kb, inp, bg = _scene(rng, h, k_rows, l, lk, d)
    row_mask = (np.arange(k_rows) < 20).astype(np.float32)
    dist_w = rng.rand(h, k_rows).astype(np.float32)
    scale = d ** -0.5

    def loss(p_in, p_bg, log, clamp, arr):
        per = arr(dist_w) * (-log(clamp(p_bg) + 1e-4) + log(clamp(p_in) + 1e-4))
        return (per * arr(row_mask)[None]).sum()

    def jloss(qe_, ke_, impl):
        p_in, p_bg, _, _ = jrc.removal_correlation(
            qe_, ke_, jnp.asarray(qb), jnp.asarray(kb), jnp.asarray(inp), jnp.asarray(bg),
            jnp.asarray(row_mask), scale, impl, True)
        return loss(p_in, p_bg, jnp.log, lambda x: jnp.maximum(x, 0.0), jnp.asarray)

    qt, kt = _t(qe).requires_grad_(True), _t(ke).requires_grad_(True)
    p_in, p_bg, _, _ = rc.removal_correlation(
        qt, kt, _t(qb), _t(kb), _t(inp), _t(bg), _t(row_mask), scale)
    v = loss(p_in, p_bg, torch.log, lambda x: torch.clamp(x, min=0.0), _t)
    v.backward()
    for impl, v_tol, g_tol in (("pallas", dict(rtol=2e-2), dict(atol=3e-3, rtol=3e-2)),
                               ("xla", dict(rtol=1e-5), dict(atol=1e-5, rtol=1e-4))):
        v_ref, g_ref = jax.jit(jax.value_and_grad(lambda a, b: jloss(a, b, impl), argnums=(0, 1)))(
            jnp.asarray(qe), jnp.asarray(ke))
        np.testing.assert_allclose(v.item(), float(v_ref), err_msg=impl, **v_tol)
        for g, r, name in zip((qt.grad, kt.grad), g_ref, ("dqe", "dke")):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), err_msg=f"{impl} {name}", **g_tol)
