"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain versions; the JAX kernels run
in interpret mode, as tests/test_flash_attention.py and
tests/test_removal_corr.py run them.  Inputs are made with numpy from a
seed and fed to both.  The CUDA kernels themselves are held against these
plain versions on the card by chip_smoke.py.
"""

import ctypes
import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from geodiffuser_tpu.kernels import flash_attention as jfa
from geodiffuser_tpu.kernels import removal_corr as jrc
from geodiffuser_tpu_torch.kernels import flash_attention as fa
from geodiffuser_tpu_torch.kernels import removal_corr as rc

# every xdist worker imports this module at collection, so the heap trim
# after each test (heap_trim.py) covers the whole session
pytest_plugins = ("heap_trim",)

torch.set_num_threads(1)


def _rss():
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def test_heap_trim_returns_freed_heap():
    """Pages freed between live heap chunks stay resident until the trim
    that heap_trim.py runs after every test hands them back."""
    import heap_trim

    malloc, free = heap_trim._LIBC.malloc, heap_trim._LIBC.free
    malloc.restype, malloc.argtypes = ctypes.c_void_p, [ctypes.c_size_t]
    free.argtypes = [ctypes.c_void_p]
    n, size, keep_every = 32768, 4000, 16
    chunks = [malloc(size) for _ in range(n)]
    assert all(chunks)
    for p in chunks:
        ctypes.memset(p, 1, size)
    kept = chunks[::keep_every]
    for i, p in enumerate(chunks):
        if i % keep_every:
            free(p)
    freed = (n - len(kept)) * size
    try:
        before = _rss()
        assert heap_trim.trim()
        assert before - _rss() >= freed // 2, (before, _rss(), freed)
    finally:
        for p in kept:
            free(p)


def test_heap_trim_runs_after_growth():
    """The collection and trim after a test run first, then only once the
    resident set has grown by GROWTH since the last one (or where it is
    unknown); this process's resident set is read."""
    import heap_trim

    g = heap_trim.GROWTH
    assert heap_trim.due(5 * g, None) and heap_trim.due(None, 5 * g)
    assert not heap_trim.due(5 * g + g - 1, 5 * g) and not heap_trim.due(4 * g, 5 * g)
    assert heap_trim.due(6 * g, 5 * g)
    assert heap_trim.resident_bytes() == _rss() > 0


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


# float32 on both sides: the two differ only in summation order
FLASH_TOL = dict(atol=2e-5, rtol=1e-4)
GRAD_TOL = dict(atol=5e-4, rtol=1e-3)


# square maps at the three head widths (D 160: the UNet's 32^2 level at
# 1024^2 images), and the warped-row blend's class: fewer query rows than
# keys at D=40
@pytest.mark.parametrize("b,h,lq,lk,d", [(1, 2, 256, 256, 40), (1, 2, 256, 512, 80),
                                         (1, 2, 256, 1024, 40), (1, 2, 256, 256, 160)])
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


@pytest.mark.parametrize("lq,lk,d", [(256, 256, 40), (256, 512, 80), (256, 1024, 40),
                                     (256, 256, 160)])
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


# bf16 on both sides: the Pallas kernels round unnormalized probabilities
# (online softmax) and the plain versions normalized ones to bf16 before P V,
# and each rounds its output to bf16; the card's kernels are held to the
# plain versions at the same 1.6e-2 of the largest value (chip_smoke.py)
BF16_REL = 1.6e-2


def _rel(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("lq,lk,d", [(256, 256, 40), (256, 1024, 40), (256, 512, 80)])
def test_flash_bf16_plain_matches_pallas(lq, lk, d):
    """The bf16 rounding points of the plain versions (P and dS cast to bf16
    before their products, float32 LSE in natural log) against the Pallas
    forward and backward run in bf16 in interpret mode."""
    rng = np.random.RandomState(7)
    b = 2
    q, k, v = (rng.randn(b, n, d).astype(np.float32) for n in (lq, lk, lk))
    co = rng.randn(b, lq, d).astype(np.float32)
    scale = d ** -0.5
    bf = lambda x: jnp.asarray(x, jnp.bfloat16)
    tb = lambda x: torch.from_numpy(x).to(torch.bfloat16)

    def fwd(q_, k_, v_):
        return jfa._flash_fwd_impl(q_, k_, v_, scale, 256, 256, True)

    def loss(q_, k_, v_):
        o_ = jfa.flash_attention(q_, k_, v_, scale, 256, 256, True)
        return jnp.sum(o_.astype(jnp.float32) * jnp.asarray(co))

    (o_ref, lse_ref), g_ref = jax.jit(lambda *a: (fwd(*a), jax.grad(loss, argnums=(0, 1, 2))(*a)))(
        bf(q), bf(k), bf(v))
    assert o_ref.dtype == jnp.bfloat16 and g_ref[0].dtype == jnp.bfloat16
    o, lse = fa.flash_fwd_plain(tb(q), tb(k), tb(v), scale)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert _rel(o.float().numpy(), o_ref) <= BF16_REL
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref)[..., 0], atol=1e-3)
    # the gradient of sum(o * co): dO = co rounded to bf16, as the kernels receive it
    got = fa.flash_bwd_plain(tb(q), tb(k), tb(v), o, lse, tb(co), scale)
    for g, r, name in zip(got, g_ref, "qkv"):
        assert g.dtype == torch.bfloat16
        assert _rel(g.float().numpy(), r) <= BF16_REL, name


MAIN_PATH_FLASH = [(16, 4096, 4096, 40), (8, 4096, 4096, 40), (16, 1024, 1024, 80),
                   (8, 1024, 1024, 80), (8, 1024, 4096, 40), (8, 256, 1024, 80)]


# the 1024^2 paths' shapes (128^2 at D 40, 32^2 at D 160 and its warped-row
# map) and a width between 128 and 160
LARGE_PATH_FLASH = [(16, 16384, 16384, 40), (8, 4096, 16384, 40), (16, 1024, 1024, 160),
                    (8, 1024, 1024, 160), (8, 256, 1024, 160), (2, 300, 700, 136)]


@pytest.mark.parametrize("shape", MAIN_PATH_FLASH + [(3, 200, 1100, 72),
                                                     (1, 64, 64, 8), (2, 100, 70, 36)]
                         + LARGE_PATH_FLASH)
def test_flash_tile_plan_covers_every_row_and_key(shape):
    """The bf16 kernels' launch plan: every row of each kernel's output axis
    lies in one block, every tile of its loop axis is taken by exactly one
    warpgroup of each row tile, the TMA maps have 16-byte rows and boxes
    that cover the padded head dim, and the wgmma depth covers it in k16
    steps.  At variant 160 the dk/dv kernel's two warpgroups share one row
    tile and each takes every loop tile, one for dV and one for dK."""
    b, lq, lk, d = shape
    plan = fa.tile_plan(b, lq, lk, d)
    assert plan["d_pad"] % 8 == 0 and d <= plan["d_pad"] < d + 8
    assert plan["variant"] >= plan["d_pad"] and plan["variant"] in (40, 80, 160)
    assert plan["k_depth"] % 16 == 0 and plan["k_depth"] - 16 < plan["variant"] <= plan["k_depth"]
    for name, length in (("q", lq), ("k", lk)):
        m = plan["maps"][name]
        assert m["dims"] == (plan["d_pad"], length, b)
        assert all(st % 16 == 0 for st in m["strides"]) and m["strides"][0] == 2 * plan["d_pad"]
        assert m["box"] == (64, 64, 1) and m["boxes_per_tile"] * 64 >= plan["variant"]
    fwd_wgs = fa.FWD_WARPGROUPS[plan["variant"]]
    for kern, rows, loop, wgs in (("fwd", lq, lk, fwd_wgs), ("dq", lq, lk, fa.BWD_WARPGROUPS),
                                  ("dkv", lk, lq, fa.BWD_WARPGROUPS)):
        k = plan[kern]
        gx, gb = k["grid"]
        roles = len(k.get("roles", ("dk and dv",)))
        assert roles == 1 or (kern == "dkv" and plan["variant"] == 160 and k["row_tiles"] == 1)
        assert k["warpgroups"] == wgs and k["row_tiles"] * k["splits"] * roles == wgs
        assert k["rows_per_block"] == 64 * k["row_tiles"]
        assert gb == b and gx * k["rows_per_block"] >= rows > (gx - 1) * k["rows_per_block"]
        assert k["loop_tiles"] * 64 >= loop > (k["loop_tiles"] - 1) * 64
        per = k["tiles_per_warpgroup"]
        assert len(per) == k["splits"] and sum(per) == k["loop_tiles"] and max(per) - min(per) <= 1
        assert k["splits"] <= 2   # each loaded tile feeds at least half the warpgroups
        if k["row_tiles"] > max(1, wgs // 2):   # more row tiles only where blocks fill the card
            assert gx * gb >= fa.SMS - fa.SMS // 10


def test_flash_tile_plan_main_path_choices():
    """The per-shape choice recorded in PERF.md (each the fastest of the row
    tiles measured on the card): the 64^2 maps' forward takes four row tiles
    a block, the warped-row map at 64^2 two; the 32^2 maps trade row tiles
    for blocks where the block count would fall under about one per SM."""
    rows = {s: tuple(fa.tile_plan(*s)[k]["row_tiles"] for k in ("fwd", "dq", "dkv"))
            for s in MAIN_PATH_FLASH}
    assert rows == {(16, 4096, 4096, 40): (4, 2, 2), (8, 4096, 4096, 40): (4, 2, 2),
                    (16, 1024, 1024, 80): (2, 2, 2), (8, 1024, 1024, 80): (1, 1, 1),
                    (8, 1024, 4096, 40): (2, 1, 2), (8, 256, 1024, 80): (1, 1, 1)}


def test_flash_tma_padding_and_counts():
    """Host-side preparation of bf16 operands: the head dim is zero-padded
    to a multiple of 8 and a base off 16-byte alignment is copied; launches
    are counted per wrapper and per shape."""
    x = torch.randn(2, 10, 36).to(torch.bfloat16)
    p = fa._tma_ready(x, 40)
    assert p.shape == (2, 10, 40) and torch.equal(p[..., :36], x) and not p[..., 36:].any()
    assert fa._tma_ready(p, 40) is p
    off = torch.zeros(1 + 2 * 10 * 40, dtype=torch.bfloat16)[1:].view(2, 10, 40)
    assert off.data_ptr() % 16 != 0
    fixed = fa._tma_ready(off, 40)
    assert fixed.data_ptr() % 16 == 0 and torch.equal(fixed, off)
    assert torch.equal(fa._unpad(p, 36), x) and fa._unpad(p, 36).is_contiguous()
    before, shapes = dict(fa.LAUNCHES), dict(fa.SHAPES)
    try:
        fa._count("flash_fwd", 8, 1024, 4096, 40)
        fa._count("flash_fwd", 8, 1024, 4096, 40)
        assert fa.LAUNCHES["flash_fwd"] == before["flash_fwd"] + 2
        assert fa.SHAPES[("flash_fwd", 8, 1024, 4096, 40)] == \
            shapes.get(("flash_fwd", 8, 1024, 4096, 40), 0) + 2
    finally:
        fa.LAUNCHES.update(before)
        fa.SHAPES.clear()
        fa.SHAPES.update(shapes)


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


def _removal_loss(p_in, p_bg, dist_w, row_mask, log, clamp, arr):
    per = arr(dist_w) * (-log(clamp(p_bg) + 1e-4) + log(clamp(p_in) + 1e-4))
    return (per * arr(row_mask)[None]).sum()


@functools.lru_cache(maxsize=None)
def _corr_grad_case(lk):
    """The removal-style loss of the gradient tests: its inputs, and per
    impl ("pallas" in interpret mode, "xla") the JAX package's value, its
    gradients in (qe, ke) and the forward's outputs (jitted once per Lk and
    shared by the tests that read them)."""
    rng = np.random.RandomState(5)
    h, k_rows, l, d = 2, 32, 128, 24
    qe, ke, qb, kb, inp, bg = _scene(rng, h, k_rows, l, lk, d)
    row_mask = (np.arange(k_rows) < 20).astype(np.float32)
    dist_w = rng.rand(h, k_rows).astype(np.float32)
    scale = d ** -0.5

    def jloss(qe_, ke_, impl):
        out = jrc.removal_correlation(
            qe_, ke_, jnp.asarray(qb), jnp.asarray(kb), jnp.asarray(inp), jnp.asarray(bg),
            jnp.asarray(row_mask), scale, impl, True)
        return _removal_loss(out[0], out[1], dist_w, row_mask, jnp.log,
                             lambda x: jnp.maximum(x, 0.0), jnp.asarray), out

    ref = {impl: jax.jit(jax.value_and_grad(lambda a, b: jloss(a, b, impl), argnums=(0, 1),
                                            has_aux=True))(jnp.asarray(qe), jnp.asarray(ke))
           for impl in ("pallas", "xla")}
    return (qe, ke, qb, kb, inp, bg, row_mask, dist_w, scale), ref


@pytest.mark.parametrize("lk", [128, 77])
def test_corr_gradients_match_jax(lk):
    """d/dqe and d/dke of a removal-style loss through the port's autograd
    Function against removal_correlation(impl="pallas", interpret=True) with
    the JAX package's own Pallas-vs-XLA tolerances (the Pallas kernel rounds
    unnormalized exponentials to bf16, the XLA path and the port normalized
    probabilities), and against impl="xla" at float32 tolerance."""
    (qe, ke, qb, kb, inp, bg, row_mask, dist_w, scale), ref = _corr_grad_case(lk)
    qt, kt = _t(qe).requires_grad_(True), _t(ke).requires_grad_(True)
    p_in, p_bg, _, _ = rc.removal_correlation(
        qt, kt, _t(qb), _t(kb), _t(inp), _t(bg), _t(row_mask), scale)
    v = _removal_loss(p_in, p_bg, dist_w, row_mask, torch.log,
                      lambda x: torch.clamp(x, min=0.0), _t)
    v.backward()
    for impl, v_tol, g_tol in (("pallas", dict(rtol=2e-2), dict(atol=3e-3, rtol=3e-2)),
                               ("xla", dict(rtol=1e-5), dict(atol=1e-5, rtol=1e-4))):
        (v_ref, _), g_ref = ref[impl]
        np.testing.assert_allclose(v.item(), float(v_ref), err_msg=impl, **v_tol)
        for g, r, name in zip((qt.grad, kt.grad), g_ref, ("dqe", "dke")):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), err_msg=f"{impl} {name}", **g_tol)

# removal-correlation shapes the paths launch (H, K budget, L, Lk, D): the
# editor's budget seq // 4 and the remover's seq // 2, at 64^2 (D 40) and
# 32^2 (D 80), self (Lk = L) and cross (77 text keys) layers
MAIN_PATH_CORR = [(8, 1024, 4096, 4096, 40), (8, 1024, 4096, 77, 40), (8, 256, 1024, 1024, 80),
                  (8, 256, 1024, 77, 80), (8, 2048, 4096, 4096, 40), (8, 2048, 4096, 77, 40),
                  (8, 512, 1024, 1024, 80), (8, 512, 1024, 77, 80)]


# the 1024^2 editor's and remover's 128^2 self layers and the 768^2
# remover's 96^2 one: budgets of 64, 128 and 72 chunks of 64 rows
LARGE_PATH_CORR = [(8, 4096, 16384, 16384, 40), (8, 8192, 16384, 16384, 40),
                   (8, 4608, 9216, 9216, 40)]


@pytest.mark.parametrize("shape", MAIN_PATH_CORR + [(2, 100, 200, 77, 36), (1, 1, 64, 1, 8),
                                                    (3, 4096, 130, 4097, 72)] + LARGE_PATH_CORR)
def test_corr_plan_covers_every_chunk_row_and_key(shape):
    """What the wrapper hands the bf16 correlation kernels: the head dim and
    the keys padded to what TMA and wgmma take, a P_e scratch that holds
    every edit row at every padded key, and key splits that, at
    ceil(tiles / splits) tiles each as csrc takes them, give every key tile
    to exactly one non-empty split of at most KEY_SPLIT tiles."""
    h, k_rows, l, lk, d = shape
    plan = rc.corr_plan(h, k_rows, l, lk, d)
    assert plan["d_pad"] % 8 == 0 and d <= plan["d_pad"] < d + 8
    nt = plan["lk_pad"] // 64
    assert plan["lk_pad"] % 64 == 0 and nt * 64 >= lk > (nt - 1) * 64
    assert plan["pe_shape"] == (h, k_rows, plan["lk_pad"])
    splits = plan["splits"]
    per = -(-nt // splits)
    tiles = [list(range(z * per, min(nt, (z + 1) * per))) for z in range(splits)]
    assert sorted(t for ts in tiles for t in ts) == list(range(nt))
    assert all(1 <= len(ts) <= rc.KEY_SPLIT for ts in tiles)
    assert plan["warpgroups"] in (1, 2)


def test_corr_plain_past_4096_rows_matches_xla():
    """A budget of 65 chunks of 64 rows (past the 4096 rows the kernels
    once took), at a small H and D: the plain forward against `_corr_xla`,
    the JAX package's formulation that the plain version follows, at
    CORR_TOL (the two softmaxes may round a probability to neighbouring
    bf16 values, and then an index may move on a near-tie), dead rows to
    the sentinel."""
    rng = np.random.RandomState(9)
    h, k_rows, l, lk, d = 1, 4160, 128, 96, 8
    qe, ke, qb, kb, inp, bg = _scene(rng, h, k_rows, l, lk, d)
    live = 4100
    row_mask = (np.arange(k_rows) < live).astype(np.float32)
    scale = d ** -0.5
    ref = jax.jit(jrc._corr_xla, static_argnums=6)(
        *(jnp.asarray(x) for x in (qe, ke, qb, kb, inp, bg)), scale)
    got = rc.removal_correlation(*(_t(x) for x in (qe, ke, qb, kb, inp, bg, row_mask)), scale)
    for g, r in zip(got[:2], ref[:2]):
        np.testing.assert_allclose(g.numpy()[:, :live], np.asarray(r)[:, :live], **CORR_TOL)
        assert np.all(g.numpy()[:, live:] == rc.NEG_INF)
    for g, r in zip(got[2:], ref[2:]):
        assert (g.numpy()[:, :live] == np.asarray(r)[:, :live]).mean() >= 0.99
        assert np.all(g.numpy()[:, live:] == 0)


def test_corr_plan_main_path_scratch_and_counts():
    """The P_e scratch at the 64^2 self layers (64 MiB at the editor's
    1024-row budget, 128 MiB at the remover's 2048) and at the 1024^2
    remover's 128^2 self layer (2 GiB at 8192 rows), the 77 text keys padded
    to two key tiles, the split and warpgroup choices of the 64^2 self
    layer, and the launch count per shape."""
    mib = 2 ** 20
    pe_bytes = lambda *shape: 2 * int(np.prod(rc.corr_plan(*shape)["pe_shape"]))
    assert pe_bytes(8, 1024, 4096, 4096, 40) == 64 * mib
    assert pe_bytes(8, 2048, 4096, 4096, 40) == 128 * mib
    assert pe_bytes(8, 8192, 16384, 16384, 40) == 2048 * mib
    assert rc.corr_plan(8, 256, 1024, 77, 80)["lk_pad"] == 128
    assert rc.corr_plan(8, 2048, 4096, 4096, 40)["splits"] == 8
    assert rc.corr_plan(8, 1024, 4096, 4096, 40)["warpgroups"] == 2
    assert rc.corr_plan(8, 256, 1024, 1024, 80)["warpgroups"] == 1
    before, shapes = dict(rc.LAUNCHES), dict(rc.SHAPES)
    key = ("corr_bwd", 8, 512, 1024, 77, 80)
    try:
        rc._count(*key)
        rc._count(*key)
        assert rc.LAUNCHES["corr_bwd"] == before["corr_bwd"] + 2
        assert rc.SHAPES[key] == shapes.get(key, 0) + 2
    finally:
        rc.LAUNCHES.update(before)
        rc.SHAPES.clear()
        rc.SHAPES.update(shapes)


@pytest.mark.parametrize("lk", [128, 77])
def test_corr_backward_from_saved_lse_matches_jax(lk):
    """The plain backward fed the forward's saved LSEs, lse_b gathered at
    the JAX kernel's argmax rows (as the wrapper gathers it on the card),
    with the loss's cotangents, against the gradient of
    removal_correlation(impl="pallas", interpret=True) at the tolerance of
    test_corr_gradients_match_jax (whose JAX program it shares)."""
    (qe, ke, qb, kb, inp, bg, row_mask, dist_w, scale), ref = _corr_grad_case(lk)
    (_, (p_in, p_bg, j_in, j_bg)), g_ref = ref["pallas"]
    p_in, p_bg = np.asarray(p_in), np.asarray(p_bg)
    got = rc.corr_fwd_plain(*(_t(x) for x in (qe, ke, qb, kb, inp, bg, row_mask)), scale)
    lse_e, lse_b = got[4], got[5]
    s_b = np.einsum("hld,hkd->hlk", qb.astype(np.float64), kb.astype(np.float64)) * scale
    np.testing.assert_allclose(lse_b.numpy(), np.log(np.exp(s_b).sum(-1)), rtol=1e-5, atol=1e-5)
    # d loss / d p of _removal_loss; mask-excluded maxima and dead rows carry none
    live = row_mask[None] * (p_in > rc.MASKED * 0.5) * (p_bg > rc.MASKED * 0.5)
    g_in = np.where(p_in > 0, dist_w / (np.maximum(p_in, 0) + 1e-4), 0) * live
    g_bg = np.where(p_bg > 0, -dist_w / (np.maximum(p_bg, 0) + 1e-4), 0) * live
    d_qe, d_ke = rc.corr_bwd_plain(
        *(_t(x) for x in (qe, ke, qb, kb)), torch.from_numpy(np.array(j_in)),
        torch.from_numpy(np.array(j_bg)), _t(g_in), _t(g_bg), _t(row_mask), lse_e, lse_b, scale)
    for g, r, name in zip((d_qe, d_ke), g_ref, ("dqe", "dke")):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), err_msg=name, atol=3e-3, rtol=3e-2)
