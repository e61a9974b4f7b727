"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--steps N] [--seed S] [--profile]

Phases, each of which fails the run on error:
  1. builds the hand-written CUDA kernels from `geodiffuser_tpu_torch/csrc`;
  2. holds each kernel against its plain PyTorch version at the main path's
     shapes, in float32 and bfloat16, and times kernel, plain version and,
     for attention, `scaled_dot_product_attention` as a yardstick;
  3. runs one full-width `geometry_editor` edit (SD-1.4 geometry, bf16,
     512^2, random weights from --seed) through `EditSession.run`, with every
     kernel's launch count set to 0 just before and read just after;
  4. runs a tiny float32 edit on the card and on the CPU (plain versions)
     and compares them.
Prints the card, a {"kernels": [...]} line and, last, the result line.
float32 matmuls and convolutions run without TF32 (both switches are set
off below) so that float32 comparisons hold float32 tolerances.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

import numpy as np

SIZE = 512                      # image side of the full-width edit
PEAK_BYTES = 3.35e12            # H100 SXM HBM3, bytes/s
PEAK_OPS = {"bf16": 989e12, "f32": 67e12}   # dense tensor-core bf16; float32 CUDA cores


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 10) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, n_ops: float, kind: str):
    t_bytes, t_ops = n_bytes / PEAK_BYTES, n_ops / PEAK_OPS[kind]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def rel_err(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def abs_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def expect(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# Kernel checks
# ---------------------------------------------------------------------------

# relative tolerances of kernel vs plain version: float32 differs only in
# summation order; bf16 outputs may differ by a rounding step of the output
# type (2^-8 relative) where the float32 sums straddle it
TOL = {"f32": 1e-4, "bf16": 1.6e-2}


def check_flash(rng_seed: int):
    import torch
    import torch.nn.functional as F

    from geodiffuser_tpu_torch.kernels import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(rng_seed)
    # (B = streams * heads, Lq, Lk, D): a 2-stream vanilla call at 64^2, the
    # 32^2 maps, and the warped-row blend's rectangular 1024 x 4096 map;
    # the last shape of each list is ragged (no multiple of the 64-row tile)
    fwd_shapes = [(16, 4096, 4096, 40), (16, 1024, 1024, 80), (8, 1024, 4096, 40),
                  (8, 256, 1024, 80), (3, 200, 1100, 72)]
    bwd_shapes = [(8, 4096, 4096, 40), (8, 1024, 1024, 80), (3, 200, 1100, 72)]
    rec = {}
    for kind, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        for i, (b, lq, lk, d) in enumerate(fwd_shapes):
            q = torch.randn(b, lq, d, device="cuda", generator=g).to(dt)
            k = torch.randn(b, lk, d, device="cuda", generator=g).to(dt)
            v = torch.randn(b, lk, d, device="cuda", generator=g).to(dt)
            scale = d ** -0.5
            o, lse = fa.flash_fwd_cuda(q, k, v, scale)
            o_p, lse_p = fa.flash_fwd_plain(q, k, v, scale)
            torch.cuda.synchronize()
            e_o, e_l = rel_err(o, o_p), abs_err(lse, lse_p)
            log(f"flash_fwd {kind} {(b, lq, lk, d)}: rel err o {e_o:.2e} lse abs {e_l:.2e} "
                f"(tol {TOL[kind]:.1e})")
            expect(e_o <= TOL[kind] and e_l <= 1e-3, f"flash_fwd {kind} {(b, lq, lk, d)}")
            if i == 0 and kind == "bf16":
                ms = time_ms(lambda: fa.flash_fwd_cuda(q, k, v, scale))
                plain = time_ms(lambda: fa.flash_fwd_plain(q, k, v, scale), 3)
                q4, k4, v4 = q[None], k[None], v[None]
                lib = time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=scale))
                e = 2
                bnd = bound_ms(e * (2 * b * lq * d + 2 * b * lk * d) + 4 * b * lq,
                               4 * b * lq * lk * d, kind)
                rec["flash_fwd"] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound=bnd,
                                        max_abs_err=abs_err(o, o_p),
                                        shape=[b, lq, lk, d], dtype=kind)
        for i, (b, lq, lk, d) in enumerate(bwd_shapes):
            q = torch.randn(b, lq, d, device="cuda", generator=g).to(dt)
            k = torch.randn(b, lk, d, device="cuda", generator=g).to(dt)
            v = torch.randn(b, lk, d, device="cuda", generator=g).to(dt)
            do = torch.randn(b, lq, d, device="cuda", generator=g).to(dt)
            scale = d ** -0.5
            o, lse = fa.flash_fwd_plain(q, k, v, scale)
            got = fa.flash_bwd_cuda(q, k, v, o, lse, do, scale)
            ref = fa.flash_bwd_plain(q, k, v, o, lse, do, scale)
            torch.cuda.synchronize()
            errs = [rel_err(x, y) for x, y in zip(got, ref)]
            log(f"flash_bwd {kind} {(b, lq, lk, d)}: rel err dq/dk/dv "
                f"{' '.join(f'{x:.2e}' for x in errs)} (tol {TOL[kind]:.1e})")
            expect(max(errs) <= TOL[kind], f"flash_bwd {kind} {(b, lq, lk, d)}")
            if i == 0 and kind == "bf16":
                ms = time_ms(lambda: fa.flash_bwd_cuda(q, k, v, o, lse, do, scale))
                plain = time_ms(lambda: fa.flash_bwd_plain(q, k, v, o, lse, do, scale), 3)
                q4, k4, v4 = (x[None].detach().requires_grad_(True) for x in (q, k, v))
                out = F.scaled_dot_product_attention(q4, k4, v4, scale=scale)
                lib = time_ms(lambda: torch.autograd.grad(out, (q4, k4, v4), do[None],
                                                          retain_graph=True))
                e = 2
                bnd = bound_ms(e * (4 * b * lq * d + 2 * b * lk * d + b * lq * d + 2 * b * lk * d)
                               + 4 * b * lq, 10 * b * lq * lk * d, kind)
                rec["flash_bwd"] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound=bnd,
                                        max_abs_err=max(abs_err(x, y) for x, y in zip(got, ref)),
                                        shape=[b, lq, lk, d], dtype=kind)
    return rec


def check_corr(rng_seed: int, live_rows: int):
    import torch

    from geodiffuser_tpu_torch.kernels import removal_corr as rc

    g = torch.Generator(device="cuda").manual_seed(rng_seed)
    # (H, K budget, L base rows, Lk keys, D, tied): 64^2 self, 64^2 cross (77
    # text keys), 32^2 self, and 32^2 self with every inpaint base row equal
    # and every background base row equal, so that each live row's two maxima
    # are exact ties across lanes and spans and must take the lowest j
    shapes = [(8, 1024, 4096, 4096, 40, False), (8, 1024, 4096, 77, 40, False),
              (8, 256, 1024, 1024, 80, False), (8, 256, 1024, 1024, 80, True)]
    rec = {}
    for kind, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        for i, (h, kr, l, lk, d, tied) in enumerate(shapes):
            live = min(live_rows * kr // 1024, kr)
            qe = torch.randn(h, kr, d, device="cuda", generator=g).to(dt)
            ke = torch.randn(h, lk, d, device="cuda", generator=g).to(dt)
            qb = torch.randn(h, l, d, device="cuda", generator=g).to(dt)
            kb = torch.randn(h, lk, d, device="cuda", generator=g).to(dt)
            inp = (torch.rand(l, device="cuda", generator=g) < 0.1).float()
            bg = ((torch.rand(l, device="cuda", generator=g) < 0.8) & (inp < 0.5)).float()
            first_in, first_bg = (int(torch.nonzero(m)[0]) for m in (inp, bg))
            if tied:
                qb[:, inp > 0.5] = qb[:, first_in:first_in + 1]
                qb[:, bg > 0.5] = qb[:, first_bg:first_bg + 1]
            rm = (torch.arange(kr, device="cuda") < live).float()
            scale = d ** -0.5
            got = rc.corr_fwd_cuda(qe, ke, qb, kb, inp, bg, rm, scale)
            ref = rc.corr_fwd_plain(qe, ke, qb, kb, inp, bg, rm, scale)
            torch.cuda.synchronize()
            # values: float32 sums of the same bf16-rounded probabilities, whose
            # rounding may differ by one step where exp(s - lse) and softmax
            # straddle it; indices: equal except at near-ties, where the
            # kernel's index must attain the plain maximum of its masked columns
            e_p = max(rel_err(got[0][:, :live], ref[0][:, :live]),
                      rel_err(got[1][:, :live], ref[1][:, :live]))
            pe = rc._probs(qe, ke, scale).float()
            pb = rc._probs(qb, kb, scale).float()
            corr = torch.matmul(pe, pb.transpose(-1, -2))
            e_idx, same = [], []
            for col, (p_ref, j_got, j_ref) in ((inp, (ref[0], got[2], ref[2])),
                                               (bg, (ref[1], got[3], ref[3]))):
                masked = torch.where(col[None, None] > 0.5, corr, rc.MASKED)
                at_idx = torch.gather(masked, 2, j_got.long()[..., None])[..., 0][:, :live]
                e_idx.append(rel_err(at_idx, p_ref[:, :live]))
                same.append(float((j_got[:, :live] == j_ref[:, :live]).float().mean()))
            del corr
            dead_ok = all(bool((got[n][:, live:] == v).all())
                          for n, v in ((0, rc.NEG_INF), (1, rc.NEG_INF), (2, 0), (3, 0)))
            tie_ok = not tied or bool((got[2][:, :live] == first_in).all()
                                      and (got[3][:, :live] == first_bg).all())
            log(f"corr_fwd {kind} {(h, kr, l, lk, d)}{' tied' if tied else ''} live {live}: "
                f"rel err p {e_p:.2e}, corr at j_in/j_bg {e_idx[0]:.2e}/{e_idx[1]:.2e}, "
                f"j_in/j_bg equal {same[0]:.4f}/{same[1]:.4f}, dead rows ok {dead_ok}"
                + (f", lowest j on ties {tie_ok}" if tied else ""))
            # on planted ties the plain index rests on cuBLAS's rounding of
            # equal rows; the kernel's is held to the lowest j exactly instead
            expect(e_p <= 1e-2 and max(e_idx) <= 1e-2 and (tied or min(same) >= 0.98)
                   and dead_ok and tie_ok, f"corr_fwd {kind} {(h, kr, l, lk, d)} tied={tied}")
            # backward from the same residuals (the plain forward's indices)
            g_in = torch.where(rm[None] > 0.5, torch.randn(h, kr, device="cuda", generator=g), 0)
            g_bg = torch.where(rm[None] > 0.5, torch.randn(h, kr, device="cuda", generator=g), 0)
            q_in = rc._gather_rows(qb, ref[2]).contiguous()
            q_bg = rc._gather_rows(qb, ref[3]).contiguous()
            bgot = rc.corr_bwd_cuda(qe, ke, kb, q_in, q_bg, g_in, g_bg, rm, scale)
            bref = rc.corr_bwd_plain(qe, ke, kb, q_in, q_bg, g_in, g_bg, scale)
            torch.cuda.synchronize()
            errs = [rel_err(x, y) for x, y in zip(bgot, bref)]
            log(f"corr_bwd {kind} {(h, kr, l, lk, d)}: rel err d_qe/d_ke "
                f"{errs[0]:.2e} {errs[1]:.2e} (tol {TOL[kind]:.1e})")
            expect(max(errs) <= TOL[kind], f"corr_bwd {kind} {(h, kr, l, lk, d)}")
            if i == 0 and kind == "bf16":
                ms = time_ms(lambda: rc.corr_fwd_cuda(qe, ke, qb, kb, inp, bg, rm, scale), 5)
                plain = time_ms(lambda: rc.corr_fwd_plain(qe, ke, qb, kb, inp, bg, rm, scale), 3)
                nb = 2 * (live * d + 2 * lk * d + l * d) * h + 8 * l + 4 * kr + 16 * h * kr
                ops = 2 * h * (live + l) * lk * d + 2 * h * live * l * lk
                rec["corr_fwd"] = dict(ms=ms, plain_ms=plain, library_ms=None,
                                       max_abs_err=max(abs_err(got[0][:, :live], ref[0][:, :live]),
                                                       abs_err(got[1][:, :live], ref[1][:, :live])),
                                       bound=bound_ms(nb, ops, kind), shape=[h, kr, l, lk, d],
                                       live_rows=live, dtype=kind)
                ms = time_ms(lambda: rc.corr_bwd_cuda(qe, ke, kb, q_in, q_bg, g_in, g_bg, rm, scale))
                plain = time_ms(lambda: rc.corr_bwd_plain(qe, ke, kb, q_in, q_bg, g_in, g_bg, scale))
                nb = 2 * h * d * (3 * live + 2 * lk) + 8 * h * live + 4 * kr \
                    + 4 * h * d * (live + lk)
                ops = 10 * h * live * lk * d
                rec["corr_bwd"] = dict(ms=ms, plain_ms=plain, library_ms=None,
                                       max_abs_err=max(abs_err(x, y) for x, y in zip(bgot, bref)),
                                       bound=bound_ms(nb, ops, kind), shape=[h, kr, lk, d],
                                       live_rows=live, dtype=kind)
    return rec


# ---------------------------------------------------------------------------
# The edit
# ---------------------------------------------------------------------------

def build_scene(size: int):
    """Synthetic scene (the JAX package's bench.py build_scene)."""
    rng = np.random.RandomState(0)
    image = (rng.rand(size, size, 3) * 255).astype(np.uint8)
    yy, xx = np.mgrid[0:size, 0:size]
    mask = (((xx - size * 0.4) ** 2 + (yy - size * 0.6) ** 2) < (size * 0.15) ** 2
            ).astype(np.float32)
    depth = (0.3 + 0.5 * (yy / size)).astype(np.float32)
    return image, depth, mask


def run_edit(args):
    import torch

    from geodiffuser_tpu_torch.config import EditConfig, ModelConfig
    from geodiffuser_tpu_torch.core.editor import EditSession
    from geodiffuser_tpu_torch.core.pipeline import Pipeline
    from geodiffuser_tpu_torch.kernels import flash_attention as fa
    from geodiffuser_tpu_torch.kernels import removal_corr as rc
    from geodiffuser_tpu_torch.ops import camera

    t0 = time.time()
    pipe = Pipeline.create(ModelConfig(), image_size=SIZE, seed=args.seed, device="cuda")
    torch.cuda.synchronize()
    log(f"pipeline: SD-1.4 geometry, bf16, {SIZE}^2, random init seed {args.seed}: "
        f"{time.time() - t0:.1f} s")
    cfg = EditConfig(num_ddim_steps=args.steps, cache_inversion=False)
    sess = EditSession(pipe, cfg, device="cuda")
    image, depth, mask = build_scene(SIZE)
    transform = camera.compose_transform(tx=0.08, ry=15.0)

    for counts in (fa.LAUNCHES, rc.LAUNCHES):
        counts.update(dict.fromkeys(counts, 0))
    torch.cuda.reset_peak_memory_stats()
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            res = sess.run(image, depth, mask, transform, prompt="")
            torch.cuda.synchronize()
        report_profile(prof, res.timings["total"])
    else:
        res = sess.run(image, depth, mask, transform, prompt="")
    torch.cuda.synchronize()
    launches = {**fa.LAUNCHES, **rc.LAUNCHES}
    log(f"edit ({args.steps} DDIM steps): timings {json.dumps({k: round(v, 3) for k, v in res.timings.items()})}")
    log(f"edit: max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"edit: kernel launches {launches}")
    for i, logs in sorted(res.loss_log.items()):
        log(f"edit: step {i} loss total {logs['total']:.4f} self/removal {logs['self/removal']:.4f}")
    expect(res.images.shape == (2, SIZE, SIZE, 3), "image shape")
    expect(res.edited_image.shape == (SIZE, SIZE, 3), "edited image shape")
    expect(bool(torch.isfinite(res.latents).all()), "final latents finite")
    expect(len(res.loss_log) >= 2 and all(math.isfinite(v) for lg in res.loss_log.values()
                                          for v in lg.values()), "loss logs finite")
    for name, n in launches.items():
        expect(n > 0, f"kernel {name} was not launched on the main path")
    return launches


def report_profile(prof, wall_s: float) -> None:
    """Device time by kernel name and the device's busy share of the edit."""
    import torch

    # device-side events only: a CPU op's row repeats the time of the
    # kernels it launched
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    log(f"profile: device kernel time {busy_ms:.1f} ms of {wall_s * 1e3:.1f} ms wall "
        f"({100 * busy_ms / (wall_s * 1e3):.1f}%)")
    for name, ms, n in rows[:20]:
        log(f"profile: {ms:10.1f} ms {100 * ms / busy_ms:5.1f}% {n:6d}x {name[:90]}")


def scene_live_rows(size: int) -> int:
    """Live removal-loss rows at the largest latent resolution of the scene
    (what the corr kernels' work depends on)."""
    import torch

    from geodiffuser_tpu_torch.config import EditConfig
    from geodiffuser_tpu_torch.core import edit_state
    from geodiffuser_tpu_torch.ops import camera
    from geodiffuser_tpu_torch.ops import image as image_ops
    from geodiffuser_tpu_torch.ops import transform_field as tf_ops

    cfg = EditConfig()
    image, depth, mask = build_scene(size)
    f32 = dict(dtype=torch.float32, device="cuda")
    mask_t = (torch.as_tensor(mask, **f32) > 0.5).float()
    tf = tf_ops.build_transform_field(
        torch.as_tensor(image.astype(np.float32) / 255.0, **f32), torch.as_tensor(depth, **f32),
        mask_t, torch.as_tensor(camera.compose_transform(tx=0.08, ry=15.0), **f32))
    amodal = image_ops.erode(tf.amodal_mask, cfg.amodal_erode)
    ls = size // 8
    masks = edit_state.build_mask_sets(mask_t, tf.coords, amodal, resolutions=(ls, ls // 2))
    return int(masks[ls].inpaint_row_mask.sum().item())


def small_reference():
    """Tiny float32 edit on the card against the same edit on the CPU (the
    port's plain versions), from the same weights.  lr=0 keeps the step-0
    gradient of the L1 losses, which sit at a zero residual there and take
    the sign of rounding noise, out of the comparison."""
    import torch

    from geodiffuser_tpu_torch.config import EditConfig, ModelConfig
    from geodiffuser_tpu_torch.core.editor import EditSession
    from geodiffuser_tpu_torch.core.pipeline import Pipeline
    from geodiffuser_tpu_torch.ops import camera

    size = 128
    cfg = EditConfig(num_ddim_steps=4, optimize_steps=0.65, skip_optim_steps=2,
                     latent_replace=0.3, lr=0.0)
    rng = np.random.RandomState(0)
    image = rng.rand(size, size, 3).astype(np.float32)
    yy, xx = np.mgrid[0:size, 0:size]
    mask = (((xx - 50) ** 2 + (yy - 70) ** 2) < 25 ** 2).astype(np.float32)
    depth = np.full((size, size), 0.5, np.float32)
    out = {}
    for dev in ("cuda", "cpu"):
        pipe = Pipeline.create(ModelConfig.tiny(), image_size=size, seed=0, device="cpu")
        if dev == "cuda":   # the CPU-made weights, moved
            for module in (pipe.unet, pipe.vae, pipe.text_encoder):
                module.to(dev)
            pipe.device = torch.device(dev)
        out[dev] = EditSession(pipe, cfg, device=dev).run(
            image, depth, mask, camera.compose_transform(tx=0.05), prompt="a thing")
    a, b = out["cuda"], out["cpu"]
    e_lat = rel_err(a.latents.cpu(), b.latents)
    e_log = max(abs(a.loss_log[i][k] - b.loss_log[i][k]) / max(abs(b.loss_log[i][k]), 1e-3)
                for i in b.loss_log for k in b.loss_log[i] if "removal" not in k)
    e_img = int(np.abs(a.images.astype(int) - b.images.astype(int)).max())
    log(f"small reference (tiny fp32, 128^2, card vs CPU): latents rel err {e_lat:.2e}, "
        f"loss logs rel err {e_log:.2e} (removal excluded: near-tied argmax), image max diff {e_img}")
    expect(e_lat <= 1e-3 and e_log <= 1e-3 and e_img <= 2, "small reference")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=6, help="DDIM steps of the edit (50 = default edit)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="trace the edit with torch.profiler and print device time by kernel")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from geodiffuser_tpu_torch.kernels import _build
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable here ({exc})", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.time()
    _build.lib()
    log(f"kernels built in {time.time() - t0:.1f} s (nvcc {_build.build_seconds:.1f} s)")

    rec = check_flash(args.seed)
    rec.update(check_corr(args.seed, scene_live_rows(SIZE)))
    launches = run_edit(args)
    small_reference()

    sources = {
        "flash_fwd": ("geodiffuser_tpu_torch/csrc/flash_attention.cu",
                      "geodiffuser_tpu/kernels/flash_attention.py:98"),
        "flash_bwd": ("geodiffuser_tpu_torch/csrc/flash_attention.cu",
                      "geodiffuser_tpu/kernels/flash_attention.py:234"),
        "corr_fwd": ("geodiffuser_tpu_torch/csrc/removal_corr.cu",
                     "geodiffuser_tpu/kernels/removal_corr.py:202"),
        "corr_bwd": ("geodiffuser_tpu_torch/csrc/removal_corr.cu",
                     "geodiffuser_tpu/kernels/removal_corr.py:462"),
    }
    kernels = []
    for name, (src, replaces) in sources.items():
        r = rec[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r["library_ms"],
            "shape": r["shape"], "dtype": r["dtype"],
        })
    log(json.dumps({"kernels": kernels}))
    log(f"card: {card}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
