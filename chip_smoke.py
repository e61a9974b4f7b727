"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--steps N] [--large-steps N] [--seed S] [--profile]
    python3 chip_smoke.py --only flash,corr,splat [--package-root DIR]

Phases, each of which fails the run on error:
  1. builds the hand-written CUDA kernels from `geodiffuser_tpu_torch/csrc`
     and prints ptxas's registers, spills and warnings for each;
  2. holds each kernel against its plain PyTorch version at the main paths'
     shapes, at 512^2 and 1024^2 images (attention and removal correlation
     in float32 and bfloat16, the fused splat in float32), and times kernel,
     plain version and, for attention, `scaled_dot_product_attention` under
     each backend that runs as a yardstick (bf16 flash and correlation at
     every shape the paths launch, the correlation also at the 768^2
     remover's K = 4608 rows, the splat at the stitch's 512^2 C=4, at C=3
     and C=1 and on the stitch zoomed far out, by device time); the splat's
     every case must give equal bits in two launches and in two runs of its
     plain version, and the stitch composite in two runs;
  3. runs one full-width SD-1.4 UNet pass in bf16 (batch 2, 64x64x4 latent)
     and the latent gradient of <eps, R>, through the flash kernels and
     with `flash_attention` replaced by its plain version, and compares them;
  4. runs full-width edits (SD-1.4 geometry, bf16, random weights from
     --seed): at 512^2 `geometry_editor` and `geometry_remover` through
     `EditSession.run` and `geometry_stitch` through `perform_stitch`; the
     512^2 editor with every run option on (4 steps; null-text, the
     fast-start inner loop, the attention constraints, the inversion cached
     in an experiment folder), twice, the second reading it from the disk; an
     invert -> `reconstruct` round trip; the editor and remover at 1024^2
     (--large-steps); each edit with every kernel's launch count (and
     flash's and the correlation's count per shape) set to 0 just before
     and read just after; a shape launched there but not timed in phase 2
     fails the run; then the batch driver ("driver"): the random pipeline
     written as an fp16 diffusers-layout checkpoint and loaded back with
     `Pipeline.create(checkpoint_dir=...)` (bit-equal, the BPE tokenizer),
     `run_folder_sweep(use_native=True)` over an editor, a remover and a
     stitch folder at --steps (launch counts read as for an edit), a second
     sweep that skips all three, a third that reads every inversion from
     its folder, the editor folder's result against a direct
     `EditSession.run` (equal bits), and the command line
     `python -m geodiffuser_tpu_torch.parallel.driver` on one folder;
  5. runs a tiny float32 editor and remover edit on the card and on the CPU
     (plain versions) and compares them.
`--only` (any of flash, corr, splat) runs phases 1 and 2 for the named
kernels alone; with
`--package-root DIR` the port is imported from DIR (a checkout of another
commit), so that two commits' kernels are timed at the same shapes in one
call.  Prints the card, a
{"kernels": [...]} line and, last, the result line.
float32 matmuls and convolutions run without TF32 (both switches are set
off below) so that float32 comparisons hold float32 tolerances.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import pathlib
import struct
import subprocess
import sys
import tempfile
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
# absolute tolerance of the fused splat (outputs in [0, 1]): the kernel sums
# each cell's corners in ascending point index and the plain version as a
# binary tree over them, so float32 sums differ in order; and expf / logf /
# powf of the CUDA math library differ from PyTorch's by a few ulp
SPLAT_TOL = 1e-5


def flash_path_shapes(size: int):
    """bf16 flash shapes of the paths at a size^2 image, (B = streams * heads,
    Lq, Lk, D): the self-attention of 2- and 1-stream calls at the latent
    levels whose keys reach 1024 (`use_flash`), the backward of the
    1-stream calls, and the warped-row blend's rectangular maps (a quarter
    of the rows) at the two largest levels, which alone have row budgets.
    Returns (forward, backward) shapes."""
    ls = size // 8
    levels = [(res * res, d) for res, d in ((ls, 40), (ls // 2, 80), (ls // 4, 160))
              if res * res >= 1024]
    fwd = [(b, l, l, d) for l, d in levels for b in (16, 8)]
    fwd += [(8, l // 4, l, d) for l, d in levels[:2]]
    return fwd, [(8, l, l, d) for l, d in levels]


# each checked and timed: the 512^2 paths' shapes, then the 1024^2 paths'
# (128^2 at D 40, 64^2 at D 80, 32^2 at D 160)
FLASH_FWD_SHAPES = flash_path_shapes(512)[0] + flash_path_shapes(1024)[0]
FLASH_BWD_SHAPES = flash_path_shapes(512)[1] + flash_path_shapes(1024)[1]
# float32 (CUDA-core kernels, the card-vs-CPU edits' type): a shape of each
# class at each head width
FLASH_F32_FWD = [(16, 4096, 4096, 40), (16, 1024, 1024, 80), (8, 1024, 4096, 40),
                 (8, 256, 1024, 80), (8, 1024, 1024, 160), (8, 256, 1024, 160)]
FLASH_F32_BWD = [(8, 4096, 4096, 40), (8, 1024, 1024, 80), (8, 1024, 1024, 160)]
# checked only: a ragged shape (no multiple of the 64-row tile, D not a
# multiple of 16), and one past 128 columns at another width
FLASH_RAGGED = [(3, 200, 1100, 72), (2, 300, 700, 136)]


def by_chunks(fn, n: int, *args):
    """fn over each entry of the leading axis of every tensor in args that
    has n of them, its outputs concatenated: the plain versions at the
    1024^2 shapes would hold tens of GB of float32 maps at once."""
    import torch

    outs = []
    for i in range(n):
        part = [a[i:i + 1] if torch.is_tensor(a) and a.dim() and a.shape[0] == n else a
                for a in args]
        outs.append(fn(*part))
    if torch.is_tensor(outs[0]):
        return torch.cat(outs)
    return tuple(torch.cat(xs) for xs in zip(*outs))


def device_ms(fn, iters: int = 10) -> float:
    """Device time of `fn` per call: the card first sleeps while the host
    queues all `iters` calls, and events time them back to back, so that a
    host slower than the card does not count (small attention calls take
    less device time than their launch)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)   # ~25 ms of GPU clock cycles, longer than the queueing
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def sdpa_ms(fwd: bool, q, k, v, do, scale: float):
    """The fastest of SDPA's backends that run on these inputs: (ms, name).
    The forward times one call; the backward one autograd backward of it."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    best = (math.inf, None)
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION):
        try:
            with sdpa_kernel([backend]):
                if fwd:
                    ms = device_ms(lambda: F.scaled_dot_product_attention(
                        q[None], k[None], v[None], scale=scale))
                else:
                    q4, k4, v4 = (x[None].detach().requires_grad_(True) for x in (q, k, v))
                    out = F.scaled_dot_product_attention(q4, k4, v4, scale=scale)
                    ms = device_ms(lambda: torch.autograd.grad(out, (q4, k4, v4), do[None],
                                                               retain_graph=True))
        except RuntimeError as exc:   # a backend that does not take these inputs
            log(f"sdpa {backend.name} {'fwd' if fwd else 'bwd'} {tuple(q.shape)}: not run "
                f"({str(exc).splitlines()[0][:80]})")
            continue
        best = min(best, (ms, backend.name), key=lambda r: r[0])
    return best


def flash_bound(fwd: bool, b: int, lq: int, lk: int, d: int):
    """Least time for the work at the native D: each input read once, each
    output written once (bf16 tensors, float32 LSE), and 4 (forward) or 10
    (backward) operations per (q row, key, head column)."""
    e = 2
    if fwd:
        return bound_ms(e * (2 * b * lq * d + 2 * b * lk * d) + 4 * b * lq,
                        4 * b * lq * lk * d, "bf16")
    return bound_ms(e * (4 * b * lq * d + 2 * b * lk * d + b * lq * d + 2 * b * lk * d) + 4 * b * lq,
                    10 * b * lq * lk * d, "bf16")


def check_flash(rng_seed: int):
    import torch

    from geodiffuser_tpu_torch.kernels import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(rng_seed)
    rand = lambda b, n, d, dt: torch.randn(b, n, d, device="cuda", generator=g).to(dt)
    rec = {"flash_fwd": {"shapes": []}, "flash_bwd": {"shapes": []}}
    fwd_plain = lambda q, k, v, scale: by_chunks(
        lambda *a: fa.flash_fwd_plain(*a, scale), q.shape[0], q, k, v)
    bwd_plain = lambda q, k, v, o, lse, do, scale: by_chunks(
        lambda *a: fa.flash_bwd_plain(*a, scale), q.shape[0], q, k, v, o, lse, do)
    for kind, dt, fwd_shapes, bwd_shapes in (
            ("f32", torch.float32, FLASH_F32_FWD + FLASH_RAGGED, FLASH_F32_BWD + FLASH_RAGGED),
            ("bf16", torch.bfloat16, FLASH_FWD_SHAPES + FLASH_RAGGED,
             FLASH_BWD_SHAPES + FLASH_RAGGED)):
        for b, lq, lk, d in fwd_shapes:
            q, k, v = rand(b, lq, d, dt), rand(b, lk, d, dt), rand(b, lk, d, dt)
            scale = d ** -0.5
            o, lse = fa.flash_fwd_cuda(q, k, v, scale)
            o_p, lse_p = fwd_plain(q, k, v, scale)
            torch.cuda.synchronize()
            e_o, e_l = rel_err(o, o_p), abs_err(lse, lse_p)
            log(f"flash_fwd {kind} {(b, lq, lk, d)}: rel err o {e_o:.2e} lse abs {e_l:.2e} "
                f"(tol {TOL[kind]:.1e}, 1e-3)")
            expect(e_o <= TOL[kind] and e_l <= 1e-3, f"flash_fwd {kind} {(b, lq, lk, d)}")
            if kind == "bf16" and (b, lq, lk, d) in FLASH_FWD_SHAPES:
                ms = device_ms(lambda: fa.flash_fwd_cuda(q, k, v, scale))
                plain = device_ms(lambda: fwd_plain(q, k, v, scale), 3)
                lib, backend = sdpa_ms(True, q, k, v, None, scale)
                rec["flash_fwd"]["shapes"].append(dict(
                    shape=[b, lq, lk, d], ms=ms, plain_ms=plain, library_ms=lib,
                    library_backend=backend, bound=flash_bound(True, b, lq, lk, d),
                    max_abs_err=abs_err(o, o_p)))
        for b, lq, lk, d in bwd_shapes:
            q, k, v, do = rand(b, lq, d, dt), rand(b, lk, d, dt), rand(b, lk, d, dt), rand(b, lq, d, dt)
            scale = d ** -0.5
            o, lse = fwd_plain(q, k, v, scale)
            got = fa.flash_bwd_cuda(q, k, v, o, lse, do, scale)
            ref = bwd_plain(q, k, v, o, lse, do, scale)
            torch.cuda.synchronize()
            errs = [rel_err(x, y) for x, y in zip(got, ref)]
            log(f"flash_bwd {kind} {(b, lq, lk, d)}: rel err dq/dk/dv "
                f"{' '.join(f'{x:.2e}' for x in errs)} (tol {TOL[kind]:.1e})")
            expect(max(errs) <= TOL[kind], f"flash_bwd {kind} {(b, lq, lk, d)}")
            if kind == "bf16" and (b, lq, lk, d) in FLASH_BWD_SHAPES:
                ms = device_ms(lambda: fa.flash_bwd_cuda(q, k, v, o, lse, do, scale))
                plain = device_ms(lambda: bwd_plain(q, k, v, o, lse, do, scale), 3)
                lib, backend = sdpa_ms(False, q, k, v, do, scale)
                rec["flash_bwd"]["shapes"].append(dict(
                    shape=[b, lq, lk, d], ms=ms, plain_ms=plain, library_ms=lib,
                    library_backend=backend, bound=flash_bound(False, b, lq, lk, d),
                    max_abs_err=max(abs_err(x, y) for x, y in zip(got, ref))))
    for name, r in rec.items():
        for sh in r["shapes"]:
            log(f"{name} bf16 {tuple(sh['shape'])}: {sh['ms']:.4f} ms, plain {sh['plain_ms']:.4f}, "
                f"SDPA {sh['library_ms']:.4f} ({sh['library_backend']}), bound "
                f"{sh['bound'][0]:.4f} ({sh['bound'][1]}), {sh['ms'] / sh['library_ms']:.2f}x SDPA")
        # the headline fields: the first (largest 512^2) shape of each list
        r.update({k: v for k, v in r["shapes"][0].items() if k != "max_abs_err"},
                 max_abs_err=max(sh["max_abs_err"] for sh in r["shapes"]), dtype="bf16")
    return rec


def check_unet_flash(pipe, seed: int) -> dict:
    """One full-width SD-1.4 UNet pass in bf16 (batch 2, 64x64x4 latent and a
    text embedding from the seed) and the gradient of <eps, R> with respect
    to the latent for a seeded R, once through the kernels and once with
    `flash_attention` replaced by its plain version inside this phase.  The
    ten self-attention layers at 64^2 and 32^2 go through flash_fwd and, in
    the gradient, flash_bwd."""
    import torch

    from geodiffuser_tpu_torch.kernels import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(seed + 2)
    side = SIZE // 8
    latent = torch.randn(2, side, side, 4, device="cuda", generator=g)
    context = torch.randn(2, 77, pipe.config.cross_attention_dim, device="cuda", generator=g)
    r = torch.randn(2, side, side, 4, device="cuda", generator=g)

    def run():
        x = latent.clone().requires_grad_(True)
        eps = pipe.unet(x, 500, context)
        (grad,) = torch.autograd.grad((eps * r).sum(), x)
        torch.cuda.synchronize()
        return eps.detach(), grad

    out = {}
    kernel = fa.flash_attention
    for route in ("kernels", "plain"):
        fa.LAUNCHES.update(dict.fromkeys(fa.LAUNCHES, 0))
        fa.SHAPES.clear()
        if route == "plain":
            fa.flash_attention = fa.attention_plain
        try:
            out[route] = run() + (dict(fa.LAUNCHES), dict(fa.SHAPES))
        finally:
            fa.flash_attention = kernel
    (eps_k, g_k, n_k, s_k), (eps_p, g_p, n_p, _) = out["kernels"], out["plain"]
    e_eps = rel_err(eps_k, eps_p)
    cos = float(torch.nn.functional.cosine_similarity(g_k.flatten(), g_p.flatten(), dim=0))
    log(f"unet bf16 (2, {side}, {side}, 4) kernels vs plain flash: eps rel err {e_eps:.2e} "
        f"(tol 2e-2), latent gradient cosine {cos:.5f} (>= 0.99)")
    log(f"unet launches: kernels {n_k} {shape_counts(s_k)}; plain {n_p}")
    expect(all(bool(torch.isfinite(t).all()) for t in (eps_k, g_k, eps_p, g_p)), "unet: finite")
    expect(e_eps <= 2e-2 and cos >= 0.99, "unet: kernels vs plain flash")
    expect(n_k == {"flash_fwd": 10, "flash_bwd": 10} and n_p == {"flash_fwd": 0, "flash_bwd": 0},
           f"unet: flash launches {n_k} / plain {n_p}")
    del out
    torch.cuda.empty_cache()
    return dict(eps_rel_err=e_eps, grad_cosine=cos)


def shape_counts(shapes: dict) -> str:
    """{(name, B, Lq, Lk, D): n} as 'name BxLqxLkxD: n' items."""
    return ", ".join(f"{k[0]} {'x'.join(map(str, k[1:]))}: {n}" for k, n in sorted(shapes.items()))


def corr_path_shapes(size: int, mode: str):
    """Removal-correlation shapes of an edit at a size^2 image, (H, K budget,
    L, Lk, D): the self (Lk = L) and cross (77 text keys) layers of the two
    largest latent levels (D 40 and 80); the editor's budget is seq // 4,
    the remover's seq // 2."""
    ls = size // 8
    out = []
    for res, d in ((ls, 40), (ls // 2, 80)):
        l = res * res
        k = l // 4 if mode == "editor" else l // 2
        out += [(8, k, l, l, d), (8, k, l, 77, d)]
    return out


# (image side, mode) of each path whose correlation shapes are checked and
# timed; the 768^2 remover (K 4608 past the 4096 rows of 64 chunks) only at
# its 96^2 self layer, and not run as an edit
CORR_PATHS = {"editor": (512, "editor"), "remover": (512, "remover"),
              "editor1024": (1024, "editor"), "remover1024": (1024, "remover"),
              "remover768": (768, "remover")}
CORR_SHAPES = {p: corr_path_shapes(*sm) for p, sm in CORR_PATHS.items()}
CORR_SHAPES["remover768"] = CORR_SHAPES["remover768"][:1]


def ptxas_lines(report: str) -> list:
    """One line per kernel of ptxas's report (registers, spill bytes), and
    its warnings (C7512/C7513: wgmma serialized), with demangled names."""
    import re
    import shutil

    out, name, spills = [], "?", ""
    for line in report.splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", line):
            name = m.group(1)
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
            spills = f"spill stores/loads {m.group(1)}/{m.group(2)} B"
        elif m := re.search(r"Used (\d+) registers", line):
            out.append([name, f"{m.group(1)} registers, {spills}"])
        elif "warning" in line or "Performance Loss" in line:
            named = re.search(r"function '(\w+)'", line)
            text = re.sub(r"^ptxas \w+\s*: ", "", line.strip())
            out.append([named.group(1) if named else name,
                        re.split(r" (?:in|for) the function", text)[0][:160]])
    if out and shutil.which("c++filt"):
        names = subprocess.run(["c++filt", "-p"], input="\n".join(n for n, _ in out),
                               capture_output=True, text=True).stdout.splitlines()
        if len(names) == len(out):
            for row, short in zip(out, names):
                row[0] = short.replace("(anonymous namespace)::", "")
    return [f"{n}: {what}" for n, what in out]


def kernel_breakdown(fn, iters: int = 5) -> str:
    """Device time per call of each CUDA kernel `fn` launches (profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = sorted(((e.key, e.self_device_time_total / 1e3 / iters) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0), key=lambda r: -r[1])
    short = lambda name: name.replace("(anonymous namespace)::", "").replace("void ", "").split("(")[0]
    return "; ".join(f"{ms:.4f} ms {short(name)[-60:]}" for name, ms in rows)


def check_corr(rng_seed: int, live: dict):
    """The correlation kernels against their plain versions at every path
    shape (float32 at 512^2, bf16 at every size), a planted-tie shape, and
    the dead rows; bf16 timed by device time at every path shape.  `live`:
    the scene's live rows per (path, latent side).  The plain versions run a
    head at a time (at the 1024^2 remover's self layer both maps of all
    heads are 12 GiB of float32)."""
    import torch

    from geodiffuser_tpu_torch.kernels import removal_corr as rc

    g = torch.Generator(device="cuda").manual_seed(rng_seed)
    # (H, K budget, L base rows, Lk keys, D, tied, live rows, path): every
    # path shape with the scene's live rows (scene_live_rows), and the
    # editor's 32^2 self shape with every inpaint base row equal and every
    # background base row equal, so that each live row's two maxima are
    # exact ties across lanes and spans and must take the lowest j
    shapes = [(*sh, False, live[path, math.isqrt(sh[2])], path)
              for path, path_shapes in CORR_SHAPES.items() for sh in path_shapes]
    shapes.insert(3, (8, 256, 1024, 1024, 80, True, live["editor", 32], None))
    fwd_plain = lambda *a: by_chunks(lambda qe, ke, qb, kb: rc.corr_fwd_plain(
        qe, ke, qb, kb, *a[4:]), a[0].shape[0], *a[:4])
    bwd_plain = lambda *a: by_chunks(rc.corr_bwd_plain, a[0].shape[0], *a)
    rec = {"corr_fwd": {"shapes": []}, "corr_bwd": {"shapes": []}}
    for kind, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        for h, kr, l, lk, d, tied, live_rows, path in shapes:
            if kind == "f32" and path not in ("editor", "remover", None):
                continue   # float32 serves the tiny card-vs-CPU edits only
            live_rows = min(live_rows, kr)
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
            rm = (torch.arange(kr, device="cuda") < live_rows).float()
            scale = d ** -0.5
            name = f"{(h, kr, l, lk, d)}{' tied' if tied else ''} live {live_rows}"
            got = rc.corr_fwd_cuda(qe, ke, qb, kb, inp, bg, rm, scale)
            ref = fwd_plain(qe, ke, qb, kb, inp, bg, rm, scale)
            torch.cuda.synchronize()
            # values: float32 sums of the same bf16-rounded probabilities, whose
            # rounding may differ by one step where exp(s - lse) and softmax
            # straddle it; indices: equal except at near-ties, where the
            # kernel's index must attain the plain maximum of its masked columns
            e_p = max(rel_err(got[0][:, :live_rows], ref[0][:, :live_rows]),
                      rel_err(got[1][:, :live_rows], ref[1][:, :live_rows]))
            at_idx = {0: [], 1: []}   # the plain correlation at the kernel's indices, by head
            for hh in range(h):
                pe = rc._probs(qe[hh:hh + 1], ke[hh:hh + 1], scale).float()
                pb = rc._probs(qb[hh:hh + 1], kb[hh:hh + 1], scale).float()
                corr = torch.matmul(pe, pb.transpose(-1, -2))
                for m, col in ((0, inp), (1, bg)):
                    masked = torch.where(col[None, None] > 0.5, corr, rc.MASKED)
                    at_idx[m].append(torch.gather(masked, 2, got[2 + m][hh:hh + 1].long()[..., None])
                                     [..., 0][:, :live_rows])
                del pe, pb, corr, masked
            e_idx = [rel_err(torch.cat(at_idx[m]), ref[m][:, :live_rows]) for m in (0, 1)]
            same = [float((got[n][:, :live_rows] == ref[n][:, :live_rows]).float().mean())
                    for n in (2, 3)]
            dead_ok = all(bool((got[n][:, live_rows:] == v).all())
                          for n, v in ((0, rc.NEG_INF), (1, rc.NEG_INF), (2, 0), (3, 0)))
            tie_ok = not tied or bool((got[2][:, :live_rows] == first_in).all()
                                      and (got[3][:, :live_rows] == first_bg).all())
            log(f"corr_fwd {kind} {name}: "
                f"rel err p {e_p:.2e}, corr at j_in/j_bg {e_idx[0]:.2e}/{e_idx[1]:.2e}, "
                f"j_in/j_bg equal {same[0]:.4f}/{same[1]:.4f}, dead rows ok {dead_ok}"
                + (f", lowest j on ties {tie_ok}" if tied else ""))
            # on planted ties the plain index rests on cuBLAS's rounding of
            # equal rows; the kernel's is held to the lowest j exactly instead
            expect(e_p <= 1e-2 and max(e_idx) <= 1e-2 and (tied or min(same) >= 0.98)
                   and dead_ok and tie_ok, f"corr_fwd {kind} {name}")
            # the LSEs the backward reads: the edit rows' on the live 64-row
            # chunks (bf16 writes 0 on dead chunks), the base rows' (written
            # when any row is live)
            live_ch = min(kr, -(-live_rows // 64) * 64)
            e_lse = max(abs_err(got[4][:, :live_ch], ref[4][:, :live_ch]), abs_err(got[5], ref[5]))
            zero_ok = kind != "bf16" or bool((got[4][:, live_ch:] == 0).all())
            log(f"corr_fwd {kind} {name}: lse_e/lse_b abs err {e_lse:.2e} (tol 1e-3)"
                + (f", lse_e 0 on dead chunks {zero_ok}" if kind == "bf16" else ""))
            expect(e_lse <= 1e-3 and zero_ok, f"corr_fwd {kind} {name}: LSEs")
            # backward from the same residuals (the plain forward's indices
            # and LSEs)
            g_in = torch.where(rm[None] > 0.5, torch.randn(h, kr, device="cuda", generator=g), 0)
            g_bg = torch.where(rm[None] > 0.5, torch.randn(h, kr, device="cuda", generator=g), 0)
            bwd = lambda fn, res, gi=g_in, gb=g_bg, **kw: fn(
                qe, ke, qb, kb, res[2], res[3], gi, gb, rm, res[4], res[5], scale, **kw)
            bgot = bwd(rc.corr_bwd_cuda, ref)
            bref = bwd(bwd_plain, ref)
            # and the chain the edits run, the kernel backward on the kernel
            # forward's indices and LSEs, against the plain backward on the
            # plain forward's; a row whose index differs (a near-tie) gets
            # no cotangent on either side
            gi, gb = (torch.where(got[n] == ref[n], gr, 0) for n, gr in ((2, g_in), (3, g_bg)))
            chain = bwd(rc.corr_bwd_cuda, got, gi, gb)
            chain_ref = bwd(bwd_plain, ref, gi, gb)
            torch.cuda.synchronize()
            errs = [rel_err(x, y) for x, y in zip(bgot, bref)]
            e_chain = [rel_err(x, y) for x, y in zip(chain, chain_ref)]
            log(f"corr_bwd {kind} {name}: rel err d_qe/d_ke "
                f"{errs[0]:.2e} {errs[1]:.2e}, from each forward's own outputs "
                f"{e_chain[0]:.2e} {e_chain[1]:.2e} (tol {TOL[kind]:.1e})")
            expect(max(errs) <= TOL[kind], f"corr_bwd {kind} {name}")
            expect(max(e_chain) <= TOL[kind], f"corr_bwd {kind} {name}: kernel forward's outputs")
            del chain, chain_ref
            if kind != "bf16" or path is None:
                continue
            ms = device_ms(lambda: rc.corr_fwd_cuda(qe, ke, qb, kb, inp, bg, rm, scale))
            plain = device_ms(lambda: fwd_plain(qe, ke, qb, kb, inp, bg, rm, scale), 1)
            nb = 2 * (live_rows * d + 2 * lk * d + l * d) * h + 8 * l + 4 * kr + 16 * h * kr
            ops = 2 * h * (live_rows + l) * lk * d + 2 * h * live_rows * l * lk
            rec["corr_fwd"]["shapes"].append(dict(
                shape=[h, kr, l, lk, d], path=path, live_rows=live_rows, ms=ms, plain_ms=plain,
                library_ms=None, bound=bound_ms(nb, ops, kind),
                max_abs_err=max(abs_err(got[0][:, :live_rows], ref[0][:, :live_rows]),
                                abs_err(got[1][:, :live_rows], ref[1][:, :live_rows]))))
            b_ms = device_ms(lambda: bwd(rc.corr_bwd_cuda, ref))
            # the remover's keys are its detached base keys: no d_ke on its path
            b_path = b_ms if path.startswith("editor") else device_ms(
                lambda: bwd(rc.corr_bwd_cuda, ref, need_dke=False))
            b_plain = device_ms(lambda: bwd(bwd_plain, ref), 1)
            nb = 2 * h * d * (3 * live_rows + 2 * lk) + 8 * h * live_rows + 4 * kr \
                + 4 * h * d * (live_rows + lk)
            rec["corr_bwd"]["shapes"].append(dict(
                shape=[h, kr, l, lk, d], path=path, live_rows=live_rows, ms=b_ms,
                path_ms=b_path, plain_ms=b_plain, library_ms=None,
                bound=bound_ms(nb, 10 * h * live_rows * lk * d, kind),
                max_abs_err=max(abs_err(x, y) for x, y in zip(bgot, bref))))
            log(f"corr_fwd bf16 {name} kernels: " + kernel_breakdown(
                lambda: rc.corr_fwd_cuda(qe, ke, qb, kb, inp, bg, rm, scale)))
            log(f"corr_bwd bf16 {name} kernels: " + kernel_breakdown(
                lambda: bwd(rc.corr_bwd_cuda, ref)))
            log(f"corr bf16 {name} ({path}): fwd {ms:.4f} ms (plain {plain:.4f}, bound "
                f"{rec['corr_fwd']['shapes'][-1]['bound'][0]:.4f}), bwd {b_ms:.4f} ms "
                f"(path {b_path:.4f}, plain {b_plain:.4f}, bound "
                f"{rec['corr_bwd']['shapes'][-1]['bound'][0]:.4f})")
    timed = {tuple(sh["shape"]) for sh in rec["corr_fwd"]["shapes"]}
    expect(timed == {sh for shapes in CORR_SHAPES.values() for sh in shapes},
           f"corr: timed shapes {sorted(timed)} are not the paths' shapes")
    for r in rec.values():   # the headline fields: the first (largest 512^2 editor) shape
        r.update({k: v for k, v in r["shapes"][0].items() if k != "max_abs_err"},
                 max_abs_err=max(sh["max_abs_err"] for sh in r["shapes"]), dtype="bf16")
    return rec


def splat_field(rng, h: int, w: int, shift: float):
    """An identity coordinate field (NDC + z) with random shifts and depths."""
    import torch

    from geodiffuser_tpu_torch.ops import camera

    tc = camera.identity_field(h, w).numpy()
    tc[..., 0] += rng.rand(h, w) * 2 * shift - shift
    tc[..., 1] += rng.rand(h, w) * 2 * shift - shift
    tc[..., 2] = rng.rand(h, w)
    return torch.as_tensor(tc, dtype=torch.float32, device="cuda")


def splat_bound(coords, c: int):
    """Bound of one splat: each point's 12 + 4C input bytes read and each
    cell's 4C output bytes written once; 2C + 4 operations on every corner on
    the grid that this field's points reach."""
    import torch

    h, w, _ = coords.shape
    n = h * w
    x = (coords[..., 0] + 1.0) * 0.5 * (w - 1)
    y = (coords[..., 1] + 1.0) * 0.5 * (h - 1)
    fx, fy = torch.floor(x), torch.floor(y)
    corners = sum(int((((fx + ox) >= 0) & ((fx + ox) < w) & ((fy + oy) >= 0)
                       & ((fy + oy) < h)).sum()) for ox in (0, 1) for oy in (0, 1))
    return bound_ms(n * (12 + 4 * c) + n * 4 * c, corners * (2 * c + 4), "f32")


def splat_bins(coords) -> str:
    """The points of a field by base cell (floor x, floor y), on the grid
    padded by one row and column at the low edge: bins used, mean, most."""
    import torch

    h, w, _ = coords.shape
    x = torch.floor((coords[..., 0] + 1.0) * 0.5 * (w - 1))
    y = torch.floor((coords[..., 1] + 1.0) * 0.5 * (h - 1))
    on = (x >= -1) & (x < w) & (y >= -1) & (y < h)
    counts = torch.bincount(((y + 1) * (w + 1) + x + 1)[on].long())
    counts = counts[counts > 0]
    return (f"{counts.numel()} bins, mean {float(counts.float().mean()):.1f}, "
            f"most {int(counts.max())} points")


def time_splat(ks, name: str, field: str, src, coords, radius, tau, z_beta) -> dict:
    """Device time (queued launches) and host-inclusive time of the splat
    kernel as the path calls it, of the plain version, and the bound."""
    run = lambda: ks.splat_fused_cuda(src, coords, radius, tau, z_beta)
    row = dict(field=field, channels=src.shape[-1], ms=device_ms(run, 50),
               host_ms=time_ms(run, 50),
               plain_ms=time_ms(lambda: ks.splat_fused_plain(src, coords, radius, tau, z_beta),
                                3))
    row["bound_ms"], row["bound_by"] = splat_bound(coords, src.shape[-1])
    log(f"splat_fused {name}: {row['ms']:.4f} ms device ({row['host_ms']:.4f} ms with the host's "
        f"calls), plain {row['plain_ms']:.4f}, bound {row['bound_ms']:.5f} ms ({row['bound_by']})")
    return row


def check_splat_case(ks, name: str, src, coords, radius, tau, z_beta, out_hw, least: float,
                     own: bool):
    """One splat case: the kernel within SPLAT_TOL of the plain version,
    reaching more than `least` of the cells, and equal bits in two launches
    (reported, not required, for another checkout's kernels).  Returns the
    kernel's output and its error."""
    import torch

    got = ks.splat_fused_cuda(src, coords, radius, tau, z_beta, out_hw)
    again = ks.splat_fused_cuda(src, coords, radius, tau, z_beta, out_hw)
    ref = ks.splat_fused_plain(src, coords, radius, tau, z_beta, out_hw)
    # the plain version is the yardstick: its sums run in a fixed order, so
    # its own spread between two runs must be 0
    ref2 = ks.splat_fused_plain(src, coords, radius, tau, z_beta, out_hw)
    torch.cuda.synchronize()
    spread = abs_err(ref, ref2)
    err = abs_err(got, ref)
    same = torch.equal(got, again)
    covered = float((ref.abs().sum(-1) > 0).float().mean())
    log(f"splat_fused {name} r={radius} tau={tau}: max abs err {err:.2e} "
        f"(tol {SPLAT_TOL:.0e}; the plain version's spread in two runs {spread:.2e}), "
        f"cells reached {covered:.4f}, two launches equal: {same}, "
        f"two plain runs equal: {torch.equal(ref, ref2)}")
    expect(got.shape == ref.shape and err <= SPLAT_TOL and covered > least, f"splat_fused {name}")
    expect(same or not own, f"splat_fused {name}: two launches differ")
    expect(torch.equal(ref, ref2) or not own, f"splat_fused {name}: two plain runs differ")
    return got, err


def check_splat_channels(ks, name: str, src, coords, radius, tau, z_beta, got, own: bool):
    """The C=4 call's image and mask channels against C=3 and C=1 calls of
    the kernel: equal bits (reported, not required, for another checkout)."""
    import torch

    img = ks.splat_fused_cuda(src[..., :3].contiguous(), coords, radius, tau, z_beta)
    msk = ks.splat_fused_cuda(src[..., 3:].contiguous(), coords, radius, tau, z_beta)
    same = torch.equal(got[..., :3], img) and torch.equal(got[..., 3:], msk)
    log(f"splat_fused {name}: C=4 equals C=3 and C=1 calls bit for bit: {same}")
    expect(same or not own, f"splat_fused {name}: C=4 differs from C=3 and C=1 calls")


def stitch_splat_input(ks, seed: int, transform: dict):
    """stitch_composite on the scene with `transform`: its composite and
    mask, and the splat calls it made, as (src, coords, (radius, tau,
    z_beta))."""
    from geodiffuser_tpu_torch.config import EditConfig
    from geodiffuser_tpu_torch.core.editor import stitch_composite
    from geodiffuser_tpu_torch.ops import camera

    calls, splat = [], ks.splat_fused
    ks.splat_fused = lambda src, coords, *a: (calls.append((src, coords, a)),
                                              splat(src, coords, *a))[1]
    try:
        image, depth, mask = build_scene(SIZE)
        comp, warped = stitch_composite(EditConfig(edit_type="geometry_stitch"),
                                        stitch_background(seed), image, mask, depth,
                                        camera.compose_transform(**transform))
    finally:
        ks.splat_fused = splat
    return comp, warped, calls


def check_splat(rng_seed: int, own: bool):
    """The fused splat kernel against its plain version, float32, every case
    launched twice and required to give equal bits; the stitch composite run
    twice on the scene, likewise.  Times the kernel at the path's shape (512^2
    C=4, the stitch's one call), at C=3 and C=1 (the image and mask as
    separate calls), on the stitch's own input and on stitches zoomed far
    out (thousands of points a cell), and on the many-points-a-cell cases.
    `own` is False when the kernels are another checkout's (--package-root):
    its determinism is then reported, not required."""
    import torch

    from geodiffuser_tpu_torch.kernels import splat as ks
    from geodiffuser_tpu_torch.ops import camera

    rng = np.random.RandomState(rng_seed)
    s = SIZE
    cases = []   # (name, src, coords, radius, tau, out_hw, least share of cells reached)
    for c in (4, 3, 1):   # the stitch's call (image and mask), and each as a call of its own
        cases.append((f"{s}^2 C{c}", rng.rand(s, s, c), splat_field(rng, s, s, 0.05), 1.3, 1.0,
                      None, 0.5))
    cases.append(("ragged 333x517 -> 170x259 C3", rng.rand(333, 517, 3),
                  splat_field(rng, 333, 517, 0.05), 1.3, 1.0, (170, 259), 0.5))
    # identity: every point lands on an exact or near-integer pixel (the
    # NDC -> pixel roundtrip), where the corners hinge on the float32 floor
    ident = camera.identity_field(s, s, device="cuda")
    cases.append((f"{s}^2 identity C3", rng.rand(s, s, 3), ident, 1.3, 1.0, None, 0.5))
    jitter = torch.as_tensor(rng.choice([-1e-7, 0.0, 1e-7], size=(s, s, 1)), dtype=torch.float32,
                             device="cuda")
    near = ident + torch.cat([jitter, jitter, torch.zeros_like(jitter)], dim=-1)
    cases.append((f"{s}^2 near-integer C1", rng.rand(s, s, 1), near, 1.0, 0.5, None, 0.5))
    # two sources collapse onto one cell: the nearer (smaller z) must win
    collapse = camera.identity_field(64, 64, device="cuda")
    collapse[10, 21, :2] = collapse[10, 20, :2]
    collapse[..., 2] = 1.0
    collapse[10, 21, 2] = 0.1
    cases.append(("collapse 64^2 C3", rng.rand(64, 64, 3), collapse, 1.0, 1.0, None, 0.5))
    # a shrink about the centre: about 16 points a cell on a sixteenth of the grid
    shrink = splat_field(rng, s, s, 0.002)
    shrink[..., :2] *= 0.25
    shrink_name = f"{s}^2 shrink x0.25 C4"
    cases.append((shrink_name, rng.rand(s, s, 4), shrink, 1.3, 1.0, None, 0.05))
    # 64 x 64 = 4096 points collapsed onto one cell, the rest jittered identity
    pile = splat_field(rng, s, s, 0.002)
    pile[100:164, 200:264, :2] = pile[300, 300, :2]
    pile_name = "collapse of 4096 points onto one cell C4"
    cases.append((pile_name, rng.rand(s, s, 4), pile, 1.3, 1.0, None, 0.5))
    rec, errs, timed, case_ms = {}, [], [], {}
    for name, src, coords, radius, tau, out_hw, least in cases:
        src = torch.as_tensor(src, dtype=torch.float32, device="cuda")
        got, err = check_splat_case(ks, name, src, coords, radius, tau, 20.0, out_hw, least, own)
        errs.append(err)
        if name.startswith("collapse 64"):
            e_near = abs_err(got[10, 20], src[10, 21])
            log(f"splat_fused {name}: nearer source at the shared cell, abs err {e_near:.2e}")
            expect(e_near <= 2e-4, "splat_fused: the nearer source must win")
        if name == f"{s}^2 C4":
            check_splat_channels(ks, name, src, coords, radius, tau, 20.0, got, own)
            log(f"splat_fused {name}: profiler: " + kernel_breakdown(
                lambda: ks.splat_fused_cuda(src, coords, radius, tau, 20.0)))
        if name in (f"{s}^2 C{c}" for c in (4, 3, 1)):
            timed.append(time_splat(ks, name, "jittered identity", src, coords, radius, tau, 20.0))
        if name in (shrink_name, pile_name):
            case_ms[name] = device_ms(lambda: ks.splat_fused_cuda(src, coords, radius, tau, 20.0),
                                      20)
            log(f"splat_fused {name}: {case_ms[name]:.4f} ms device")
    # the stitch composite twice on the scene: equal composites and masks,
    # and one splat call each
    (comp, warped, calls), (comp2, warped2, calls2) = (
        stitch_splat_input(ks, rng_seed, STITCH_TRANSFORM) for _ in range(2))
    same = np.array_equal(comp, comp2) and np.array_equal(warped, warped2)
    log(f"stitch_composite on the {s}^2 scene twice: composites and masks equal: {same}; "
        f"splat calls {[tuple(c[0].shape) for c in calls + calls2]}")
    expect(same or not own, "stitch_composite: two runs differ")
    expect(len(calls) == 1 or not own, "stitch_composite: one splat call a composite")
    # the stitch's own splat input (the image and mask, C=4, on the scene's
    # transform field, whichever calls the package makes of it), and the
    # same stitch zoomed far out: the scene's points on a few hundred cells
    # (x0.05) or a few dozen (x0.01)
    inputs = [("stitch scene", calls)]
    for zoom in STITCH_ZOOMS:
        inputs.append((f"stitch zoom x{zoom}", stitch_splat_input(
            ks, rng_seed, dict(STITCH_TRANSFORM, sx=zoom, sy=zoom, sz=zoom))[2]))
    for field, made in inputs:
        src = torch.cat([c[0] for c in made], dim=-1).float().contiguous()
        coords = made[0][1].contiguous()
        radius, tau, z_beta = made[0][2]
        name = f"{field} {s}^2 C{src.shape[-1]}"
        log(f"splat_fused {name}: points by base cell: {splat_bins(coords)}")
        got, err = check_splat_case(ks, name, src, coords, radius, tau, z_beta, None, 0.0, own)
        errs.append(err)
        if field == "stitch scene":
            check_splat_channels(ks, name, src, coords, radius, tau, z_beta, got, own)
        timed.append(time_splat(ks, name, field, src, coords, radius, tau, z_beta))
    path = timed[0]
    rec["splat_fused"] = dict(ms=path["ms"], plain_ms=path["plain_ms"], library_ms=None,
                              bound=(path["bound_ms"], path["bound_by"]), max_abs_err=max(errs),
                              shape=[s, s, path["channels"]], dtype="f32", timed_inputs=timed,
                              case_ms=case_ms)
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


def stitch_background(seed: int) -> np.ndarray:
    return (np.random.RandomState(seed + 1).rand(SIZE, SIZE, 3) * 255).astype(np.uint8)


EDITOR_TRANSFORM = dict(tx=0.08, ry=15.0)
STITCH_TRANSFORM = dict(tx=0.1)
# scales of the stitch zoomed far out (splat cases)
STITCH_ZOOMS = (0.05, 0.01)
LARGE = 1024                     # image side of the large editor and remover edits
# kernels each path must launch; the stitch composite's one splat exactly.
# "options": the 512^2 editor with every run option on (null-text, the
# fast-start inner loop, the attention constraints, the inversion cached in
# an experiment folder), whose constrained self layers take the explicit
# removal loss and its cross layers the kernel
FOUR = {"flash_fwd": None, "flash_bwd": None, "corr_fwd": None, "corr_bwd": None}
PATH_KERNELS = {"editor": FOUR, "remover": FOUR, "stitch": dict(FOUR, splat_fused=1),
                "options": FOUR, "editor1024": FOUR, "remover1024": FOUR}
# the options edit: 4 steps, whose one optimize step (i = 2: i >= 0.2 n,
# i < 0.65 n) is the fast start's, with two inner iterations
OPTIONS_CFG = dict(num_ddim_steps=4, fast_start_steps=0.2, num_first_optim_steps=2,
                   apply_attention_constraints=True)


def launch_counts():
    from geodiffuser_tpu_torch.kernels import flash_attention as fa
    from geodiffuser_tpu_torch.kernels import removal_corr as rc
    from geodiffuser_tpu_torch.kernels import splat as ks

    return fa.LAUNCHES, rc.LAUNCHES, ks.LAUNCHES


def path_edit(args, pipe, path: str):
    """The edit of `path` through the API a user calls, as a callable."""
    from geodiffuser_tpu_torch.config import EditConfig
    from geodiffuser_tpu_torch.core.editor import EditSession, perform_stitch
    from geodiffuser_tpu_torch.ops import camera

    size = pipe.image_size
    steps = args.steps if size == SIZE else args.large_steps
    image, depth, mask = build_scene(size)
    if path.startswith("editor"):
        sess = EditSession(pipe, EditConfig(num_ddim_steps=steps, cache_inversion=False))
        return lambda: sess.run(image, depth, mask, camera.compose_transform(**EDITOR_TRANSFORM))
    if path.startswith("remover"):
        cfg = EditConfig(edit_type="geometry_remover", num_ddim_steps=steps,
                         cache_inversion=False)
        sess = EditSession(pipe, cfg)
        return lambda: sess.run(image, depth, mask, np.eye(4))
    cfg = EditConfig(edit_type="geometry_stitch", num_ddim_steps=steps, cache_inversion=False)
    return lambda: perform_stitch(pipe, stitch_background(args.seed), image, mask, depth,
                                  camera.compose_transform(**STITCH_TRANSFORM), cfg=cfg)


def run_path(args, pipe, path: str, go=None, steps=None):
    """Run `go` (by default the edit of `path`, at the steps of its size)
    with every launch count set to 0 just before and read just after; check
    its result.  Returns (launches, launches by shape, result)."""
    import torch

    from geodiffuser_tpu_torch.kernels import flash_attention as fa
    from geodiffuser_tpu_torch.kernels import removal_corr as rc

    go = go or path_edit(args, pipe, path)
    size = pipe.image_size
    for counts in launch_counts():
        counts.update(dict.fromkeys(counts, 0))
    fa.SHAPES.clear()
    rc.SHAPES.clear()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            res = go()
            torch.cuda.synchronize()
        report_profile(path, prof, res.timings["total"])
    else:
        res = go()
    torch.cuda.synchronize()
    launches = {k: v for counts in launch_counts() for k, v in counts.items()}
    shapes = {**fa.SHAPES, **rc.SHAPES}
    steps = steps or (args.steps if size == SIZE else args.large_steps)
    log(f"{path} ({size}^2, {steps} DDIM steps): timings "
        f"{json.dumps({k: round(v, 3) for k, v in res.timings.items()})}")
    log(f"{path}: max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"{path}: kernel launches {launches}")
    log(f"{path}: flash and corr launches by shape {shape_counts(shapes)}")
    for i, logs in sorted(res.loss_log.items()):
        log(f"{path}: step {i} loss total {logs['total']:.4f} self/removal "
            f"{logs['self/removal']:.4f} self/sim {logs['self/sim']:.4f}")
    expect(res.images.shape == (2, size, size, 3), f"{path}: image shape")
    expect(res.edited_image.shape == (size, size, 3), f"{path}: edited image shape")
    expect(bool(torch.isfinite(res.latents).all()), f"{path}: final latents finite")
    expect(len(res.loss_log) >= 1 and all(math.isfinite(v) for lg in res.loss_log.values()
                                          for v in lg.values()), f"{path}: loss logs finite")
    for name, want in PATH_KERNELS[path].items():
        ok = launches[name] > 0 if want is None else launches[name] == want
        expect(ok, f"{path}: kernel {name} launched {launches[name]} times on the main path")
    return launches, shapes, res


def count_ddim_inversions(box: list):
    """Patch `inversion.ddim_invert` to count its calls into `box`; returns
    the function that undoes the patch."""
    from geodiffuser_tpu_torch.core import inversion

    invert = inversion.ddim_invert
    inversion.ddim_invert = lambda *a, **kw: (box.append(1), invert(*a, **kw))[1]
    return lambda: setattr(inversion, "ddim_invert", invert)


def run_options(args, pipe):
    """The 512^2 editor with every run option on, twice, each run in a new
    session sharing one experiment folder: the first inverts and writes
    the inversion there, the second must read it from the disk (no DDIM
    inversion).  Returns the first run's (launches, launches by shape)."""
    import torch

    from geodiffuser_tpu_torch.config import EditConfig
    from geodiffuser_tpu_torch.core.editor import EditSession
    from geodiffuser_tpu_torch.ops import camera
    from geodiffuser_tpu_torch.utils import exp_io

    image, depth, mask = build_scene(SIZE)
    cfg = EditConfig(**OPTIONS_CFG)
    inverted = []
    undo = count_ddim_inversions(inverted)
    try:
        with tempfile.TemporaryDirectory() as folder:
            runs = []
            for n in (1, 2):
                sess = EditSession(pipe, cfg)
                go = lambda: sess.run(image, depth, mask,
                                      camera.compose_transform(**EDITOR_TRANSFORM),
                                      use_null_text=True, exp_folder=folder)
                runs.append(run_path(args, pipe, "options", go, cfg.num_ddim_steps))
                cached = os.path.exists(os.path.join(folder, exp_io.INVERSION_CACHE_FILE))
                log(f"options run {n}: DDIM inversions so far {len(inverted)}, inversion file "
                    f"in the experiment folder: {cached}")
                expect(cached and len(inverted) == 1,
                       f"options run {n}: the inversion is inverted once and read from the disk")
    finally:
        undo()
    (l1, s1, r1), (_, _, r2) = runs
    log(f"options: loss logs {sorted(r1.loss_log)}, inversion s {r1.timings['inversion']:.3f} "
        f"then {r2.timings['inversion']:.3f} (read from the disk), final latents of the two "
        f"runs rel diff {rel_err(r2.latents, r1.latents):.2e}")
    expect(len(r1.loss_log) == 1, "options: one optimize step (the fast start's)")
    del runs
    torch.cuda.empty_cache()
    return l1, s1


def run_reconstruct(args, pipe) -> dict:
    """The scene inverted (CFG DDIM, the editor's guidance) and sampled back
    with `reconstruct`: the round trip's latent error."""
    import torch

    from geodiffuser_tpu_torch.config import EditConfig
    from geodiffuser_tpu_torch.core import inversion

    cfg = EditConfig()
    image, _, _ = build_scene(SIZE)
    t0 = time.time()
    latent0 = pipe.encode_image(torch.as_tensor(image.astype(np.float32) / 255.0, device="cuda"))
    ctx_c, ctx_u = pipe.encode_text(["a thing"]), pipe.encode_text([cfg.uncond_text])
    all_latents, _ = inversion.ddim_invert(pipe, latent0, ctx_u, ctx_c, cfg.guidance_scale,
                                           args.steps)
    back = inversion.reconstruct(pipe, all_latents[-1], ctx_u, ctx_c, cfg.guidance_scale,
                                 args.steps)
    torch.cuda.synchronize()
    out = dict(steps=args.steps, guidance=cfg.guidance_scale, seconds=time.time() - t0,
               latent_rel_err=rel_err(back, latent0), latent_abs_err=abs_err(back, latent0))
    log(f"reconstruct ({SIZE}^2, {args.steps} steps, guidance {cfg.guidance_scale}): "
        f"latent rel err {out['latent_rel_err']:.3e}, abs {out['latent_abs_err']:.3e}, "
        f"{out['seconds']:.2f} s")
    expect(back.shape == latent0.shape and bool(torch.isfinite(back).all()), "reconstruct")
    return out


def report_profile(path: str, prof, wall_s: float) -> None:
    """Device time by kernel name and the device's busy share of the edit."""
    import torch

    # device-side events only: a CPU op's row repeats the time of the
    # kernels it launched
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    log(f"profile {path}: device kernel time {busy_ms:.1f} ms of {wall_s * 1e3:.1f} ms wall "
        f"({100 * busy_ms / (wall_s * 1e3):.1f}%)")
    # the 20 largest, then every other kernel of the port's own
    own = ("flash_", "corr_", "sweep_kernel", "bwd_", "row_lse", "splat")
    for rank, (name, ms, n) in enumerate(rows):
        if rank < 20 or any(k in name for k in own):
            log(f"profile {path}: {ms:10.1f} ms {100 * ms / busy_ms:5.1f}% {n:6d}x {name[:90]}")


def scene_live_rows(size: int, mode: str) -> dict:
    """Live removal-loss rows of the scene in `mode` at the two loss
    resolutions, {64: n, 32: n} at 512^2 (what the corr kernels' work
    depends on)."""
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
    transform = camera.compose_transform(**EDITOR_TRANSFORM) if mode == "editor" else np.eye(4)
    tf = tf_ops.build_transform_field(
        torch.as_tensor(image.astype(np.float32) / 255.0, **f32), torch.as_tensor(depth, **f32),
        mask_t, torch.as_tensor(transform, **f32))
    amodal = image_ops.erode(tf.amodal_mask, cfg.amodal_erode)
    ls = size // 8
    masks = edit_state.build_mask_sets(mask_t, tf.coords, amodal, resolutions=(ls, ls // 2),
                                       mode=mode, dilate_remover=cfg.mask_dilate_remover)
    return {r: int(masks[r].inpaint_row_mask.sum().item()) for r in (ls, ls // 2)}


# ---------------------------------------------------------------------------
# The batch driver
# ---------------------------------------------------------------------------

# largest uint8 difference allowed between the sweep's editor result and a
# direct EditSession.run of the same folder (see run_driver)
DRIVER_EDIT_LEVELS = 0
# the words of the toy tokenizer's merges (every other word falls to bytes)
TOY_WORDS = ("a", "photo", "of", "the", "cat", "on", "mat")


def write_safetensors(path: str, tensors: dict) -> int:
    """CPU tensors (float16 or int64) as a .safetensors file: an 8-byte
    little-endian header length, the JSON header (padded to 8 bytes), the
    raw little-endian data.  Returns the bytes written."""
    import torch

    codes = {torch.float16: "F16", torch.int64: "I64"}
    header, offset = {}, 0
    for name in sorted(tensors):
        t = tensors[name]
        n = t.numel() * t.element_size()
        header[name] = {"dtype": codes[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)) + raw)
        for name in sorted(tensors):
            f.write(tensors[name].contiguous().numpy().data)
    return 8 + len(raw) + offset


def safetensors_shapes(path: str) -> dict:
    """{name: shape} from a .safetensors file's header."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    return {k: tuple(v["shape"]) for k, v in header.items() if k != "__metadata__"}


def write_toy_tokenizer(root: str) -> None:
    """tokenizer/vocab.json and merges.txt: every byte symbol with and
    without `</w>`, the merges that build TOY_WORDS, the special tokens."""
    from geodiffuser_tpu_torch.models.tokenizer import _bytes_to_unicode

    byte_chars = list(_bytes_to_unicode().values())
    vocab, merges = byte_chars + [c + "</w>" for c in byte_chars], []
    for word in TOY_WORDS:
        syms = list(word[:-1]) + [word[-1] + "</w>"]
        while len(syms) > 1:
            merges.append(f"{syms[0]} {syms[1]}")
            syms = [syms[0] + syms[1]] + syms[2:]
            vocab.append(syms[0])
    vocab = list(dict.fromkeys(vocab)) + ["<|startoftext|>", "<|endoftext|>"]
    os.makedirs(os.path.join(root, "tokenizer"))
    with open(os.path.join(root, "tokenizer", "vocab.json"), "w") as f:
        json.dump({t: i for i, t in enumerate(vocab)}, f)
    with open(os.path.join(root, "tokenizer", "merges.txt"), "w") as f:
        f.write("#version: 0.2\n" + "\n".join(dict.fromkeys(merges)) + "\n")


def write_checkpoint(pipe, root: str):
    """The pipeline's weights as fp16 safetensors in the diffusers layout
    (the text encoder's file with the published `position_ids` buffer),
    each file's keys and shapes held against the copied manifest less its
    `unconsumed` keys, and the toy tokenizer.  Returns (the fp16 sources by
    component, bytes written)."""
    import torch

    from geodiffuser_tpu_torch.models import weights

    sources, total = {}, 0
    for name, module in pipe.modules().items():
        rel, manifest = weights.COMPONENTS[name]
        sources[name] = {k: v.detach().to("cpu", torch.float16)
                         for k, v in module.state_dict().items()}
        tensors = dict(sources[name])
        if name == "text":
            tensors["text_model.embeddings.position_ids"] = torch.arange(
                pipe.config.text_max_length)[None]
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path))
        total += write_safetensors(path, tensors)
        with open(weights.MANIFESTS / manifest) as f:
            m = json.load(f)
        drop = set(m["unconsumed"])
        got = {k: s for k, s in safetensors_shapes(path).items() if k not in drop}
        expect(got == {k: tuple(s) for k, s in m["keys"].items() if k not in drop},
               f"driver: {rel} keys and shapes against {manifest}")
    write_toy_tokenizer(root)
    return sources, total


def run_driver(args, pipe, card: str):
    """The batch driver at full width, 512^2, bf16: the random pipeline
    written as an fp16 diffusers checkpoint and loaded back with
    `Pipeline.create(checkpoint_dir=...)` (every tensor bit-equal to its
    fp16 source cast to bf16, the BPE tokenizer), then
    `run_folder_sweep(use_native=True)` over an editor, a remover and a
    stitch folder at --steps, with every launch count set to 0 just before
    and read just after; a second sweep skips all three, a third
    (skip_existing=False) reads every inversion from its folder.  The
    editor folder's result is held against a direct EditSession.run of the
    same inputs, run twice.  Returns (launches, launches by shape)."""
    import torch

    from geodiffuser_tpu_torch.config import ModelConfig
    from geodiffuser_tpu_torch.core.editor import EditSession
    from geodiffuser_tpu_torch.core.pipeline import Pipeline
    from geodiffuser_tpu_torch.kernels import flash_attention as fa
    from geodiffuser_tpu_torch.kernels import removal_corr as rc
    from geodiffuser_tpu_torch.models.tokenizer import CLIPTokenizer
    from geodiffuser_tpu_torch.ops import camera
    from geodiffuser_tpu_torch.parallel import driver
    from geodiffuser_tpu_torch.utils import exp_io, png

    with tempfile.TemporaryDirectory() as tmp:
        ckpt, root = os.path.join(tmp, "sd14"), os.path.join(tmp, "exps")
        t0 = time.time()
        sources, n_bytes = write_checkpoint(pipe, ckpt)
        write_s = time.time() - t0
        t0 = time.time()
        loaded = Pipeline.create(ModelConfig(), image_size=SIZE, checkpoint_dir=ckpt,
                                 seed=args.seed + 1, device="cuda")
        torch.cuda.synchronize()
        load_s = time.time() - t0
        unequal = [(name, k) for name, module in loaded.modules().items()
                   for k, v in module.state_dict().items()
                   if not torch.equal(v.view(torch.int16), sources[name][k].to(
                       "cuda", torch.bfloat16).view(torch.int16))]
        n_tensors = sum(len(s) for s in sources.values())
        del sources
        emb = loaded.encode_text(["a photo of the cat on the mat"])
        log(f"driver checkpoint: {n_bytes} bytes of fp16 safetensors written in {write_s:.2f} s, "
            f"loaded by Pipeline.create(checkpoint_dir=...) in {load_s:.2f} s; {n_tensors} "
            f"tensors, {len(unequal)} not bit-equal to the fp16 source cast to bf16 {unequal[:4]}; "
            f"tokenizer {type(loaded.tokenizer).__name__}, encode_text {tuple(emb.shape)}")
        expect(not unequal, "driver: loaded weights bit-equal to the fp16 sources cast to bf16")
        expect(isinstance(loaded.tokenizer, CLIPTokenizer) and bool(torch.isfinite(emb).all()),
               "driver: the checkpoint's BPE tokenizer and a finite text encoding")

        image, depth, mask = build_scene(SIZE)
        folders = {"editor": os.path.join(root, "Translation_3D", "0"),
                   "remover": os.path.join(root, "Removal", "0"),
                   "stitch": os.path.join(root, "stitch", "0")}
        exp_io.save_exp(folders["editor"], image, depth, mask,
                        camera.compose_transform(**EDITOR_TRANSFORM))
        exp_io.save_exp(folders["remover"], image, depth, mask, np.eye(4))
        exp_io.save_exp(folders["stitch"], image, depth, mask,
                        camera.compose_transform(**STITCH_TRANSFORM),
                        background_image=stitch_background(args.seed))
        overrides = dict(num_ddim_steps=args.steps)
        sweep = lambda **kw: driver.run_folder_sweep(root, pipe=loaded, config_overrides=overrides,
                                                     use_native=True, **kw)

        for counts in launch_counts():
            counts.update(dict.fromkeys(counts, 0))
        fa.SHAPES.clear()
        rc.SHAPES.clear()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        first = sweep()
        torch.cuda.synchronize()
        sweep_s = time.time() - t0
        launches = {k: v for counts in launch_counts() for k, v in counts.items()}
        shapes = {**fa.SHAPES, **rc.SHAPES}
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"driver sweep ({SIZE}^2, {args.steps} DDIM steps, native prefetcher): "
            f"{sweep_s:.2f} s, edits (s) "
            f"{json.dumps({k: round(first.get(f, -1.0), 3) for k, f in folders.items()})}, "
            f"max_memory_allocated {peak:.2f} GiB; {card}")
        log(f"driver: kernel launches {launches}")
        log(f"driver: flash and corr launches by shape {shape_counts(shapes)}")
        expect(set(first) == set(folders.values()), f"driver: swept {sorted(first)}")
        for name in ("flash_fwd", "flash_bwd", "corr_fwd", "corr_bwd"):
            expect(launches[name] > 0, f"driver: kernel {name} launched {launches[name]} times")
        expect(launches["splat_fused"] == 1, "driver: one splat, the stitch's pre-composite")
        results = {}
        for kind, folder in folders.items():
            results[kind] = png.read_png(os.path.join(folder, "result_ls.png"))
            with open(os.path.join(folder, "loss_log.json")) as f:
                losses = [v for lg in json.load(f).values() for v in lg.values()]
            expect(results[kind].shape == (SIZE, SIZE, 3) and results[kind].std() > 0
                   and losses and all(math.isfinite(v) for v in losses),
                   f"driver: {kind} result_ls.png and a finite loss_log.json")

        again = sweep()
        inverted = []
        undo = count_ddim_inversions(inverted)
        try:
            third = sweep(skip_existing=False)
        finally:
            undo()
        rerun_diff = max(int(np.abs(png.read_png(os.path.join(f, "result_ls.png")).astype(int)
                                    - results[k].astype(int)).max()) for k, f in folders.items())
        log(f"driver: second sweep {again}; third (skip_existing=False) edits (s) "
            f"{json.dumps({k: round(third.get(f, -1.0), 3) for k, f in folders.items()})}, "
            f"DDIM inversions {len(inverted)} (every trajectory read from the folder's "
            f"{exp_io.INVERSION_CACHE_FILE}), results' max difference from the first sweep "
            f"{rerun_diff} levels")
        expect(again == {}, "driver: the second sweep skips all three folders")
        expect(set(third) == set(folders.values()) and not inverted,
               "driver: the third sweep reads every inversion from the cache")

        exp = exp_io.read_exp(folders["editor"])
        cfg = dataclasses.replace(driver.config_for_edit_type("geometry_editor"), **overrides)
        direct = [EditSession(loaded, cfg).run(exp.input_image, exp.depth, exp.input_mask,
                                               exp.transform).edited_image for _ in range(2)]
        d_sweep = int(np.abs(direct[0].astype(int) - results["editor"].astype(int)).max())
        d_self = int(np.abs(direct[0].astype(int) - direct[1].astype(int)).max())
        log(f"driver: editor folder's result vs a direct EditSession.run: max {d_sweep} uint8 "
            f"levels (bound {DRIVER_EDIT_LEVELS}); two direct runs differ by {d_self}")
        expect(d_sweep <= DRIVER_EDIT_LEVELS, "driver: the sweep's editor result")
        del loaded

        # the command line a user runs, in a process of its own: the first
        # folder again (Removal sorts first), its weights from the checkpoint
        pkg_root = str(pathlib.Path(driver.__file__).resolve().parents[2])
        cmd = [sys.executable, "-m", "geodiffuser_tpu_torch.parallel.driver", root,
               "--checkpoint-dir", ckpt, "--steps", str(args.steps), "--size", str(SIZE),
               "--no-skip-existing", "--limit", "1"]
        t0 = time.time()
        cli = subprocess.run(cmd, capture_output=True, text=True, timeout=600, cwd=pkg_root,
                             env=dict(os.environ, PYTHONPATH=pkg_root))
        out = cli.stdout.strip().splitlines()
        log(f"driver command line (python -m geodiffuser_tpu_torch.parallel.driver ... "
            f"--checkpoint-dir ... --limit 1): exit {cli.returncode} in {time.time() - t0:.1f} s, "
            f"{out[-1] if out else cli.stderr[-2000:]}")
        expect(cli.returncode == 0 and out and json.loads(out[-1])["edits"] == 1,
               "driver: the command line sweeps one folder")
    torch.cuda.empty_cache()
    return launches, shapes


def small_reference(edit_type: str):
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
    sched = dict(num_ddim_steps=4, optimize_steps=0.65, skip_optim_steps=2, lr=0.0)
    if edit_type == "geometry_remover":   # tests/test_editor.py:85-92
        cfg = EditConfig(edit_type=edit_type, obj_edit_step=0.5, **sched)
        transform = np.eye(4)
    else:
        cfg = EditConfig(latent_replace=0.3, **sched)
        transform = camera.compose_transform(tx=0.05)
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
        out[dev] = EditSession(pipe, cfg, device=dev).run(image, depth, mask, transform,
                                                          prompt="a thing")
    a, b = out["cuda"], out["cpu"]
    e_lat = rel_err(a.latents.cpu(), b.latents)
    e_log = max(abs(a.loss_log[i][k] - b.loss_log[i][k]) / max(abs(b.loss_log[i][k]), 1e-3)
                for i in b.loss_log for k in b.loss_log[i] if "removal" not in k)
    e_img = int(np.abs(a.images.astype(int) - b.images.astype(int)).max())
    # histogram matching maps a level through the template's CDF, so one
    # pixel crossing a rounding boundary can move a whole level of the
    # lookup by several steps: the edited image is held by its mean
    d_edit = np.abs(a.edited_image.astype(int) - b.edited_image.astype(int))
    log(f"small reference {edit_type} (tiny fp32, 128^2, card vs CPU): latents rel err "
        f"{e_lat:.2e}, loss logs rel err {e_log:.2e} (removal excluded: near-tied argmax), "
        f"image max diff {e_img}, edited image diff max {d_edit.max()} mean {d_edit.mean():.4f}")
    expect(set(a.loss_log) == set(b.loss_log) and e_lat <= 1e-3 and e_log <= 1e-3
           and e_img <= 2 and d_edit.mean() <= 0.5, f"small reference {edit_type}")


SOURCES = {   # kernel: (CUDA source, the TPU kernel's pallas_call it replaces)
    "flash_fwd": ("geodiffuser_tpu_torch/csrc/flash_attention.cu",
                  "geodiffuser_tpu/kernels/flash_attention.py:98"),
    "flash_bwd": ("geodiffuser_tpu_torch/csrc/flash_attention.cu",
                  "geodiffuser_tpu/kernels/flash_attention.py:234"),
    "corr_fwd": ("geodiffuser_tpu_torch/csrc/removal_corr.cu",
                 "geodiffuser_tpu/kernels/removal_corr.py:202"),
    "corr_bwd": ("geodiffuser_tpu_torch/csrc/removal_corr.cu",
                 "geodiffuser_tpu/kernels/removal_corr.py:462"),
    "splat_fused": ("geodiffuser_tpu_torch/csrc/splat.cu",
                    "geodiffuser_tpu/kernels/splat.py:167"),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=6,
                    help="DDIM steps of each 512^2 edit (50 = default edit)")
    ap.add_argument("--large-steps", type=int, default=2,
                    help="DDIM steps of the 1024^2 editor and remover edits (step 0 optimizes)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="trace each edit with torch.profiler and print device time by kernel")
    ap.add_argument("--only", default=None,
                    help="check and time only these kernels: any of flash, corr, splat, "
                         "comma-separated")
    ap.add_argument("--package-root", default=None,
                    help="import geodiffuser_tpu_torch from this directory")
    args = ap.parse_args(argv)
    only = set((args.only or "").split(",")) - {""}
    if not only <= {"flash", "corr", "splat"}:
        ap.error(f"--only takes flash, corr and splat, not {args.only}")
    if args.package_root:
        sys.path.insert(0, os.path.abspath(args.package_root))

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

    from geodiffuser_tpu_torch.config import ModelConfig
    from geodiffuser_tpu_torch.core.pipeline import Pipeline

    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.time()
    _build.lib()
    log(f"kernels built in {time.time() - t0:.1f} s (nvcc {_build.build_seconds:.1f} s)")
    for line in ptxas_lines(_build.ptxas_report()):
        log(f"ptxas {line}")

    rec = {}
    if not only or "flash" in only:
        t0 = time.time()
        rec.update(check_flash(args.seed))
        log(f"flash checks and timings: {time.time() - t0:.1f} s")
    if not only or "corr" in only:
        t0 = time.time()
        live = {(path, r): n for path, (size, mode) in CORR_PATHS.items()
                for r, n in scene_live_rows(size, mode).items()}
        log(f"scene live rows (path, latent side): {live}")
        rec.update(check_corr(args.seed, live))
        log(f"corr checks and timings: {time.time() - t0:.1f} s")
    if not only or "splat" in only:
        t0 = time.time()
        rec.update(check_splat(args.seed, own=args.package_root is None))
        log(f"splat checks and timings: {time.time() - t0:.1f} s")
    if only:
        from geodiffuser_tpu_torch.kernels import flash_attention as fa

        log(f"package: {os.path.dirname(fa.__file__)}")
        log(json.dumps({"kernels": [{"name": n, **{k: v for k, v in r.items() if k != "bound"},
                                     "bound_ms": r["bound"][0], "bound_by": r["bound"][1]}
                                    for n, r in rec.items()]}))
        return finish(card)

    t0 = time.time()
    pipe = Pipeline.create(ModelConfig(), image_size=SIZE, seed=args.seed, device="cuda")
    torch.cuda.synchronize()
    log(f"pipeline: SD-1.4 geometry, bf16, {SIZE}^2, random init seed {args.seed}: "
        f"{time.time() - t0:.1f} s")
    t0 = time.time()
    unet = check_unet_flash(pipe, args.seed)
    log(f"unet phase: {time.time() - t0:.1f} s")
    runs = {path: run_path(args, pipe, path)[:2] for path in ("editor", "remover", "stitch")}
    t0 = time.time()
    runs["options"] = run_options(args, pipe)
    log(f"options phase (two edits): {time.time() - t0:.1f} s")
    recon = run_reconstruct(args, pipe)
    large = dataclasses.replace(pipe, image_size=LARGE)   # the same modules
    for path in ("editor1024", "remover1024"):
        runs[path] = run_path(args, large, path)[:2]
    del large
    t0 = time.time()
    runs["driver"] = run_driver(args, pipe, card)
    log(f"driver phase: {time.time() - t0:.1f} s")
    by_path = {path: launches for path, (launches, _) in runs.items()}
    timed = ({("flash_fwd", *shape) for shape in FLASH_FWD_SHAPES}
             | {("flash_bwd", *shape) for shape in FLASH_BWD_SHAPES}
             | {(name, *sh["shape"]) for name in ("corr_fwd", "corr_bwd")
                for sh in rec[name]["shapes"]})
    untimed = {key for _, shapes in runs.values() for key in shapes} - timed
    expect(not untimed, f"flash or corr shapes launched on a path but not timed: {sorted(untimed)}")
    del pipe
    small_reference("geometry_editor")
    small_reference("geometry_remover")

    kernels = []
    for name, (src, replaces) in SOURCES.items():
        r = rec[name]
        entry = {
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": sum(counts[name] for counts in by_path.values()),
            "launches_by_path": {path: counts[name] for path, counts in by_path.items()},
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1], "library_ms": r["library_ms"],
            "shape": r["shape"], "dtype": r["dtype"],
        }
        if "shapes" in r:   # flash and corr: every timed shape, with its launches on each path
            entry["shapes"] = [dict(
                {k: v for k, v in sh.items() if k != "bound"},
                bound_ms=sh["bound"][0], bound_by=sh["bound"][1],
                launches_by_path={path: shapes.get((name, *sh["shape"]), 0)
                                  for path, (_, shapes) in runs.items()})
                for sh in r["shapes"]]
        if "timed_inputs" in r:   # splat: C=4, C=3, C=1 jittered; the stitch scene and zooms
            entry["timed_inputs"], entry["case_ms"] = r["timed_inputs"], r["case_ms"]
        if "library_backend" in r:
            entry["library_backend"] = r["library_backend"]
        if name == "flash_bwd":
            entry["unet_check"] = unet
            entry["reconstruct"] = recon
        kernels.append(entry)
    log(json.dumps({"kernels": kernels}))
    return finish(card)


def finish(card: str) -> int:
    """The card line and, last, the result line."""
    import torch

    log(f"card: {card}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
