"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--steps N] [--large-steps N] [--seed S] [--profile]
    python3 chip_smoke.py --only flash,corr,splat,group_norm [--package-root DIR]

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
     and C=1 and on the stitch zoomed far out, by device time); flash also
     at the batch paths' shapes (B four times an edit's), the correlation
     with the edit axis (one launch for four edits, masks (E, L) and (E, K),
     each edit its own live rows) against the plain version of each edit
     and against one single-edit launch per edit, timed beside them; the splat's
     every case must give equal bits in two launches and in two runs of its
     plain version, and the stitch composite in two runs; the channels-last
     GroupNorm (+ SiLU) forward and backward in bf16 at DIFT's, an SD UNet
     pass's, an editor CFG step's and the VAE's shapes, on activations whose
     variance lies largely between channels and between pixel tiles (equal
     bits in two launches), timed
     beside ATen's NCHW GroupNorm + SiLU; then, traced by the profiler, one
     SD-1.4 UNet pass with its latent gradient, a VAE encode and decode and
     an SD-2.1 DIFT call replayed (after `check_dift_graph` on a fresh
     featurizer), each without a cuDNN layout transpose or an ATen
     GroupNorm kernel and with one GroupNorm kernel pair a module call;
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
     then the evaluation package ("evaluation"): an SD-2.1 pipeline at full
     geometry (64-wide heads, bf16, random weights from --seed) written as
     an fp16 checkpoint, its keys against the SD-2.1 manifests, loaded back
     bit-equal, one DIFT draw through the flash kernels against one with
     the plain version, the featurizer's 8-draw ensemble as one CUDA graph
     against the eager ensemble (the scene, the edit, the scene again:
     equal bits or `DIFT_TOL`; capture and replay times, the graph pool's
     reserved bytes, `dift.GRAPHS`), `mean_distance_metric` (8 noise
     draws) on the scene against the driver's edited editor folder under
     a CUDA profiler, its launches counted from the trace's kernels (flash
     must run at both D-64 shapes, as often as in two eager ensembles
     counted by the kernel wrappers, and the graph replay once an image),
     and the evaluation CLI
     (`python -m geodiffuser_tpu_torch.evaluation`: --metric md, offline,
     lpips, clip and fid on the driver's three folders and --path_1/--path_2,
     with random AlexNet/LPIPS .pth and CLIP ViT-B/32 weights) in a process
     of its own; then the UI server ("ui"): SAM ViT-H and Depth Anything
     ViT-L at full width in float32 (random weights from --seed, their
     encode, decode and depth times), each other backend of the depth
     dropdown (MiDaS DPT-Large, DPT-Hybrid and its KITTI / NYU variants,
     MiDaS v2.1, ZoeDepth, ZoeDepth-NK) at full width in float32, one at a
     time (parameters, ms a depth map), `ui.serve.make_server` over the
     resident SD-1.4 pipeline on a thread, and over HTTP a user's session:
     state, load_image (PNG), two SAM clicks (equal bits), Depth Anything,
     DPT-Large and ZoeDepth-NK depth, set_mask, load of the driver's editor
     folder, the preview, the
     edit (a depth request answered while it runs) and the inpaint at
     --steps, each with every launch count set to 0 just before and read
     just after, save and load; the served edit and inpaint against direct
     `EditSession.run`s (equal bits); tiny float32 SAM, Depth Anything and
     the five other depth models on the card against the CPU, and one
     `save_params` / `load_params` round trip on the card; then the
     lockstep batch ("batch"): a group of four editor edits (the scene
     moved four ways), four remover edits (its object removed from four
     places) and four stitch edits (pasted four ways) through
     `ShardedEditSession.run_batch`, each with every launch count set to 0
     just before and read just after, each edit against its sequential
     `EditSession.run` from the same inversion (relative RMS of the final
     latents, bound 0.3: bf16 rounding, witnessed by a group of copies of
     one edit; the control, each group edit against the next edit's
     sequential run, beyond it) and each group's flash and correlation
     launches equal to one sequential edit's; seconds per edit and peak of
     editor groups of 1, 2, 4 and 8; `run_folder_sweep(group_size=4)` over
     two remover folders against the sequential sweep; the editor group at
     full width in float32 (2 steps) against its sequential runs (bound
     1e-3, its control beyond it);
  5. runs a tiny float32 editor and remover edit on the card and on the CPU
     (plain versions) and compares them.
`--only` (any of flash, corr, splat, group_norm) runs phases 1 and 2 for
the named kernels alone; with
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
import shutil
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


def rel_rms(a, b) -> float:
    a, b = a.float(), b.float()
    return float(((a - b) ** 2).mean().sqrt() / (b ** 2).mean().sqrt().clamp_min(1e-30))


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


# the evaluation's DIFT featurizer, SD-2.1 at 512^2 with batch 1 a noise
# draw: 64-wide heads, 5 at the 64^2 level (down block 0, up block 3) and 10
# at 32^2 (down block 1, up block 2); the kernels pad D 64 to their 80 variant
DIFT_FLASH_SHAPES = [(5, 4096, 4096, 64), (10, 1024, 1024, 64)]
# edits of a lockstep group on the batch paths (the "batch" phase): every
# call takes the group at once, so its batch is GROUP times an edit's
GROUP = 4


def flash_group_shapes(size: int, group: int):
    """bf16 flash shapes of a lockstep group of `group` edits at a size^2
    image: each of `flash_path_shapes` with B times the group."""
    return tuple([(b * group, lq, lk, d) for b, lq, lk, d in shapes]
                 for shapes in flash_path_shapes(size))


# each checked and timed: the 512^2 paths' shapes, then the 1024^2 paths'
# (128^2 at D 40, 64^2 at D 80, 32^2 at D 160), then the featurizer's, then
# the 512^2 paths' in a group of GROUP edits
FLASH_FWD_SHAPES = (flash_path_shapes(512)[0] + flash_path_shapes(1024)[0]
                    + DIFT_FLASH_SHAPES + flash_group_shapes(512, GROUP)[0])
FLASH_BWD_SHAPES = (flash_path_shapes(512)[1] + flash_path_shapes(1024)[1]
                    + flash_group_shapes(512, GROUP)[1])
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
# GroupNorm
# ---------------------------------------------------------------------------

# (N, C, H, W) of the GroupNorm kernels' check and timing: DIFT's batch-1
# UNet at 64^2 and 16^2; an SD UNet pass at batch 2 at C/G = 20, 30 and 80
# (2560 channels: the bf16 path with two chunks a thread); an editor CFG
# step's 24 streams at 64^2 and at the 32^2 up block's 1920 channels; the
# VAE's levels (C/G = 4, 8, 16) in an encode or decode of one image, and
# its 512^2 level at 16 streams
GN_SHAPES = [(1, 320, 64, 64), (1, 1280, 16, 16), (2, 640, 32, 32), (2, 960, 32, 32),
             (2, 2560, 16, 16), (24, 320, 64, 64), (24, 1920, 32, 32), (1, 128, 512, 512),
             (1, 256, 256, 256), (1, 512, 128, 128), (16, 128, 512, 512)]
# bf16 GroupNorm kernels vs their plain version, relative to the largest
# value of each output: both take float32 statistics (summed in another
# order) and round each output element once to bf16, so an element may
# differ by a bf16 rounding step (2^-8 of its value) where the float32
# results straddle one; dx likewise
GN_TOL = 8e-3
# kernels no channels-last UNet or VAE pass may run: cuDNN's layout
# transposes and ATen's NCHW GroupNorm statistics
GN_FORBIDDEN = r"nchwToNhwc|nhwcToNchw|RowwiseMomentsCUDAKernel"


def gn_activation(shape, g):
    """A channels-last bf16 activation whose groups' variance lies largely
    between their parts, as in a real activation, so that each merge of the
    statistics carries weight: a mean and a scale a channel (the merge of
    channels into groups), a ramp down the image that most channels share
    (tiles, runs of pixels in raster order, differ: the merge of tiles) and
    a stripe across it (neighbouring pixels differ, and a block's threads
    take pixels a stride apart: the merge of a block's rows), around noise
    of a scale a channel."""
    import torch

    n, c, h, w = shape
    randn = lambda *s: torch.randn(*s, device="cuda", generator=g)
    down = torch.linspace(-1.0, 1.0, h, device="cuda").view(1, 1, h, 1)
    across = (1.0 - 2.0 * (torch.arange(w, device="cuda") % 2)).view(1, 1, 1, w)
    x = (randn(1, c, 1, 1) * 1.5 + 0.5 + (randn(1, c, 1, 1) * 0.5 + 2.5) * down
         + (randn(1, c, 1, 1) * 0.3 + 1.0) * across
         + randn(1, c, 1, 1).mul(0.5).exp() * randn(shape))
    return x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)


def gn_variance_shares(x, groups: int, tiles: int, tile: int) -> tuple:
    """Shares of sample 0's first group's variance that lie between its
    channels and between the kernels' tiles."""
    import torch

    c = x.shape[1] // groups
    xg = x[0, :c].float().permute(1, 2, 0).reshape(-1, c)   # (HW, C/G), raster order
    var = float(xg.var(unbiased=False))
    between_c = float(xg.mean(0).var(unbiased=False)) / var
    sums = torch.zeros(tiles, device=x.device).index_add_(
        0, torch.arange(xg.shape[0], device=x.device) // tile, xg.mean(1))
    counts = torch.bincount(torch.arange(xg.shape[0], device=x.device) // tile).float()
    between_t = float((counts * (sums / counts - xg.mean()) ** 2).sum() / counts.sum()) / var
    return between_c, between_t


def check_group_norm(rng_seed: int):
    """The GroupNorm kernels against their plain version at `GN_SHAPES`,
    bf16 channels-last, 32 groups, on `gn_activation`s: forward, and x's
    gradient, with and without the SiLU; two launches must give equal
    bits.  Times the forward and the backward with the SiLU, the ResNets'
    case, beside the plain version, ATen's GroupNorm + SiLU on NCHW
    (`library_ms`, the parent's path) and the bound: the least traffic at
    3.35 TB/s (forward: x read and y written once; backward: x and dy read
    and dx written once).  The kernels' own traffic (x read twice forward,
    x and dy twice backward) is logged beside it as `design_ms`."""
    import torch
    import torch.nn.functional as F

    from geodiffuser_tpu_torch.kernels import group_norm as gn

    g = torch.Generator(device="cuda").manual_seed(rng_seed + 7)
    cl = torch.channels_last
    groups, eps = 32, 1e-5
    rec = {"group_norm_fwd": {"timed_shapes": []}, "group_norm_bwd": {"timed_shapes": []}}
    for shape in GN_SHAPES:
        n, c, h, w = shape
        randn = lambda *s: torch.randn(*s, device="cuda", generator=g)
        x = gn_activation(shape, g)
        dy = randn(shape).to(torch.bfloat16).contiguous(memory_format=cl)
        wt = (randn(c) * 0.2 + 1.0).to(torch.bfloat16)
        bs = (randn(c) * 0.1).to(torch.bfloat16)
        p = gn.plan(n, c, h * w, 2)
        shares = gn_variance_shares(x, groups, p["tiles"], p["tile"])
        for silu in (False, True):
            y, stats = gn.group_norm_fwd_cuda(x, wt, bs, groups, eps, silu)
            again, _ = gn.group_norm_fwd_cuda(x, wt, bs, groups, eps, silu)
            dx = gn.group_norm_bwd_cuda(dy, x, wt, bs, stats, groups, silu)
            twice = gn.group_norm_bwd_cuda(dy, x, wt, bs, stats, groups, silu)
            xl = x.clone().requires_grad_(True)
            y_p = gn.group_norm_plain(xl, wt, bs, groups, eps, silu)
            (ref,) = torch.autograd.grad(y_p, xl, dy)
            torch.cuda.synchronize()
            e_y, e_x = rel_err(y, y_p), rel_err(dx, ref)
            same = torch.equal(y, again) and torch.equal(dx, twice)
            layout = y.is_contiguous(memory_format=cl) and dx.is_contiguous(memory_format=cl)
            log(f"group_norm bf16 {shape} silu={silu}: {p['tiles']} tiles of {p['tile']} pixels, "
                f"group variance {100 * shares[0]:.0f}% between channels, "
                f"{100 * shares[1]:.0f}% between tiles; rel err y {e_y:.2e}, dx {e_x:.2e} "
                f"(tol {GN_TOL:.0e}); y and dx channels-last {layout}; two launches equal "
                f"bits {same}")
            expect(e_y <= GN_TOL and e_x <= GN_TOL and same and layout,
                   f"group_norm {shape} silu={silu}")
            err_f, err_b = abs_err(y, y_p), abs_err(dx, ref)
            del y_p, ref, xl, again, twice, dx
        e = x.numel() * x.element_size()
        ms_f = device_ms(lambda: gn.group_norm_fwd_cuda(x, wt, bs, groups, eps, True))
        ms_b = device_ms(lambda: gn.group_norm_bwd_cuda(dy, x, wt, bs, stats, groups, True))
        xl = x.clone().requires_grad_(True)
        plain_f = device_ms(lambda: gn.group_norm_plain(x, wt, bs, groups, eps, True), 3)
        y_p = gn.group_norm_plain(xl, wt, bs, groups, eps, True)
        plain_b = device_ms(lambda: torch.autograd.grad(y_p, xl, dy, retain_graph=True), 3)
        del y_p
        xn, dyn = x.contiguous(), dy.contiguous()
        lib_f = device_ms(lambda: F.silu(F.group_norm(xn, groups, wt, bs, eps)))
        xnl = xn.clone().requires_grad_(True)
        y_l = F.silu(F.group_norm(xnl, groups, wt, bs, eps))
        lib_b = device_ms(lambda: torch.autograd.grad(y_l, xnl, dyn, retain_graph=True))
        del y_l, xnl, xl, xn, dyn
        for name, ms, plain, lib, least, design, err in (
                ("group_norm_fwd", ms_f, plain_f, lib_f, 2, 3, err_f),
                ("group_norm_bwd", ms_b, plain_b, lib_b, 3, 5, err_b)):
            bound = bound_ms(least * e, 0, "bf16")
            design_ms = bound_ms(design * e, 0, "bf16")[0]
            rec[name]["timed_shapes"].append(dict(
                shape=list(shape), ms=ms, plain_ms=plain, library_ms=lib, bound=bound,
                design_ms=design_ms, max_abs_err=err, tiles=p["tiles"]))
            log(f"{name} bf16 {shape} silu: {ms:.4f} ms, plain {plain:.4f}, ATen NCHW "
                f"{lib:.4f}, bound {bound[0]:.4f} ({least}x the activation), "
                f"{100 * bound[0] / ms:.1f}% of the bound; the kernels' own traffic "
                f"({design}x) {design_ms:.4f}, {100 * design_ms / ms:.1f}%; "
                f"{lib / ms:.2f}x faster than ATen")
        del x, dy, stats
        torch.cuda.empty_cache()
    for name, r in rec.items():
        first = r["timed_shapes"][0]
        r.update({k: v for k, v in first.items() if k not in ("max_abs_err", "design_ms", "tiles")},
                 max_abs_err=max(sh["max_abs_err"] for sh in r["timed_shapes"]), dtype="bf16")
    return rec


def profiled_kernels(fn) -> list:
    """The CUDA kernel events of a profiler trace of `fn()` (graph replays
    included), as `traced_launches` reads them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("cat") == "kernel"]


def norm_calls(models, fn) -> int:
    """GroupNorm module calls of `models` while `fn()` runs eagerly."""
    import torch

    calls, hooks = [], []
    for model in models:
        for m in model.modules():
            if isinstance(m, torch.nn.GroupNorm):
                hooks.append(m.register_forward_pre_hook(lambda *_: calls.append(1)))
    try:
        fn()
    finally:
        for h in hooks:
            h.remove()
    return len(calls)


def check_layout_trace(name: str, kernels: list, norms: int, backward: bool, per: int = 1):
    """A traced pass's kernels: no layout transpose and no ATen GroupNorm
    statistics, one GroupNorm kernel pair a module call (`norms`) forward
    and, with `backward`, backward; logs its device time and costliest
    kernels.  Returns the device time in ms over `per`."""
    import re
    from collections import Counter

    launches = traced_launches(kernels, [])[0]
    forbidden = Counter(e["name"][:90] for e in kernels if re.search(GN_FORBIDDEN, e["name"]))
    busy = Counter()
    for e in kernels:
        busy[e["name"].replace("(anonymous namespace)::", "").split("(")[0][-70:]] += e["dur"]
    total_ms = sum(busy.values()) / 1e3
    log(f"{name}: device time {total_ms / per:.3f} ms (over {per}), {len(kernels)} kernels; "
        f"GroupNorm fwd/bwd launches {launches['group_norm_fwd']}/{launches['group_norm_bwd']} "
        f"for {norms} module calls; transposes and ATen statistics {dict(forbidden)}")
    log(f"{name}: costliest " + "; ".join(f"{us / 1e3 / per:.3f} ms {k}"
                                          for k, us in busy.most_common(8)))
    expect(not forbidden, f"{name}: layout transposes or ATen GroupNorm kernels ran")
    expect(launches["group_norm_fwd"] == norms
           and launches["group_norm_bwd"] == (norms if backward else 0),
           f"{name}: one GroupNorm kernel pair a module call")
    return total_ms / per


def check_group_norm_paths(args) -> dict:
    """The channels-last models on the card, each traced by the profiler
    (`check_layout_trace`): one SD-1.4 UNet pass (batch 2, 64^2 latent)
    with the latent gradient, one VAE encode (512^2) and decode, and one
    SD-2.1 DIFT call replayed, after `check_dift_graph` on a fresh
    featurizer.  Returns device times in ms."""
    import torch

    from geodiffuser_tpu_torch.config import ModelConfig
    from geodiffuser_tpu_torch.core.pipeline import Pipeline
    from geodiffuser_tpu_torch.evaluation import dift

    out = {}
    g = torch.Generator(device="cuda").manual_seed(args.seed + 3)
    side = SIZE // 8
    pipe = Pipeline.create(ModelConfig(), image_size=SIZE, seed=args.seed, device="cuda")
    latent = torch.randn(2, side, side, 4, device="cuda", generator=g)
    context = torch.randn(2, 77, pipe.config.cross_attention_dim, device="cuda", generator=g)
    r = torch.randn(2, side, side, 4, device="cuda", generator=g)

    def unet_grad():
        x = latent.clone().requires_grad_(True)
        eps = pipe.unet(x, 500, context)
        return torch.autograd.grad((eps * r).sum(), x)

    norms = norm_calls([pipe.unet], unet_grad)
    out["sd14_unet_fwd_bwd_ms"] = check_layout_trace(
        "group_norm paths: SD-1.4 UNet pass + latent gradient (2, 64, 64, 4)",
        profiled_kernels(unet_grad), norms, True)
    with torch.no_grad():
        fwd = lambda: pipe.unet(latent, 500, context)
        out["sd14_unet_fwd_ms"] = check_layout_trace(
            "group_norm paths: SD-1.4 UNet pass (2, 64, 64, 4)", profiled_kernels(fwd),
            norm_calls([pipe.unet], fwd), False)
        image = torch.rand(1, SIZE, SIZE, 3, device="cuda", generator=g)
        z = pipe.vae.encode(image * 2.0 - 1.0)
        for name, fn in (("encode (1, 512, 512, 3)", lambda: pipe.vae.encode(image * 2.0 - 1.0)),
                         ("decode (1, 64, 64, 4)", lambda: pipe.vae.decode(z))):
            out[f"vae_{name.split()[0]}_ms"] = check_layout_trace(
                f"group_norm paths: VAE {name}", profiled_kernels(fn),
                norm_calls([pipe.vae], fn), False)
    del pipe, latent, context, r, image, z
    torch.cuda.empty_cache()

    sd21 = Pipeline.create(ModelConfig.sd21(), image_size=SIZE, seed=args.seed, device="cuda")
    feat = dift.SDFeaturizer(sd21, ensemble=EVAL_ENSEMBLE, seed=args.seed)
    scene = build_scene(SIZE)[0]
    mirrored = np.ascontiguousarray(scene[:, ::-1])
    check_dift_graph(feat, [scene, mirrored, scene], args.seed)
    gen = lambda: torch.Generator(device="cuda").manual_seed(args.seed + 100)
    norms = norm_calls([sd21.unet, sd21.vae], lambda: feat._ensemble(*feat._stage(scene, "", gen())))
    out["dift_call_ms"] = check_layout_trace(
        f"group_norm paths: SD-2.1 DIFT call, replayed ({EVAL_ENSEMBLE} draws)",
        profiled_kernels(lambda: feat(scene, "", gen())), norms, False)
    del feat, sd21
    torch.cuda.empty_cache()
    return out


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
FOUR = {"flash_fwd": None, "flash_bwd": None, "corr_fwd": None, "corr_bwd": None,
        "group_norm_fwd": None, "group_norm_bwd": None}
PATH_KERNELS = {"editor": FOUR, "remover": FOUR, "stitch": dict(FOUR, splat_fused=1),
                "options": FOUR, "editor1024": FOUR, "remover1024": FOUR,
                "batch_editor": FOUR, "batch_remover": FOUR,
                "batch_stitch": dict(FOUR, splat_fused=GROUP)}
# the options edit: 4 steps, whose one optimize step (i = 2: i >= 0.2 n,
# i < 0.65 n) is the fast start's, with two inner iterations
OPTIONS_CFG = dict(num_ddim_steps=4, fast_start_steps=0.2, num_first_optim_steps=2,
                   apply_attention_constraints=True)


def launch_counts():
    from geodiffuser_tpu_torch.kernels import flash_attention as fa
    from geodiffuser_tpu_torch.kernels import group_norm as gn
    from geodiffuser_tpu_torch.kernels import removal_corr as rc
    from geodiffuser_tpu_torch.kernels import splat as ks

    return fa.LAUNCHES, rc.LAUNCHES, ks.LAUNCHES, gn.LAUNCHES


# for each counter of `launch_counts`, the device kernel that one counted
# launch runs once (float32 or bf16 variant), as a profiler trace names it
TRACE_KERNELS = {"flash_fwd": r"flash_fwd_(?:wgmma_)?kernel",
                 "flash_bwd": r"flash_bwd_dq_(?:wgmma_)?kernel",
                 "corr_fwd": r"corr_(?:combine|finalize)_kernel",
                 "corr_bwd": r"(?:corr_)?bwd_keys_kernel",
                 "splat_fused": r"splat_kernel",
                 "group_norm_fwd": r"gn_apply_kernel",
                 "group_norm_bwd": r"gn_bwd_apply_kernel"}


def traced_launches(trace_events: list, shapes) -> tuple:
    """The port's kernel launches in a CUDA profiler trace's events (the
    "traceEvents" of `export_chrome_trace`): every kernel the device ran,
    graph replays included, counted by `TRACE_KERNELS`, and the bf16 flash
    forwards by shape.  A flash forward's shape is read back from its
    kernel variant and grid (`fa.tile_plan`) against `shapes`, the
    (B, Lq, Lk, D) that may have run; the forwards that not exactly one of
    them gives are counted apart, by (variant, warpgroups, grid).  Returns
    (launches, {(name, *shape): n}, {(variant, warpgroups, grid): n})."""
    import re

    from geodiffuser_tpu_torch.kernels import flash_attention as fa

    signature = {}
    for shape in dict.fromkeys(map(tuple, shapes)):
        plan = fa.tile_plan(*shape)
        signature.setdefault((plan["variant"], plan["fwd"]["warpgroups"],
                              (*plan["fwd"]["grid"], 1)), []).append(shape)
    launches, by_shape, unnamed = dict.fromkeys(TRACE_KERNELS, 0), {}, {}
    for e in trace_events:
        if e.get("cat") != "kernel":
            continue
        for name, pattern in TRACE_KERNELS.items():
            if re.search(rf"(?<!\w){pattern}(?!\w)", e["name"]):
                launches[name] += 1
        if m := re.search(r"(?<!\w)flash_fwd_wgmma_kernel<(\d+), *(\d+)>", e["name"]):
            sig = (int(m[1]), int(m[2]), tuple(e.get("args", {}).get("grid", ())))
            named = signature.get(sig, [])
            counts, key = ((by_shape, ("flash_fwd", *named[0])) if len(named) == 1
                           else (unnamed, sig))
            counts[key] = counts.get(key, 0) + 1
    return launches, by_shape, unnamed


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


def scene_live_rows(size: int, mode: str, mask=None, transform=None) -> dict:
    """Live removal-loss rows of the scene in `mode` at the two loss
    resolutions, {64: n, 32: n} at 512^2 (what the corr kernels' work
    depends on); `mask` and `transform` replace the scene's (a group's
    edits)."""
    import torch

    from geodiffuser_tpu_torch.config import EditConfig
    from geodiffuser_tpu_torch.core import edit_state
    from geodiffuser_tpu_torch.ops import camera
    from geodiffuser_tpu_torch.ops import image as image_ops
    from geodiffuser_tpu_torch.ops import transform_field as tf_ops

    cfg = EditConfig()
    image, depth, scene_mask = build_scene(size)
    mask = scene_mask if mask is None else mask
    f32 = dict(dtype=torch.float32, device="cuda")
    mask_t = (torch.as_tensor(mask, **f32) > 0.5).float()
    if transform is None:
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
    from geodiffuser_tpu_torch.utils.checkpoint import write_safetensors

    sources, total = {}, 0
    for name, module in pipe.modules().items():
        rel, manifest = weights.components(pipe.config)[name]
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
               f"{rel} keys and shapes against {manifest}")
    write_toy_tokenizer(root)
    return sources, total


def unequal_tensors(loaded, sources: dict) -> list:
    """(component, key) of every loaded tensor that is not bit-equal to its
    fp16 source cast to the model type."""
    import torch

    return [(name, k) for name, module in loaded.modules().items()
            for k, v in module.state_dict().items()
            if not torch.equal(v.view(torch.int16), sources[name][k].to(
                "cuda", loaded.config.dtype).view(torch.int16))]


def run_driver(args, pipe, card: str, tmp: str):
    """The batch driver at full width, 512^2, bf16: the random pipeline
    written as an fp16 diffusers checkpoint and loaded back with
    `Pipeline.create(checkpoint_dir=...)` (every tensor bit-equal to its
    fp16 source cast to bf16, the BPE tokenizer), then
    `run_folder_sweep(use_native=True)` over an editor, a remover and a
    stitch folder at --steps, with every launch count set to 0 just before
    and read just after; a second sweep skips all three, a third
    (skip_existing=False) reads every inversion from its folder.  The
    editor folder's result is held against a direct EditSession.run of the
    same inputs, run twice.  Everything is written under `tmp`.  Returns
    (launches, launches by shape, the experiment root)."""
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

    ckpt, root = os.path.join(tmp, "sd14"), os.path.join(tmp, "exps")
    t0 = time.time()
    sources, n_bytes = write_checkpoint(pipe, ckpt)
    write_s = time.time() - t0
    t0 = time.time()
    loaded = Pipeline.create(ModelConfig(), image_size=SIZE, checkpoint_dir=ckpt,
                             seed=args.seed + 1, device="cuda")
    torch.cuda.synchronize()
    load_s = time.time() - t0
    unequal = unequal_tensors(loaded, sources)
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
    shutil.rmtree(ckpt)
    torch.cuda.empty_cache()
    return launches, shapes, root


# ---------------------------------------------------------------------------
# The evaluation package
# ---------------------------------------------------------------------------

# noise draws a image of the phase's MD call (the CLI's default, the
# reference's ensemble of 8)
EVAL_ENSEMBLE = 8
# one bf16 DIFT draw through the flash kernels against the same draw with
# the plain version: each attention layer's outputs may differ by a bf16
# rounding step (2^-8 relative) where the two sum in another order, and the
# random-weight UNet carries that on through the 16 layers before the tap
# (the SD-1.4 UNet check's eps differs by 1.3e-2 of its largest value,
# check_unet_flash).  MD reads each location's feature direction, held by
# its cosine similarity as the UNet check holds the gradient's; the relative
# RMS difference guards against a gross error (a wrong scale or padding
# gives differences of order 1)
DIFT_TOL = {"rel_rms": 5e-2, "min_cosine": 0.99}
# the CLI runs of the phase, in one process: (name, arguments after
# --exp_root/--path_1); "W" stands for the weights directory
CLI_RUNS = (
    ("md", ["--metric", "md", "--weights_dir", "W"]),
    ("offline", ["--metric", "offline"]),
    ("lpips", ["--metric", "lpips", "--weights_dir", "W"]),
    ("clip", ["--metric", "clip", "--evaluation_type", "3D", "--weights_dir", "W"]),
    ("fid", ["--metric", "fid", "--weights_dir", "W"]),
    ("pairwise", ["--metric", "clip", "--weights_dir", "W"]),
)
# runs each argument list of argv[1] as `python -m geodiffuser_tpu_torch.evaluation`
# does (runpy, as __main__) and exits with the largest exit code
CLI_SCRIPT = r"""
import json, runpy, sys
codes = []
for argv in json.loads(sys.argv[1]):
    sys.argv = ["geodiffuser_tpu_torch.evaluation"] + argv
    try:
        runpy.run_module("geodiffuser_tpu_torch.evaluation", run_name="__main__", alter_sys=True)
        codes.append(0)
    except SystemExit as exc:
        codes.append(exc.code if isinstance(exc.code, int) else 1)
import torch
print(json.dumps({"exit_codes": codes,
                  "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30}))
sys.exit(max(codes))
"""


def write_lpips_clip_weights(root: str, seed: int) -> None:
    """Random weights in the published layouts: torchvision AlexNet and the
    lpips linear heads as .pth (torch.save), the CLIP ViT-B/32 vision tower
    as fp16 safetensors with its unused position_ids, held against the
    copied manifest."""
    import torch

    from geodiffuser_tpu_torch.evaluation import lpips
    from geodiffuser_tpu_torch.models import weights
    from geodiffuser_tpu_torch.models.clip_vision import CLIPVisionEncoder
    from geodiffuser_tpu_torch.utils.checkpoint import write_safetensors

    g = torch.Generator().manual_seed(seed)
    alex = {}
    for idx, (cin, cout, k, _, _) in lpips.ALEX_CONVS.items():
        alex[f"features.{idx}.weight"] = (torch.randn(cout, cin, k, k, generator=g)
                                          * (2.0 / (cin * k * k)) ** 0.5)
        alex[f"features.{idx}.bias"] = torch.zeros(cout)
    lin = {f"lin{i}.model.1.weight": torch.rand(1, c, 1, 1, generator=g) * 0.1
           for i, c in enumerate(lpips.ALEX_CHANNELS)}
    torch.save(alex, os.path.join(root, "alexnet.pth"))
    torch.save(lin, os.path.join(root, "lpips_alex.pth"))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        tower = CLIPVisionEncoder()
    tensors = {k: v.to(torch.float16) for k, v in tower.state_dict().items()}
    tensors["vision_model.embeddings.position_ids"] = torch.arange(50)[None]
    path = os.path.join(root, "clip_vision.safetensors")
    write_safetensors(path, tensors)
    with open(weights.MANIFESTS / weights.CLIP_VISION_MANIFEST) as f:
        want = {k: tuple(v) for k, v in json.load(f)["keys"].items()}
    expect(safetensors_shapes(path) == want, "clip_vision.safetensors keys and shapes")


def check_cli_outputs(outs: dict) -> None:
    """What each CLI run must have written: finite numbers under the keys
    the metric gives on the driver's editor, remover and stitch folders."""
    md_keys = {"Translation_3D/ours", "stitch/ours"}   # md skips Removal
    all_keys = md_keys | {"Removal/ours"}
    towers = {"psnr", "ssim", "lpips", "if", "clip_sim"}
    want = {"md": (md_keys, {"md", "warp_l1", "ssim", "bg_psnr", "bg_l1"}),
            "offline": (all_keys, {"warp_l1", "ssim", "bg_psnr", "bg_l1"}),
            "lpips": (all_keys, towers), "clip": ({"Translation_3D/ours"}, towers),
            "fid": ({"ours"}, {"fid"}), "pairwise": ({"pairwise"}, towers)}
    for name, (keys, fields) in want.items():
        got = outs[name]
        ok = set(got) == keys and all(set(v) == fields and all(math.isfinite(x)
                                                               for x in v.values())
                                      for v in got.values())
        expect(ok, f"evaluation CLI --metric {name}: {got}")


def check_dift_graph(feat, images: list, seed: int):
    """The featurizer's ensemble as a CUDA graph against the eager ensemble:
    each image with a generator of its own seed, staged alike, featurized
    once eagerly (`_stage`, `_ensemble`) and once by the call that captures
    (the first) or replays the graph; equal bits expected, else `DIFT_TOL`.
    The scene comes again last, so a replay that kept the previous image's
    inputs fails.  Returns the first eager call's launches and launches by
    shape, as the kernel wrappers count them."""
    import torch

    from geodiffuser_tpu_torch.evaluation import dift
    from geodiffuser_tpu_torch.kernels import flash_attention as fa
    from geodiffuser_tpu_torch.kernels import removal_corr as rc

    def gen(i):
        return torch.Generator(device="cuda").manual_seed(seed + 100 + i)

    dift.GRAPHS.update(captures=0, replays=0, eager=0)
    for counts in launch_counts():
        counts.update(dict.fromkeys(counts, 0))
    fa.SHAPES.clear()
    rc.SHAPES.clear()
    refs, eager_s = [], []
    for i, img in enumerate(images):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        refs.append(feat._ensemble(*feat._stage(img, "", gen(i)))[0].cpu())
        eager_s.append(time.perf_counter() - t0)
        if i == 0:
            launches = {k: v for counts in launch_counts() for k, v in counts.items()}
            shapes = {**fa.SHAPES, **rc.SHAPES}

    reserved = torch.cuda.memory_reserved()
    max_reserved = torch.cuda.max_memory_reserved()
    allocated = torch.cuda.memory_allocated()
    call_s = []
    for i, (img, ref) in enumerate(zip(images, refs)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = torch.from_numpy(feat(img, "", gen(i)))
        call_s.append(time.perf_counter() - t0)
        if i == 0:
            capture_s = feat._graph[1].capture_s
            log(f"evaluation: DIFT graph captured in {capture_s:.3f} s (warm-up ensemble and "
                f"capture; first call {call_s[0]:.3f} s); reserved {reserved} -> "
                f"{torch.cuda.memory_reserved()} B, max reserved {max_reserved} -> "
                f"{torch.cuda.max_memory_reserved()} B, allocated {allocated} -> "
                f"{torch.cuda.memory_allocated()} B")
        equal = torch.equal(got, ref)
        rms = float((got - ref).norm() / ref.norm())
        cos = float(torch.nn.functional.cosine_similarity(got, ref, dim=-1).min())
        log(f"evaluation: DIFT graph vs eager ensemble, image {i}: equal bits {equal}, largest "
            f"abs diff {float((got - ref).abs().max()):.3e}, rel RMS {rms:.2e}, least cosine "
            f"{cos:.5f}")
        expect(equal or (rms <= DIFT_TOL["rel_rms"] and cos >= DIFT_TOL["min_cosine"]),
               f"evaluation: DIFT graph image {i} against the eager ensemble")
    replay_s = []
    for i, img in enumerate(images):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        feat(img, "", gen(i))
        replay_s.append(time.perf_counter() - t0)
    log(f"evaluation: DIFT call an image (stage, ensemble, read back): eager "
        f"{[round(t, 4) for t in eager_s]} s, graph replayed "
        f"{[round(t, 4) for t in call_s[1:] + replay_s]} s")
    log(f"evaluation: DIFT featurizer calls {dift.GRAPHS}, one eager call's launches {launches}")
    expect(dift.GRAPHS == {"captures": 1, "replays": 2 * len(images), "eager": 0},
           f"evaluation: one DIFT capture and one replay a call ({dift.GRAPHS})")
    return launches, shapes


def run_evaluation(args, card: str, tmp: str, root: str):
    """The evaluation package at full SD-2.1 geometry, 512^2, bf16: the
    random pipeline written as an fp16 checkpoint and loaded back
    bit-equal, one DIFT draw through the kernels against the plain
    version, the graphed ensemble against the eager one
    (`check_dift_graph`), `mean_distance_metric` on the scene against the
    driver's edited editor folder under a CUDA profiler, then the CLI in a
    process of its own.  Returns MD's launches and launches by shape, read
    from its profiler trace (`traced_launches`)."""
    import torch

    from geodiffuser_tpu_torch.config import ModelConfig
    from geodiffuser_tpu_torch.core.pipeline import Pipeline
    from geodiffuser_tpu_torch.evaluation import dift
    from geodiffuser_tpu_torch.evaluation.__main__ import _transform_field
    from geodiffuser_tpu_torch.kernels import flash_attention as fa
    from geodiffuser_tpu_torch.utils import exp_io, png

    t_phase = time.time()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = ModelConfig.sd21()
    ckpt = os.path.join(tmp, "sd21")
    t0 = time.time()
    pipe = Pipeline.create(cfg, image_size=SIZE, seed=args.seed, device="cuda")
    torch.cuda.synchronize()
    create_s = time.time() - t0
    t0 = time.time()
    sources, n_bytes = write_checkpoint(pipe, ckpt)
    write_lpips_clip_weights(ckpt, args.seed)
    del pipe
    write_s = time.time() - t0
    t0 = time.time()
    loaded = Pipeline.create(cfg, image_size=SIZE, checkpoint_dir=ckpt, seed=args.seed + 1,
                             device="cuda")
    torch.cuda.synchronize()
    load_s = time.time() - t0
    unequal = unequal_tensors(loaded, sources)
    n_tensors = sum(len(s) for s in sources.values())
    del sources
    log(f"evaluation checkpoint (SD-2.1, random init {create_s:.2f} s): {n_bytes} bytes of "
        f"fp16 safetensors written in {write_s:.2f} s (then the LPIPS and CLIP weights), "
        f"loaded by Pipeline.create("
        f"ModelConfig.sd21(), checkpoint_dir=...) in {load_s:.2f} s; {n_tensors} tensors, "
        f"{len(unequal)} not bit-equal to the fp16 source cast to bf16 {unequal[:4]}")
    expect(not unequal, "evaluation: loaded weights bit-equal to the fp16 sources cast to bf16")

    image, _, mask = build_scene(SIZE)
    folder = os.path.join(root, "Translation_3D", "0")
    edited = png.read_png(os.path.join(folder, "result_ls.png"))
    t_coords, _ = _transform_field(exp_io.read_exp(folder), torch.device("cuda"))
    feat = dift.SDFeaturizer(loaded, ensemble=EVAL_ENSEMBLE, seed=args.seed)

    # one draw through the kernels and with the plain version (not counted)
    latent = loaded.encode_image(torch.as_tensor(image.astype(np.float32) / 255.0,
                                                 device="cuda"))
    ctx = loaded.encode_text([""])
    noise = torch.randn(latent.shape, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(args.seed))
    f_kernel = feat.features(latent, ctx, noise, feat.t).float()
    kernel = fa.flash_attention
    fa.flash_attention = fa.attention_plain
    try:
        f_plain = feat.features(latent, ctx, noise, feat.t).float()
    finally:
        fa.flash_attention = kernel
    rms = float((f_kernel - f_plain).norm() / f_plain.norm())
    cos = float(torch.nn.functional.cosine_similarity(f_kernel, f_plain, dim=-1).min())
    log(f"evaluation: one DIFT draw {tuple(f_kernel.shape)} through the flash kernels vs the "
        f"plain version: rel RMS diff {rms:.2e}, least cosine over locations {cos:.5f}, max "
        f"rel err {rel_err(f_kernel, f_plain):.2e} (tol {DIFT_TOL})")
    expect(rms <= DIFT_TOL["rel_rms"] and cos >= DIFT_TOL["min_cosine"]
           and bool(torch.isfinite(f_kernel).all()), "evaluation: DIFT draw")

    eager_launches, eager_shapes = check_dift_graph(feat, [image, edited, image], args.seed)

    # a replay runs no Python, so MD's launches are the device's own
    # records of the kernels it ran (the featurizer's graph was captured
    # before the profiler started)
    from torch.profiler import ProfilerActivity, profile

    replays = dift.GRAPHS["replays"]
    t0 = time.time()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        md, n_kp = dift.mean_distance_metric(feat, image, edited, mask, t_coords)
        torch.cuda.synchronize()
    md_s = time.time() - t0
    trace = os.path.join(tmp, "md_trace.json")
    prof.export_chrome_trace(trace)
    with open(trace) as f:
        launches, shapes, unnamed = traced_launches(
            json.load(f)["traceEvents"],
            [k[1:] for k in eager_shapes if k[0] == "flash_fwd"] + DIFT_FLASH_SHAPES)
    os.remove(trace)
    log(f"evaluation MD (SD-2.1 DIFT, {SIZE}^2, {EVAL_ENSEMBLE} draws an image): {md:.3f} px "
        f"over {n_kp} keypoints, {md_s:.2f} s profiled")
    log(f"evaluation: kernel launches in MD's profiler trace {launches}")
    log(f"evaluation: flash launches by shape in MD's trace {shape_counts(shapes)}; by "
        f"(variant, warpgroups, grid) of no one shape {unnamed}")
    expect(math.isfinite(md) and n_kp > 0, "evaluation: a finite MD over keypoints")
    for shape in DIFT_FLASH_SHAPES:
        n = shapes.get(("flash_fwd", *shape), 0)
        expect(n > 0, f"evaluation: flash_fwd launched {n} times at {shape}")
    expect(launches == {k: 2 * eager_launches.get(k, 0) for k in launches}
           and shapes == {k: 2 * n for k, n in eager_shapes.items()} and not unnamed,
           f"evaluation: MD's traced launches {launches} are two eager ensembles' "
           f"{eager_launches}")
    log(f"evaluation: MD's featurizer calls {dift.GRAPHS}")
    expect(dift.GRAPHS == {"captures": 1, "replays": replays + 2, "eager": 0},
           f"evaluation: MD replays the captured ensemble once an image ({dift.GRAPHS})")
    del loaded, feat, latent, ctx, noise, f_kernel, f_plain
    torch.cuda.empty_cache()

    # the command line a user runs, in a process of its own
    pair = [os.path.join(tmp, "path_1"), os.path.join(tmp, "path_2")]
    for d in pair:
        os.makedirs(d)
    for cat, exp_folder in exp_io.list_experiments(root):
        shutil.copy(os.path.join(exp_folder, "input_image.png"),
                    os.path.join(pair[0], f"{cat}.png"))
        shutil.copy(os.path.join(exp_folder, "result_ls.png"), os.path.join(pair[1], f"{cat}.png"))
    outs = {name: os.path.join(tmp, f"eval_{name}.json") for name, _ in CLI_RUNS}
    argvs = [(["--path_1", pair[0], "--path_2", pair[1]] if name == "pairwise"
              else ["--exp_root", root]) + [ckpt if a == "W" else a for a in argv]
             + ["--output", outs[name]] for name, argv in CLI_RUNS]
    pkg_root = str(pathlib.Path(dift.__file__).resolve().parents[2])
    t0 = time.time()
    cli = subprocess.run([sys.executable, "-c", CLI_SCRIPT, json.dumps(argvs)],
                         capture_output=True, text=True, timeout=600, cwd=pkg_root,
                         env=dict(os.environ, PYTHONPATH=pkg_root))
    cli_s = time.time() - t0
    lines = cli.stdout.strip().splitlines()
    log(f"evaluation command line (python -m geodiffuser_tpu_torch.evaluation, "
        f"{' / '.join(n for n, _ in CLI_RUNS)}): exit {cli.returncode} in {cli_s:.1f} s, "
        f"{lines[-1] if lines else ''}")
    for line in lines[:-1]:
        if not line.startswith("[INFO] wrote"):
            log(f"evaluation cli: {line}")
    if cli.returncode != 0:
        log(cli.stderr[-3000:])
    expect(cli.returncode == 0, "evaluation: the command line exits 0")
    results = {}
    for name, path in outs.items():
        with open(path) as f:
            results[name] = json.load(f)
    check_cli_outputs(results)
    log(f"evaluation phase: {time.time() - t_phase:.1f} s, max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (this process); {card}")
    return launches, shapes


# ---------------------------------------------------------------------------
# The UI server
# ---------------------------------------------------------------------------

# tiny float32 SAM and Depth Anything on the card against the CPU, the same
# weights: float32 sums in another order (no TF32), relative to the largest
# value of each output
UI_TOL = 1e-4
# the click: the scene object's centre (build_scene)
UI_CLICK = dict(x=0.4, y=0.6)


def png_b64(arr) -> str:
    import base64

    from geodiffuser_tpu_torch.utils import png

    return base64.b64encode(png.encode_png(np.asarray(arr, np.uint8))).decode()


def b64_png(data: str) -> np.ndarray:
    import base64

    from geodiffuser_tpu_torch.utils import png

    return png.decode_png(base64.b64decode(data))


def ui_request(base: str, name: str, body=None, timing: dict = None):
    """POST /api/<name> (GET /api/state without a body); the JSON answer.
    An error answer fails the phase; the seconds go to `timing`."""
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"{base}/api/{name}", data=data,
                                 headers={"Content-Type": "application/json"})
    t0 = time.time()
    with urllib.request.urlopen(req, timeout=600) as r:
        out = json.loads(r.read())
    if timing is not None:
        timing.setdefault(name, []).append(round(time.time() - t0, 3))
    expect("error" not in out, f"ui: {name}: {out.get('error')}")
    return out


def check_ui_small(seed: int) -> None:
    """Tiny float32 SAM and Depth Anything built on the CPU and copied to the
    card: the image embedding, mask logits, IoU and relative depth on the
    card against the CPU (UI_TOL)."""
    import torch

    from geodiffuser_tpu_torch.models.sam import SamConfig
    from geodiffuser_tpu_torch.utils.depth import DepthAnythingPredictor
    from geodiffuser_tpu_torch.utils.segmentation import SamPredictor

    image, _, _ = build_scene(96)
    pts, labels = np.array([[40.0, 55.0]]), np.array([1])
    sams = {"cpu": SamPredictor(SamConfig.tiny(), device="cpu", seed=seed)}
    sams["cuda"] = SamPredictor(SamConfig.tiny(), state_dict=sams["cpu"].model.state_dict())
    das = {"cpu": DepthAnythingPredictor("tiny", device="cpu", seed=seed)}
    das["cuda"] = DepthAnythingPredictor("tiny", state_dict=das["cpu"].model.state_dict())
    out = {}
    for dev in ("cuda", "cpu"):
        sams[dev].set_image(image)
        logits, iou = sams[dev].predict_logits(pts, labels)
        out[dev] = [sams[dev]._embedding.cpu(), logits.cpu(), iou.cpu(),
                    das[dev].relative_depth(image).cpu()]
    errs = [rel_err(a, b) for a, b in zip(out["cuda"], out["cpu"])]
    log(f"ui small reference (tiny fp32 SAM and Depth Anything, 96^2, card vs CPU): rel err "
        f"embedding {errs[0]:.2e}, mask logits {errs[1]:.2e}, IoU {errs[2]:.2e}, depth "
        f"{errs[3]:.2e} (tol {UI_TOL})")
    expect(max(errs) <= UI_TOL and all(bool(torch.isfinite(t).all()) for t in out["cuda"]),
           "ui small reference")


# the dropdown's other backends, each at full geometry and its predictor's
# default input size (DPT-Hybrid's three variants separately)
DEPTH_BACKENDS = ("dpt_large", "dpt_hybrid", "dpt_hybrid_kitti", "dpt_hybrid_nyu", "midas_v21",
                  "zoedepth", "zoedepth_nk")


def run_depth_backends(args, card: str, image) -> dict:
    """Each backend built at full width in float32 on the card (random weights
    from --seed), run on the scene: finite (H, W) depth, its parameter count,
    ms a depth map by CUDA events under the UI server's own settings
    (PyTorch's default TF32 convolutions), its peak memory and its seconds in
    this loop (build, check and timing); freed before the next.  DPT-Large
    is also timed without TF32 convolutions, as the rest of this script
    runs, where cuDNN picks an FFT algorithm for the DPT scratch at 384²;
    with --profile each backend's three largest kernels are listed.  The
    loop is one PhaseTimer phase.  Returns {name: {...}}."""
    import torch

    from geodiffuser_tpu_torch.utils import depth as depth_utils
    from geodiffuser_tpu_torch.utils.profiling import PhaseTimer

    out, timer = {}, PhaseTimer()
    torch.backends.cudnn.allow_tf32 = True
    try:
        with timer.phase("depth_backends", block_on=torch.zeros(1, device="cuda")):
            for name in DEPTH_BACKENDS:
                t0 = time.time()
                pred = depth_utils.get_depth_predictor(name, device="cuda", seed=args.seed)
                torch.cuda.synchronize()
                build_s = time.time() - t0
                n = sum(p.numel() for p in pred.model.parameters())
                torch.cuda.reset_peak_memory_stats()
                d = pred(image)
                expect(d.shape == image.shape[:2] and bool(np.isfinite(d).all()),
                       f"ui depth {name}: finite depth of the image's shape")
                call = lambda: pred.model_depth(image)
                ms = time_ms(call, iters=5)
                row = {"params": n, "ms": round(ms, 3),
                       "peak_gib": round(torch.cuda.max_memory_allocated() / 2**30, 2),
                       "input": list(pred.input_size())}
                note = ""
                if name == "dpt_large":
                    torch.backends.cudnn.allow_tf32 = False
                    row["ms_no_tf32_convs"] = round(time_ms(call, iters=5), 3)
                    torch.backends.cudnn.allow_tf32 = True
                    note = f", {row['ms_no_tf32_convs']:.2f} ms without TF32 convolutions"
                if args.profile:
                    top = kernel_breakdown(call, iters=2).split("; ")[:3]
                    note += f"; largest kernels a call: {'; '.join(top)}"
                torch.cuda.synchronize()
                row["loop_s"] = round(time.time() - t0, 2)
                out[name] = row
                log(f"ui depth backend {name}: {n} float32 parameters, input "
                    f"{pred.input_size()}, {ms:.2f} ms a depth map (CUDA events around "
                    f"model_depth: upload, resize, normalize, model, resize back; mean of 5; "
                    f"TF32 convolutions, PyTorch's default){note}, peak {row['peak_gib']:.2f} "
                    f"GiB, built in {build_s:.1f} s, {row['loop_s']:.1f} s in the loop; {card}")
                del pred, d, call
                torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.allow_tf32 = False
    log(f"ui depth backends: {json.dumps(out)}")
    log(f"ui depth backends PhaseTimer: {json.dumps(timer.summary())}")
    return out


def check_depth_small(seed: int, tmp: str) -> None:
    """The five tiny float32 depth models built on the CPU and copied to the
    card: each predictor's depth on the card against the CPU (UI_TOL); one
    save_params / load_params round trip of a state dict on the card."""
    import torch

    from geodiffuser_tpu_torch.models import midas_dpt as md
    from geodiffuser_tpu_torch.models import zoedepth as zd
    from geodiffuser_tpu_torch.models import zoedepth_nk as znk
    from geodiffuser_tpu_torch.utils import depth as depth_utils
    from geodiffuser_tpu_torch.utils.checkpoint import load_params, save_params

    image, _, _ = build_scene(96)
    tiny = {"dpt_large": dict(config=md.DPTConfig.tiny()),
            "dpt_hybrid": dict(config=md.DPTHybridConfig.tiny()),
            "midas_v21": dict(config=md.MidasV21Config.tiny(), size=64),
            "zoedepth": dict(config=zd.ZoeDepthConfig.tiny(), size=64),
            "zoedepth_nk": dict(config=znk.ZoeDepthNKConfig.tiny(), size=(40, 48))}
    errs = {}
    for name, kw in tiny.items():
        cpu = depth_utils.get_depth_predictor(name, device="cpu", seed=seed, **kw)
        cuda = depth_utils.get_depth_predictor(name, state_dict=cpu.model.state_dict(), **kw)
        got, want = cuda.model_depth(image), cpu.model_depth(image)
        expect(bool(torch.isfinite(got).all()), f"depth small {name}: finite on the card")
        errs[name] = rel_err(got.cpu(), want)
    log(f"depth small reference (tiny fp32 backends, 96^2 scene, card vs CPU): rel err "
        f"{json.dumps({k: float(f'{v:.2e}') for k, v in errs.items()})} (tol {UI_TOL})")
    expect(max(errs.values()) <= UI_TOL, "depth small reference")
    state = cuda.model.state_dict()
    path = os.path.join(tmp, "zoedepth_nk_tiny.safetensors")
    save_params(path, state)
    back = load_params(path, like=state)
    expect(all(torch.equal(back[k], v) and back[k].device == v.device for k, v in state.items()),
           "save_params / load_params on the card: equal bits")
    log(f"save_params / load_params: {len(state)} tensors of the tiny ZoeDepth-NK on the card, "
        f"{os.path.getsize(path)} bytes, read back bit-equal")


def run_ui(args, pipe, card: str, tmp: str, root: str):
    """The UI server over the resident SD-1.4 pipeline, with SAM ViT-H and
    Depth Anything ViT-L at full width in float32 (random weights from
    --seed), after the dropdown's other depth backends one at a time
    (`run_depth_backends`): every request of a user's session over HTTP
    (depth by Depth Anything, DPT-Large and ZoeDepth-NK), the edit and the
    inpaint with every launch count set to 0 just before and read just
    after, a depth request running beside the edit; the edited and inpainted
    images against direct EditSession.run calls (equal bits); then the tiny
    perception and depth models card against CPU.  Returns (launches,
    launches by shape) of the edit and inpaint together."""
    import threading
    import urllib.request

    import torch

    from geodiffuser_tpu_torch.core.editor import EditSession
    from geodiffuser_tpu_torch.kernels import flash_attention as fa
    from geodiffuser_tpu_torch.kernels import removal_corr as rc
    from geodiffuser_tpu_torch.models.sam import SamConfig
    from geodiffuser_tpu_torch.ui import callbacks as cb
    from geodiffuser_tpu_torch.ui import serve
    from geodiffuser_tpu_torch.utils import depth as depth_utils
    from geodiffuser_tpu_torch.utils.segmentation import SamPredictor

    t_phase = time.time()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    sam = SamPredictor(SamConfig.vit_h(), device="cuda", seed=args.seed)
    depth = depth_utils.DepthAnythingPredictor("vitl", device="cuda", seed=args.seed)
    torch.cuda.synchronize()
    n_sam = sum(p.numel() for p in sam.model.parameters())
    n_da = sum(p.numel() for p in depth.model.parameters())
    log(f"ui models: SAM ViT-H {n_sam} and Depth Anything ViT-L {n_da} float32 parameters, "
        f"random init seed {args.seed}: {time.time() - t0:.1f} s")

    image, scene_depth, mask = build_scene(SIZE)
    click = np.array([[SIZE * UI_CLICK["x"], SIZE * UI_CLICK["y"]]])
    enc_ms = time_ms(lambda: sam.set_image(image), iters=3)
    dec_ms = time_ms(lambda: sam.predict_logits(click, np.array([1])), iters=10)
    da_ms = time_ms(lambda: depth.relative_depth(image), iters=3)
    log(f"ui model times (512^2 scene, float32, no TF32; CUDA events around the calls, host "
        f"work included): SAM encode (resize, normalize, pad to 1024^2, ViT-H) {enc_ms:.1f} ms, "
        f"SAM decode (prompt, two-way decoder, mask upsampling) {dec_ms:.2f} ms, Depth "
        f"Anything ViT-L (518^2) {da_ms:.1f} ms; {card}")
    backends_peak = max(r["peak_gib"] for r in run_depth_backends(args, card, image).values())

    srv = serve.make_server(pipe, port=0, sam_predictor=sam, depth_predictor=depth)
    app = srv.RequestHandlerClass.app
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    secs = {}
    post = lambda name, body=None: ui_request(base, name, body, secs)
    folder = os.path.join(root, "Translation_3D", "0")
    adv = {"num_ddim_steps": args.steps}
    inpaint_adv = dict(cb.REMOVER_ADVANCED_DEFAULTS, **adv)
    runs = {}
    try:
        expect(post("state")["image"] is False, "ui: a fresh session has no image")
        got = b64_png(post("load_image", {"image": "data:image/png;base64," + png_b64(image)})
                      ["image"])
        expect(np.array_equal(got, image), "ui: load_image at the working size keeps the image")
        clicks = [b64_png(post("click", UI_CLICK)["mask"]) for _ in range(2)]
        expect(clicks[0].shape == (SIZE, SIZE) and np.array_equal(clicks[0], clicks[1]),
               "ui: two clicks give SAM masks of the image's shape with equal bits")
        shown = b64_png(post("depth", {"model": "depth_anything",
                                       "translate_factor": 0.7})["depth"])
        expect(shown.shape == (SIZE, SIZE) and app.state.depth.shape == (SIZE, SIZE)
               and bool(np.isfinite(app.state.depth).all()), "ui: a finite depth map")
        for model in ("dpt_large", "zoedepth_nk"):   # built by the server on first use
            shown = b64_png(post("depth", {"model": model, "translate_factor": 0.7})["depth"])
            served = app.state.depth.copy()
            direct = app.state.depth_predictors[model](image, translate_factor=0.7)
            expect(shown.shape == (SIZE, SIZE) and bool(np.isfinite(served).all())
                   and np.array_equal(served, direct),
                   f"ui: a {model} depth map over HTTP, equal to a direct call")
        got = b64_png(post("set_mask", {"mask": png_b64(mask * 255)})["mask"])
        expect(np.array_equal(got > 127, mask > 0.5), "ui: set_mask")
        post("load", {"folder": folder})
        prev = b64_png(post("preview", EDITOR_TRANSFORM)["preview"])
        expect(prev.shape == (SIZE, SIZE, 3) and prev.std() > 0, "ui: preview")
        state = app.state
        inputs = (state.image.copy(), state.depth.copy(), state.mask.copy(),
                  state.transform.copy())

        for name, body in (("edit", {"prompt": "", "advanced": adv}),
                           ("inpaint", {"prompt": "", "advanced": inpaint_adv})):
            for counts in launch_counts():
                counts.update(dict.fromkeys(counts, 0))
            fa.SHAPES.clear()
            rc.SHAPES.clear()
            out = {}
            worker = threading.Thread(target=lambda: out.update(post(name, body)))
            worker.start()
            if name == "edit":   # a depth request while the edit runs
                while worker.is_alive() and not ui_request(base, "state")["progress"]["running"]:
                    time.sleep(0.01)
                post("depth", {"model": "depth_anything", "translate_factor": 0.7})
                beside = worker.is_alive()
            worker.join(timeout=900)
            torch.cuda.synchronize()
            expect(not worker.is_alive() and "edited" in out, f"ui: {name} answered")
            launches = {k: v for counts in launch_counts() for k, v in counts.items()}
            runs[name] = (launches, {**fa.SHAPES, **rc.SHAPES}, b64_png(out["edited"]))
            log(f"ui {name}: kernel launches {launches}")
            log(f"ui {name}: flash and corr launches by shape {shape_counts(runs[name][1])}")
            for k in ("flash_fwd", "flash_bwd", "corr_fwd", "corr_bwd"):
                expect(launches[k] > 0, f"ui {name}: kernel {k} launched {launches[k]} times")
        log(f"ui: a depth request answered while the edit ran (edit still running then: "
            f"{beside})")
        post("load", {"folder": folder})       # the scene's depth again

        saved = post("save", {"root": os.path.join(tmp, "ui_saved"),
                              "category": "Translation_3D"})["folder"]
        loaded = post("load", {"folder": saved})
        expect(np.array_equal(b64_png(loaded["image"]), image), "ui: save then load")
        with urllib.request.urlopen(base + "/", timeout=60) as r:
            expect(b"toDataURL('image/png')" in r.read(), "ui: the page converts uploads")
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=60)
    expect(not thread.is_alive(), "ui: the server thread stopped")
    log(f"ui request seconds: {json.dumps(secs)}")

    image_s, depth_s, mask_s, transform_s = inputs
    cfg = cb.AdvancedOptions(**adv).to_edit_config("geometry_editor")
    direct = EditSession(pipe, cfg).run(image_s, depth_s, mask_s, transform_s).edited_image
    d_edit = int(np.abs(direct.astype(int) - runs["edit"][2].astype(int)).max())
    cfg = cb.AdvancedOptions(**inpaint_adv).to_edit_config("geometry_remover")
    direct = EditSession(pipe, cfg).run(image_s, depth_utils.constant_depth(SIZE, SIZE), mask_s,
                                        np.eye(4)).edited_image
    d_inpaint = int(np.abs(direct.astype(int) - runs["inpaint"][2].astype(int)).max())
    log(f"ui: the served edit and inpaint vs direct EditSession.run: max {d_edit} / "
        f"{d_inpaint} uint8 levels (bound {DRIVER_EDIT_LEVELS})")
    expect(d_edit <= DRIVER_EDIT_LEVELS and d_inpaint <= DRIVER_EDIT_LEVELS,
           "ui: served results equal direct runs")
    del sam, depth, app, srv
    torch.cuda.empty_cache()
    check_ui_small(args.seed)
    check_depth_small(args.seed, tmp)
    log(f"ui phase: {time.time() - t_phase:.1f} s, max_memory_allocated "
        f"{max(torch.cuda.max_memory_allocated() / 2**30, backends_peak):.2f} GiB (this "
        f"process; the depth backends' {backends_peak:.2f}); {card}")
    launches = {k: runs["edit"][0][k] + runs["inpaint"][0][k] for k in runs["edit"][0]}
    shapes = dict(runs["edit"][1])
    for key, n in runs["inpaint"][1].items():
        shapes[key] = shapes.get(key, 0) + n
    return launches, shapes

# ---------------------------------------------------------------------------
# The lockstep batch
# ---------------------------------------------------------------------------

# the group's edits: the scene moved four ways (editor), its object removed
# from four places (remover: the mask rolled by these (rows, columns) at
# 512^2) and pasted four ways onto the seeded background (stitch)
BATCH_EDITOR_TRANSFORMS = (EDITOR_TRANSFORM, dict(tx=-0.06, ry=-10.0), dict(ty=0.06, rz=10.0),
                           dict(tx=0.05, sx=1.15, sy=1.15))
BATCH_REMOVER_SHIFTS = ((0, 0), (-60, 40), (-120, 0), (40, -80))
BATCH_STITCH_TRANSFORMS = (STITCH_TRANSFORM, dict(tx=-0.1), dict(ty=0.08),
                           dict(tx=0.05, ty=-0.05))
# relative RMS of each group edit's final latents against the sequential run
# of the same edit from the same inversion.  In bf16 at full width the two
# round apart: the group's convolutions, products and flash row tiles run at
# E times the batch, and 6 denoising steps of the random-weight UNet under
# guidance carry that rounding (2^-8) to 0.11-0.19, with the update off as
# with it on (measured on an H100).  bf16 rounding on the card also depends
# on a row's place in a batch's products: a group of GROUP copies of one
# editor edit, identical inputs, spreads as far (~0.1 between its copies,
# the witness printed), while a group of one is `run` itself (one loop).
# The bound on the gap is 0.3; each group edit against the next edit's
# sequential run (the control) must lie beyond it (0.42-0.95 on an H100).
# The bound is 0.4 on each group-sweep result image
# against the sequential sweep's (the random-weight VAE roughly doubles a
# latent gap).  In float32 (`float32_group`) rounding is ~1e-7 and
# the bound 1e-3, with the update off (with it on, an optimize step turns
# rounding into other updates: the L1 losses' gradient is the sign of each
# residual, and residuals at rounding level take either sign; the CPU tests
# hold that case)
BATCH_REL_RMS = 0.3
SWEEP_IMAGE_REL_RMS = 0.4
# the editor group at full width in float32 (FLOAT32_STEPS steps, the
# update off) against each edit's sequential run: there the rounding is
# ~1e-7 and the bound 1e-3 (final latents' relative RMS; loss logs but the
# removal terms, whose argmax over bf16-rounded maps may flip on a near-tie,
# and their total); each group edit against the next edit's sequential run
# (the control: another edit's masks, taps or warp) must lie beyond it
FLOAT32_STEPS = 2
FLOAT32_BATCH_REL = 1e-3
# group sizes of the packing measurement (the editor, no inversion cache)
PACKING = (1, 2, 4, 8)
BATCH_PATHS = {"batch_editor": "geometry_editor", "batch_remover": "geometry_remover",
               "batch_stitch": "geometry_stitch"}


def batch_config(args, path: str, **kw):
    from geodiffuser_tpu_torch.config import EditConfig

    return EditConfig(edit_type=BATCH_PATHS[path], num_ddim_steps=args.steps, **kw)


def batch_raw(args, path: str, n: int = GROUP) -> list:
    """The raw inputs of n edits on a batch path, the i-th the (i % 4)-th
    variant: (image, depth, mask, transform), a stitch's with its
    background."""
    from geodiffuser_tpu_torch.ops import camera

    image, depth, mask = build_scene(SIZE)
    out = []
    for i in range(n):
        v = i % GROUP
        if path == "batch_editor":
            out.append((image, depth, mask, camera.compose_transform(**BATCH_EDITOR_TRANSFORMS[v])))
        elif path == "batch_remover":
            out.append((image, depth, np.roll(mask, BATCH_REMOVER_SHIFTS[v], axis=(0, 1)),
                        np.eye(4)))
        else:
            out.append((image, depth, mask, camera.compose_transform(**BATCH_STITCH_TRANSFORMS[v]),
                        stitch_background(args.seed)))
    return out


def batch_inputs(cfg, path: str, raw) -> list:
    """(image, depth, mask, transform) of each edit; a stitch's is its
    pre-composite (one splat), run as an identity edit, as perform_stitch
    runs it."""
    from geodiffuser_tpu_torch.core.editor import stitch_composite

    if path != "batch_stitch":
        return list(raw)
    out = []
    for image, depth, mask, transform, background in raw:
        comp, warped = stitch_composite(cfg, background, image, mask, depth, transform)
        out.append((comp, np.full(comp.shape[:2], 0.5, np.float32), warped, np.eye(4)))
    return out


def batch_live_rows(args) -> dict:
    """Live removal-loss rows of each edit of the editor and remover groups,
    {(path, latent side): [n of each edit]} (the group correlation's work)."""
    live = {}
    for path in ("batch_editor", "batch_remover"):
        mode = "editor" if path == "batch_editor" else "remover"
        per = [scene_live_rows(SIZE, mode, mask=m, transform=t)
               for _, _, m, t in batch_raw(args, path)]
        for side in per[0]:
            live[path, side] = [p[side] for p in per]
    return live


def corr_group_shapes(group: int = GROUP) -> list:
    """(path, H, K, L, Lk, D) of the removal correlation on the editor's and
    remover's batch paths: their 512^2 shapes with the heads of every edit
    (the stitch's are the editor's)."""
    return [(f"batch_{mode}", h * group, k, l, lk, d) for mode in ("editor", "remover")
            for h, k, l, lk, d in corr_path_shapes(512, mode)]


def check_corr_group(rng_seed: int, live: dict, rec: dict) -> None:
    """The correlation kernels with the edit axis (one launch for a group of
    GROUP edits, masks (E, L) and (E, K), each edit its own live rows)
    against the plain version of each edit and against one single-edit
    launch per edit, with check_corr's tolerances, at every group shape of
    the batch paths; bf16, timed by device time beside the single-edit
    launches, added to `rec`'s shapes with their bound."""
    import torch

    from geodiffuser_tpu_torch.kernels import removal_corr as rc

    g = torch.Generator(device="cuda").manual_seed(rng_seed + 7)
    fwd_plain = lambda *a: by_chunks(lambda qe, ke, qb, kb: rc.corr_fwd_plain(
        qe, ke, qb, kb, *a[4:]), a[0].shape[0], *a[:4])
    bwd_plain = lambda *a: by_chunks(rc.corr_bwd_plain, a[0].shape[0], *a)
    dt = torch.bfloat16
    for path, h, kr, l, lk, d in corr_group_shapes():
        lives = [min(n, kr) for n in live[path, math.isqrt(l)]]
        e = len(lives)
        hpe = h // e
        heads = [slice(i * hpe, (i + 1) * hpe) for i in range(e)]
        qe, ke, qb, kb = (torch.randn(h, n, d, device="cuda", generator=g).to(dt)
                          for n in (kr, lk, l, lk))
        inp = (torch.rand(e, l, device="cuda", generator=g) < 0.1).float()
        bg = ((torch.rand(e, l, device="cuda", generator=g) < 0.8) & (inp < 0.5)).float()
        rm = torch.stack([(torch.arange(kr, device="cuda") < n).float() for n in lives])
        scale = d ** -0.5
        name = f"{(h, kr, l, lk, d)} edits {e} live {lives}"
        got = rc.corr_fwd_cuda(qe, ke, qb, kb, inp, bg, rm, scale)
        one = [rc.corr_fwd_cuda(qe[s], ke[s], qb[s], kb[s], inp[i], bg[i], rm[i], scale)
               for i, s in enumerate(heads)]
        ref = [fwd_plain(qe[s], ke[s], qb[s], kb[s], inp[i], bg[i], rm[i], scale)
               for i, s in enumerate(heads)]
        torch.cuda.synchronize()
        e_p, e_one, same, same_one, e_lse = 0.0, 0.0, 1.0, 1.0, 0.0
        dead_ok = True
        for i, (s, n) in enumerate(zip(heads, lives)):
            for m in (0, 1):
                e_p = max(e_p, rel_err(got[m][s, :n], ref[i][m][:, :n]))
                e_one = max(e_one, rel_err(got[m][s, :n], one[i][m][:, :n]))
            for m in (2, 3):
                same = min(same, float((got[m][s, :n] == ref[i][m][:, :n]).float().mean()))
                same_one = min(same_one, float((got[m][s, :n] == one[i][m][:, :n]).float().mean()))
            dead_ok &= all(bool((got[m][s, n:] == v).all())
                           for m, v in ((0, rc.NEG_INF), (1, rc.NEG_INF), (2, 0), (3, 0)))
            live_ch = min(kr, -(-n // 64) * 64)
            e_lse = max(e_lse, abs_err(got[4][s, :live_ch], ref[i][4][:, :live_ch]),
                        abs_err(got[5][s], ref[i][5]))
        bits = all(torch.equal(got[m][s], one[i][m]) for i, s in enumerate(heads)
                   for m in range(4))
        log(f"corr_fwd bf16 group {name}: rel err p vs plain {e_p:.2e}, vs single-edit "
            f"launches {e_one:.2e} (equal bits {bits}); j equal plain {same:.4f}, single "
            f"{same_one:.4f}; lse abs err {e_lse:.2e}; dead rows ok {dead_ok}")
        expect(e_p <= 1e-2 and e_one <= 1e-2 and same >= 0.98 and same_one >= 0.98
               and e_lse <= 1e-3 and dead_ok, f"corr_fwd group {name}")
        # backward from the plain forward's indices and LSEs, the group's
        # launch against the plain version and the single-edit launches
        cat = lambda m: torch.cat([r[m] for r in ref])
        g_in = torch.where(rm.repeat_interleave(hpe, 0) > 0.5,
                           torch.randn(h, kr, device="cuda", generator=g), 0)
        g_bg = torch.where(rm.repeat_interleave(hpe, 0) > 0.5,
                           torch.randn(h, kr, device="cuda", generator=g), 0)
        need_dke = path == "batch_editor"
        bwd = lambda **kw: rc.corr_bwd_cuda(qe, ke, qb, kb, cat(2), cat(3), g_in, g_bg, rm,
                                            cat(4), cat(5), scale, **kw)
        bgot = bwd()
        bone = [rc.corr_bwd_cuda(qe[s], ke[s], qb[s], kb[s], ref[i][2], ref[i][3], g_in[s],
                                 g_bg[s], rm[i], ref[i][4], ref[i][5], scale)
                for i, s in enumerate(heads)]
        bref = [bwd_plain(qe[s], ke[s], qb[s], kb[s], ref[i][2], ref[i][3], g_in[s], g_bg[s],
                          rm[i], ref[i][4], ref[i][5], scale) for i, s in enumerate(heads)]
        torch.cuda.synchronize()
        errs = [max(rel_err(bgot[m][s], r[m]) for s, r in zip(heads, bref)) for m in (0, 1)]
        errs_one = [max(rel_err(bgot[m][s], r[m]) for s, r in zip(heads, bone)) for m in (0, 1)]
        log(f"corr_bwd bf16 group {name}: rel err d_qe/d_ke vs plain {errs[0]:.2e} "
            f"{errs[1]:.2e}, vs single-edit launches {errs_one[0]:.2e} {errs_one[1]:.2e} "
            f"(tol {TOL['bf16']:.1e})")
        expect(max(errs + errs_one) <= TOL["bf16"], f"corr_bwd group {name}")
        ms = device_ms(lambda: rc.corr_fwd_cuda(qe, ke, qb, kb, inp, bg, rm, scale))
        single_ms = device_ms(lambda: [rc.corr_fwd_cuda(qe[s], ke[s], qb[s], kb[s], inp[i], bg[i],
                                                        rm[i], scale)
                                       for i, s in enumerate(heads)])
        plain = device_ms(lambda: [fwd_plain(qe[s], ke[s], qb[s], kb[s], inp[i], bg[i], rm[i],
                                             scale) for i, s in enumerate(heads)], 1)
        live_sum = sum(lives)
        nb = 2 * (live_sum * d * hpe + (2 * lk * d + l * d) * h) + 8 * e * l + 4 * e * kr \
            + 16 * h * kr
        ops = 2 * hpe * (live_sum + e * l) * lk * d + 2 * hpe * live_sum * l * lk
        rec["corr_fwd"]["shapes"].append(dict(
            shape=[h, kr, l, lk, d], path=path, live_rows=live_sum, edits=e, ms=ms,
            single_edit_ms=single_ms, plain_ms=plain, library_ms=None,
            bound=bound_ms(nb, ops, "bf16"),
            max_abs_err=max(abs_err(got[m][s, :n], ref[i][m][:, :n])
                            for i, (s, n) in enumerate(zip(heads, lives)) for m in (0, 1))))
        b_ms = device_ms(lambda: bwd(need_dke=need_dke))
        b_single = device_ms(lambda: [rc.corr_bwd_cuda(
            qe[s], ke[s], qb[s], kb[s], ref[i][2], ref[i][3], g_in[s], g_bg[s], rm[i],
            ref[i][4], ref[i][5], scale, need_dke=need_dke) for i, s in enumerate(heads)])
        b_plain = device_ms(lambda: [bwd_plain(qe[s], ke[s], qb[s], kb[s], ref[i][2], ref[i][3],
                                               g_in[s], g_bg[s], rm[i], ref[i][4], ref[i][5],
                                               scale) for i, s in enumerate(heads)], 1)
        nb = 2 * hpe * d * (3 * live_sum + 2 * e * lk) + 8 * hpe * live_sum + 4 * e * kr \
            + 4 * hpe * d * (live_sum + e * lk)
        rec["corr_bwd"]["shapes"].append(dict(
            shape=[h, kr, l, lk, d], path=path, live_rows=live_sum, edits=e, ms=b_ms,
            path_ms=b_ms, single_edit_ms=b_single, plain_ms=b_plain, library_ms=None,
            bound=bound_ms(nb, 10 * hpe * live_sum * lk * d, "bf16"),
            max_abs_err=max(abs_err(bgot[m][s], r[m]) for s, r in zip(heads, bref)
                            for m in (0, 1))))
        log(f"corr bf16 group {name} ({path}): fwd {ms:.4f} ms ({e} single-edit launches "
            f"{single_ms:.4f}, plain {plain:.4f}, bound "
            f"{rec['corr_fwd']['shapes'][-1]['bound'][0]:.4f}), bwd {b_ms:.4f} ms (single-edit "
            f"{b_single:.4f}, plain {b_plain:.4f}, bound "
            f"{rec['corr_bwd']['shapes'][-1]['bound'][0]:.4f})")
    for r in rec.values():
        r["max_abs_err"] = max(sh["max_abs_err"] for sh in r["shapes"])


def reset_counts() -> None:
    import torch

    from geodiffuser_tpu_torch.kernels import flash_attention as fa
    from geodiffuser_tpu_torch.kernels import removal_corr as rc

    for counts in launch_counts():
        counts.update(dict.fromkeys(counts, 0))
    fa.SHAPES.clear()
    rc.SHAPES.clear()
    torch.cuda.synchronize()


def read_counts():
    """(launches, launches by shape) since the last reset_counts."""
    import torch

    from geodiffuser_tpu_torch.kernels import flash_attention as fa
    from geodiffuser_tpu_torch.kernels import removal_corr as rc

    torch.cuda.synchronize()
    return ({k: v for counts in launch_counts() for k, v in counts.items()},
            {**fa.SHAPES, **rc.SHAPES})


def run_batch_phase(args, pipe, tmp: str) -> dict:
    """The lockstep batch at 512^2, bf16, --steps: for each of the editor,
    remover and stitch a group of GROUP edits through
    `ShardedEditSession.run_batch`, with every launch count set to 0 just
    before and read just after; each edit held against its sequential
    `EditSession.run` from the same inversion (the sequential run writes it
    to the edit's folder, the group reads it): the final latents' relative
    RMS, and the group's flash and correlation launches against one
    sequential edit's without its inversion; the editor's also as a group
    of copies of one edit (the rounding witness).  Then seconds per edit and peak of editor groups of
    1, 2, 4 and 8 edits (each inverting), and `run_folder_sweep` with
    `group_size=GROUP` over two remover folders (a group and its pads)
    against the sequential sweep of the same folders (the update off), and
    the editor group at full width in float32 (`float32_group`).  Returns
    {path: (launches, launches by shape)}."""
    import torch

    from geodiffuser_tpu_torch.core import inversion
    from geodiffuser_tpu_torch.core.editor import EditSession
    from geodiffuser_tpu_torch.parallel import driver
    from geodiffuser_tpu_torch.parallel.batch import ShardedEditSession
    from geodiffuser_tpu_torch.utils import exp_io, png

    t_phase = time.time()
    stack = lambda ins: [np.stack([x[k] for x in ins]) for k in range(4)]
    torch.cuda.empty_cache()
    # what earlier phases left allocated: every peak below counts it
    resident = torch.cuda.memory_allocated() / 2 ** 30
    log(f"batch phase: {resident:.2f} GiB allocated when it starts (the pipeline and what "
        f"earlier phases keep)")
    runs = {}
    for path in BATCH_PATHS:
        raw = batch_raw(args, path)
        folders = [tempfile.mkdtemp(dir=tmp, prefix=f"{path}_") for _ in raw]
        cfg = batch_config(args, path)
        inputs = batch_inputs(cfg, path, raw)
        # the sequential runs invert and write each edit's trajectory to its
        # folder; the first's launches without its inversion's are one
        # edit's as the group runs it (reading the trajectories)
        t0 = time.time()
        seq, inv_counts = [], []
        invert = inversion.ddim_invert

        def counted_invert(*a, **kw):
            before = {k: v for c in launch_counts() for k, v in c.items()}
            out = invert(*a, **kw)
            inv_counts.append({k: v - before[k] for c in launch_counts() for k, v in c.items()})
            return out

        for j, ins in enumerate(inputs):
            reset_counts()
            inversion.ddim_invert = counted_invert
            try:
                seq.append(EditSession(pipe, cfg).run(*ins, exp_folder=folders[j]))
            finally:
                inversion.ddim_invert = invert
            if j == 0:
                seq_counts = {k: v - inv_counts[0][k] for k, v in read_counts()[0].items()}
        seq_s = time.time() - t0
        sess = ShardedEditSession(pipe, cfg)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.time()
        res = sess.run_batch(*stack(batch_inputs(cfg, path, raw)), exp_folders=folders)
        launches, shapes = read_counts()
        group_s = time.time() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        gaps, ctrl = group_gaps(res, seq)
        log(f"{path} ({SIZE}^2, {args.steps} DDIM steps, {len(inputs)} edits, inversions read "
            f"from the folders): group {group_s:.3f} s "
            f"({json.dumps({k: round(v, 3) for k, v in res.timings.items()})}), peak "
            f"{peak:.2f} GiB; sequential {seq_s:.3f} s")
        log(f"{path}: final latents' relative RMS to each sequential run "
            f"{' '.join(f'{x:.2e}' for x in gaps)} (bound {BATCH_REL_RMS:g}); control, to the "
            f"next edit's sequential run {' '.join(f'{x:.2e}' for x in ctrl)}")
        if path == "batch_editor":   # the rounding witness: identical edits in one group
            copies = sess.run_batch(*stack(inputs[:1] * len(inputs)),
                                    exp_folders=folders[:1] * len(inputs))
            spread = [rel_rms(copies.latents[j], copies.latents[0]) for j in range(len(seq))]
            log(f"{path}: a group of {len(inputs)} copies of edit 0: relative RMS of each copy "
                f"to copy 0 {' '.join(f'{x:.2e}' for x in spread)}, copy 0 to the group's edit 0 "
                f"{rel_rms(copies.latents[0], res.latents[0]):.2e}")
            expect(max(spread) <= BATCH_REL_RMS, f"{path}: copies of one edit")
            del copies
        log(f"{path}: kernel launches {launches}; one sequential edit's without its inversion "
            f"{seq_counts}")
        log(f"{path}: flash and corr launches by shape {shape_counts(shapes)}")
        expect(res.images.shape == (len(seq), 2, SIZE, SIZE, 3)
               and bool(torch.isfinite(res.latents).all())
               and all(math.isfinite(v) for lg in res.loss_log.values() for v in
                       np.concatenate(list(lg.values()))), f"{path}: finite results")
        expect(max(gaps) <= BATCH_REL_RMS < min(ctrl),
               f"{path}: group edits against their sequential runs, the control beyond the bound")
        for name, want in PATH_KERNELS[path].items():
            ok = launches[name] > 0 if want is None else launches[name] == want
            expect(ok, f"{path}: kernel {name} launched {launches[name]} times on the path")
        for name in ("flash_fwd", "flash_bwd", "corr_fwd", "corr_bwd"):
            expect(launches[name] == seq_counts[name],
                   f"{path}: {name} launches of the group {launches[name]}, of one edit "
                   f"{seq_counts[name]}")
        runs[path] = (launches, shapes)
        del seq, res

    # seconds per edit and peak by group size (each group inverts)
    cfg = batch_config(args, "batch_editor", cache_inversion=False)
    raw = batch_raw(args, "batch_editor", max(PACKING))
    packing = []
    for n in PACKING:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        sess = ShardedEditSession(pipe, cfg)
        t0 = time.time()
        res = sess.run_batch(*stack(raw[:n]))
        torch.cuda.synchronize()
        dt = time.time() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        packing.append(dict(edits=n, seconds=dt, sec_per_edit=dt / n, peak_gib=peak,
                            peak_above_start_gib=peak - resident,
                            timings={k: round(v, 4) for k, v in res.timings.items()}))
        expect(bool(torch.isfinite(res.latents).all()), f"packing {n}: finite latents")
        del res
    for p in packing:
        log(f"batch packing (editor, {SIZE}^2, {args.steps} steps): {p['edits']} edits "
            f"{p['seconds']:.3f} s, {p['sec_per_edit']:.3f} s an edit, peak "
            f"{p['peak_gib']:.2f} GiB ({p['peak_above_start_gib']:.2f} above the phase's "
            f"start), timings {json.dumps(p['timings'])}")
    log(json.dumps({"batch_packing": packing, "steps": args.steps}))

    # the driver's group sweep against its sequential sweep, from the
    # inversions the sequential sweep cached
    image, depth, mask = build_scene(SIZE)
    root, root_g = os.path.join(tmp, "batch_exps"), os.path.join(tmp, "batch_exps_group")
    for j, shift in enumerate(BATCH_REMOVER_SHIFTS[:2]):
        exp_io.save_exp(os.path.join(root, "Removal", str(j)), image, depth,
                        np.roll(mask, shift, axis=(0, 1)), np.eye(4))
    overrides = dict(num_ddim_steps=args.steps, lr=0.0)
    t0 = time.time()
    seq_times = driver.run_folder_sweep(root, pipe=pipe, config_overrides=overrides,
                                        use_native=True)
    seq_s = time.time() - t0
    shutil.copytree(root, root_g)
    reset_counts()
    t0 = time.time()
    group_times = driver.run_folder_sweep(root_g, pipe=pipe, group_size=GROUP,
                                          config_overrides=overrides, use_native=True,
                                          skip_existing=False)
    launches, shapes = read_counts()
    group_s = time.time() - t0
    gaps = {}
    for folder in seq_times:
        rel = os.path.relpath(folder, root)
        a, b = (torch.as_tensor(png.read_png(os.path.join(r, rel, "result_ls.png")).astype(
            np.float32)) for r in (root, root_g))
        gaps[rel] = rel_rms(b, a)
    log(f"batch driver sweep (group_size {GROUP}, {len(group_times)} folders, one group and "
        f"two pads, update off): "
        f"{group_s:.2f} s, edits (s) {json.dumps({os.path.relpath(k, root_g): round(v, 3) for k, v in group_times.items()})}; "
        f"sequential sweep {seq_s:.2f} s, edits (s) "
        f"{json.dumps({os.path.relpath(k, root): round(v, 3) for k, v in seq_times.items()})}")
    log(f"batch driver sweep: result images' relative RMS to the sequential sweep's "
        f"{json.dumps({k: round(v, 5) for k, v in gaps.items()})} (bound {SWEEP_IMAGE_REL_RMS:g}); "
        f"kernel launches {launches}")
    expect(sorted(os.path.relpath(f, root_g) for f in group_times)
           == sorted(os.path.relpath(f, root) for f in seq_times) and len(seq_times) == 2,
           "batch driver sweep: the two folders")
    expect(max(gaps.values()) <= SWEEP_IMAGE_REL_RMS,
           "batch driver sweep against the sequential sweep")
    for name in ("flash_fwd", "flash_bwd", "corr_fwd", "corr_bwd"):
        expect(launches[name] > 0, f"batch driver sweep: {name} launched {launches[name]} times")
    runs["batch_driver"] = (launches, shapes)
    float32_group(args, tmp)
    log(f"batch phase: {time.time() - t_phase:.1f} s")
    return runs


def group_gaps(group, seq):
    """Each group edit's final latents' relative RMS to its sequential run,
    and the control: to the next edit's sequential run."""
    e = len(seq)
    return ([rel_rms(group.latents[j], seq[j].latents) for j in range(e)],
            [rel_rms(group.latents[j], seq[(j + 1) % e].latents) for j in range(e)])


def float32_group(args, tmp: str) -> None:
    """The batch editor group at full width (SD-1.4 `ModelConfig()`, 512^2)
    in float32, FLOAT32_STEPS steps with the update off, through `run_batch`
    against each edit's sequential `EditSession.run` from the same
    inversion: final latents and loss logs within FLOAT32_BATCH_REL, the
    control beyond it."""
    import torch

    from geodiffuser_tpu_torch.config import EditConfig, ModelConfig
    from geodiffuser_tpu_torch.core.editor import EditSession
    from geodiffuser_tpu_torch.core.pipeline import Pipeline
    from geodiffuser_tpu_torch.parallel.batch import ShardedEditSession

    t0 = time.time()
    pipe = Pipeline.create(dataclasses.replace(ModelConfig(), dtype=torch.float32),
                           image_size=SIZE, seed=args.seed, device="cuda")
    cfg = EditConfig(num_ddim_steps=FLOAT32_STEPS, lr=0.0)
    inputs = batch_raw(args, "batch_editor")
    folders = [tempfile.mkdtemp(dir=tmp, prefix="batch_f32_") for _ in inputs]
    seq = [EditSession(pipe, cfg).run(*ins, exp_folder=f) for ins, f in zip(inputs, folders)]
    group = ShardedEditSession(pipe, cfg).run_batch(
        *(np.stack([x[k] for x in inputs]) for k in range(4)), exp_folders=folders)
    gaps, ctrl = group_gaps(group, seq)
    log_err, same_steps = 0.0, True
    for j, ref in enumerate(seq):
        loss_log = group.edit_logs(j)[0]
        same_steps &= sorted(loss_log) == sorted(ref.loss_log)
        log_err = max([log_err] + [abs(loss_log[i][k] - v) / max(abs(v), 1e-3)
                                   for i in ref.loss_log for k, v in ref.loss_log[i].items()
                                   if "removal" not in k and k != "total"])
    log(f"float32 batch editor (full width, {SIZE}^2, {FLOAT32_STEPS} steps, {len(seq)} edits, "
        f"update off): final latents' relative RMS to each sequential run "
        f"{' '.join(f'{x:.2e}' for x in gaps)}, control {' '.join(f'{x:.2e}' for x in ctrl)} "
        f"(bound {FLOAT32_BATCH_REL:g}, the control beyond it); loss logs rel err {log_err:.2e} "
        f"(removal and total excluded); {time.time() - t0:.1f} s")
    expect(same_steps and max(gaps) <= FLOAT32_BATCH_REL < min(ctrl)
           and log_err <= FLOAT32_BATCH_REL, "float32 batch editor against its sequential runs")
    del pipe, seq, group
    torch.cuda.empty_cache()


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
    "group_norm_fwd": ("geodiffuser_tpu_torch/csrc/group_norm.cu", None),
    "group_norm_bwd": ("geodiffuser_tpu_torch/csrc/group_norm.cu", None),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=6,
                    help="DDIM steps of each 512^2 edit (50 = default edit)")
    ap.add_argument("--large-steps", type=int, default=2,
                    help="DDIM steps of the 1024^2 editor and remover edits (step 0 optimizes)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="trace each edit with torch.profiler and print device time by kernel, "
                         "and list each depth backend's largest kernels")
    ap.add_argument("--only", default=None,
                    help="check and time only these kernels: any of flash, corr, splat, "
                         "group_norm, comma-separated (group_norm also traces the "
                         "channels-last models)")
    ap.add_argument("--package-root", default=None,
                    help="import geodiffuser_tpu_torch from this directory")
    args = ap.parse_args(argv)
    only = set((args.only or "").split(",")) - {""}
    if not only <= {"flash", "corr", "splat", "group_norm"}:
        ap.error(f"--only takes flash, corr, splat and group_norm, not {args.only}")
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
        if args.package_root is None:   # another commit's kernels may lack the edit axis
            group_live = batch_live_rows(args)
            log(f"group live rows of each edit (path, latent side): {group_live}")
            check_corr_group(args.seed, group_live, rec)
        log(f"corr checks and timings: {time.time() - t0:.1f} s")
    if not only or "splat" in only:
        t0 = time.time()
        rec.update(check_splat(args.seed, own=args.package_root is None))
        log(f"splat checks and timings: {time.time() - t0:.1f} s")
    if not only or "group_norm" in only:
        t0 = time.time()
        rec.update(check_group_norm(args.seed))
        log(f"group_norm checks and timings: {time.time() - t0:.1f} s")
        t0 = time.time()
        paths = check_group_norm_paths(args)
        log(f"group_norm paths: device ms {json.dumps({k: round(v, 3) for k, v in paths.items()})}"
            f"; {time.time() - t0:.1f} s")
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
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        launches, shapes, root = run_driver(args, pipe, card, tmp)
        runs["driver"] = (launches, shapes)
        log(f"driver phase: {time.time() - t0:.1f} s")
        runs["evaluation"] = run_evaluation(args, card, tmp, root)
        runs["ui"] = run_ui(args, pipe, card, tmp, root)
        runs.update(run_batch_phase(args, pipe, tmp))
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
        if "timed_shapes" in r:   # group_norm: every timed shape
            entry["timed_shapes"] = [dict({k: v for k, v in sh.items() if k != "bound"},
                                          bound_ms=sh["bound"][0], bound_by=sh["bound"][1])
                                     for sh in r["timed_shapes"]]
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
