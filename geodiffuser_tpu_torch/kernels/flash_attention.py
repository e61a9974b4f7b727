"""Flash attention, forward and backward: CUDA kernels and their plain
versions.

Counterpart of `geodiffuser_tpu/kernels/flash_attention.py`; the kernels are
`csrc/flash_attention.cu`.  `flash_attention` launches them for CUDA tensors
and takes the plain version only for CPU tensors.  Operands are
(..., L, D) with any leading batch dims and D at its native width.
"""

from __future__ import annotations

import functools
import math

import torch

from geodiffuser_tpu_torch.kernels import _build

# launches of each wrapper's kernel, and of each wrapper per shape
# (name, B, Lq, Lk, D) (chip_smoke.py reads and resets both)
LAUNCHES = {"flash_fwd": 0, "flash_bwd": 0}
SHAPES: dict = {}

SMS = 132      # streaming multiprocessors of the H100 SXM
TILE = 64      # rows of one operand tile (one wgmma warpgroup's M)
BOX_COLS = 64  # columns of one TMA box (128 bytes of bf16, the swizzle width)


def use_flash(lq: int, lk: int) -> bool:
    """Flash pays off when the key sequence is large (self-attention at
    >= 32^2); cross attention (Lk=77) has no L^2 term to save.  Rectangular
    maps (the warped-row blend) qualify whenever both axes tile."""
    return lk >= 1024 and lk % 256 == 0 and lq >= 256 and lq % 256 == 0


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def attention_plain(q, k, v, scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v with float32 logits and softmax, the
    probabilities cast to v's type before the product (the JAX package's
    vanilla_attention).  Differentiable by autograd."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(probs.float(), v.float()).to(v.dtype)


def flash_fwd_plain(q, k, v, scale: float):
    """Plain counterpart of the forward kernel on (B, L, D) operands:
    returns (o, lse) with lse the natural-log row LSE in float32 (B, Lq)."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    lse = torch.logsumexp(logits, dim=-1)
    p = torch.exp(logits - lse[..., None])
    o = torch.matmul(p.to(v.dtype).float(), v.float()).to(q.dtype)
    return o, lse


def flash_bwd_plain(q, k, v, o, lse, do, scale: float):
    """Plain counterpart of the backward kernels on (B, L, D) operands:
    from the saved LSE and delta = rowsum(dO * O),
    dq = scale * (P (dP - delta)) K, dk = scale * (P (dP - delta))^T Q,
    dv = P^T dO, with P and dS cast to the input type before their product."""
    f = torch.float32
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    p = torch.exp(torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale - lse[..., None])
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = (p * (dp - delta)).to(q.dtype).to(f)
    dq = (torch.matmul(ds, k.float()) * scale).to(q.dtype)
    dk = (torch.matmul(ds.transpose(-1, -2), q.float()) * scale).to(k.dtype)
    dv = torch.matmul(p.to(do.dtype).to(f).transpose(-1, -2), do.float()).to(v.dtype)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# Tile plan of the bf16 kernels
# ---------------------------------------------------------------------------

def _tiles(n: int, rows: int) -> int:
    return -(-n // rows)


# consumer warpgroups of a block: the forward at D <= 40 takes four; at
# D = 80 and 160 (two and four times the output accumulators) and in the
# backward kernels two
FWD_WARPGROUPS = {40: 4, 80: 2, 160: 2}
BWD_WARPGROUPS = 2
# widest head the kernels take: the UNet's 32^2 level at 1024^2 images
MAX_D = 160


def row_tiles(b: int, rows: int, warpgroups: int) -> int:
    """64-row tiles of the output axis per block: as many as the block has
    warpgroups (each loaded tile of the loop axis then feeds them all), halved
    while that leaves fewer than ~one block per SM, but to no fewer than half
    the warpgroups.  The warpgroups of a row tile split the loop axis between
    them; a four-way split feeds each loaded tile to one warpgroup only and
    measured slower than the fewer blocks of a two-way split (PERF.md)."""
    r = warpgroups
    while r > max(1, warpgroups // 2) and b * _tiles(rows, r * TILE) < SMS - SMS // 10:
        r //= 2
    return r


@functools.lru_cache(maxsize=256)
def tile_plan(b: int, lq: int, lk: int, d: int) -> dict:
    """Launch plan of the bf16 kernels for (B, Lq, Lk, D) operands, as
    `csrc/flash_attention.cu` derives it from the row tiles it is given:
    the padded head width (the kernel variant), the TMA map of each operand
    (dims and byte strides innermost first, 64 x 64 boxes) and, per kernel,
    its grid, rows per block and the loop tiles each warpgroup of a row tile
    takes.  At variant 160 the dk/dv kernel has one row tile whose two
    warpgroups take every loop tile, one accumulating dV and the other dK
    (`roles`): a thread cannot hold both 64 x 160 accumulators.  Cached:
    callers read the returned dict and do not modify it."""
    d8 = -(-d // 8) * 8
    dv = 40 if d8 <= 40 else 80 if d8 <= 80 else 160

    def kernel(rows, loop, warpgroups):
        r = row_tiles(b, rows, warpgroups)
        splits = warpgroups // r
        n = _tiles(loop, TILE)
        return dict(warpgroups=warpgroups, row_tiles=r, splits=splits, rows_per_block=r * TILE,
                    grid=(_tiles(rows, r * TILE), b), loop_tiles=n,
                    tiles_per_warpgroup=tuple(len(range(sp, n, splits)) for sp in range(splits)))

    def tmap(length):
        return dict(dims=(d8, length, b), strides=(2 * d8, 2 * d8 * length),
                    box=(BOX_COLS, TILE, 1), boxes_per_tile=_tiles(d8, BOX_COLS))

    dkv = (kernel(lk, lq, BWD_WARPGROUPS) if dv < 160
           else dict(kernel(lk, lq, 1), warpgroups=BWD_WARPGROUPS, roles=("dv", "dk")))
    return dict(d_pad=d8, variant=dv, k_depth=-(-dv // 16) * 16, maps=dict(q=tmap(lq), k=tmap(lk)),
                fwd=kernel(lq, lk, FWD_WARPGROUPS[dv]), dq=kernel(lq, lk, BWD_WARPGROUPS), dkv=dkv)


def _tma_ready(x, d8: int):
    """x with its head dim zero-padded to d8 (16-byte rows) and a 16-byte
    aligned base, as TMA needs; x itself where it already is."""
    if x.shape[-1] != d8:
        x = torch.nn.functional.pad(x, (0, d8 - x.shape[-1]))
    if x.data_ptr() % 16:
        x = x.clone()
    return x


def _unpad(x, d: int):
    return x if x.shape[-1] == d else x[..., :d].contiguous()


def _count(name: str, b: int, lq: int, lk: int, d: int) -> None:
    LAUNCHES[name] += 1
    key = (name, b, lq, lk, d)
    SHAPES[key] = SHAPES.get(key, 0) + 1


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check(q, k, v):
    _build.require_cuda(q, k, v)
    if q.dtype != k.dtype or q.dtype != v.dtype:
        raise TypeError("q, k, v must share one dtype")
    if q.dim() != 3 or k.shape != v.shape or q.shape[0] != k.shape[0] or q.shape[2] != k.shape[2]:
        raise ValueError(f"bad shapes q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)}")
    if not 1 <= q.shape[2] <= MAX_D:
        raise ValueError(f"head dim {q.shape[2]} outside 1..{MAX_D}")


def flash_fwd_cuda(q, k, v, scale: float):
    """Forward kernel on contiguous (B, L, D) CUDA tensors -> (o, lse)."""
    _check(q, k, v)
    b, lq, d = q.shape
    lk = k.shape[1]
    plan = tile_plan(b, lq, lk, d)
    if q.dtype == torch.bfloat16:
        q, k, v = (_tma_ready(x, plan["d_pad"]) for x in (q, k, v))
    o = torch.empty_like(q)
    lse = torch.empty((b, lq), dtype=torch.float32, device=q.device)
    err = _build.lib().gd_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        b, lq, lk, q.shape[2], float(scale), _build.dtype_code(q), plan["fwd"]["row_tiles"],
        _build.stream_ptr(q))
    _build.check(err, "gd_flash_fwd")
    _count("flash_fwd", b, lq, lk, d)
    return _unpad(o, d), lse


def flash_bwd_cuda(q, k, v, o, lse, do, scale: float):
    """Backward kernels on contiguous (B, L, D) CUDA tensors -> (dq, dk, dv)."""
    _check(q, k, v)
    _build.require_cuda(q, o, lse, do)
    b, lq, d = q.shape
    lk = k.shape[1]
    if o.shape != q.shape or do.shape != q.shape or lse.shape != (b, lq) \
            or lse.dtype != torch.float32 or do.dtype != q.dtype or o.dtype != q.dtype:
        raise ValueError("o, dO must match q and lse must be float32 (B, Lq)")
    plan = tile_plan(b, lq, lk, d)
    if q.dtype == torch.bfloat16:
        q, k, v, o, do = (_tma_ready(x, plan["d_pad"]) for x in (q, k, v, o, do))
    delta = torch.empty((b, lq), dtype=torch.float32, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    err = _build.lib().gd_flash_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, lq, lk, q.shape[2], float(scale), _build.dtype_code(q), plan["dq"]["row_tiles"],
        plan["dkv"]["row_tiles"], _build.stream_ptr(q))
    _build.check(err, "gd_flash_bwd")
    _count("flash_bwd", b, lq, lk, d)
    return _unpad(dq, d), _unpad(dk, d), _unpad(dv, d)


class FlashAttention(torch.autograd.Function):
    """Kernel forward with the kernel backward (no L x L map in either pass)."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        o, lse = flash_fwd_cuda(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd_cuda(q, k, v, o, lse, do.contiguous(), ctx.scale)
        return dq, dk, dv, None


def flash_attention(q, k, v, scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v without materializing the map on the card.

    CUDA tensors go through the kernels (differentiable: the backward is a
    kernel too); CPU tensors through `attention_plain`."""
    if not q.is_cuda:
        return attention_plain(q, k, v, scale)
    lead = q.shape[:-2]
    b = math.prod(lead)
    flat = lambda x: x.reshape((b,) + tuple(x.shape[-2:])).contiguous()
    o = FlashAttention.apply(flat(q), flat(k), flat(v), float(scale))
    return o.reshape(q.shape)
