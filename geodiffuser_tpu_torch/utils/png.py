"""PNG files and PIL's bicubic resize, with the standard library and numpy.

The experiment folders hold 8-bit PNGs (`utils/exp_io.py`).  `read_png`
decodes 8-bit non-interlaced gray, gray+alpha, RGB and RGBA files into the
array PIL's `np.asarray(Image.open(path))` gives (gray (H, W), the others
(H, W, C)); `write_png` stores 8-bit gray or RGB arrays (filter 0, zlib).
`resize_bicubic` follows Pillow's `Image.resize(size)` for 8-bit images
(Resample.c: the a = -0.5 cubic widened by the reduction factor,
coefficients normalised per output pixel and rounded to 22 fraction bits,
a horizontal pass into an 8-bit image, then a vertical pass).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels (8-bit samples)
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters (PNG spec, section 9) into (height, stride) uint8."""
    rows = np.frombuffer(raw, np.uint8)[: height * (stride + 1)].reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        kind, line = rows[y, 0], rows[y, 1:]
        if kind == 0:
            cur = line
        elif kind == 1:      # Sub: a running sum along each channel
            cur = (np.cumsum(line.reshape(-1, bpp).astype(np.int64), axis=0) & 0xFF
                   ).astype(np.uint8).reshape(-1)
        elif kind == 2:      # Up
            cur = line + prev
        elif kind in (3, 4):
            # Average and Paeth: each byte depends on the decoded byte bpp to
            # its left, so they run byte by byte (Python ints: faster than
            # numpy scalars)
            ln, up, cur_l = line.tolist(), prev.tolist(), [0] * stride
            for x in range(stride):
                a = cur_l[x - bpp] if x >= bpp else 0
                if kind == 3:
                    pred = (a + up[x]) >> 1
                else:
                    b, c = up[x], (up[x - bpp] if x >= bpp else 0)
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur_l[x] = (ln[x] + pred) & 0xFF
            cur = np.array(cur_l, np.uint8)
        else:
            raise ValueError(f"PNG row filter {kind} is not defined")
        out[y] = cur
        prev = out[y]
    return out


def read_png(path: str) -> np.ndarray:
    """An 8-bit non-interlaced PNG as uint8: (H, W) gray, else (H, W, C)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + length
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, depth, colour, _, _, interlace = header
    if depth != 8 or interlace != 0 or colour not in _CHANNELS:
        raise ValueError(f"{path}: only 8-bit non-interlaced gray, gray+alpha, RGB and RGBA "
                         f"PNGs are read (bit depth {depth}, colour type {colour}, "
                         f"interlace {interlace})")
    ch = _CHANNELS[colour]
    img = _unfilter(zlib.decompress(b"".join(idat)), height, width * ch, ch)
    return img.reshape(height, width) if ch == 1 else img.reshape(height, width, ch)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path: str, image: np.ndarray) -> None:
    """Write a uint8 (H, W) gray or (H, W, 3) RGB array as an 8-bit PNG."""
    img = np.ascontiguousarray(image, np.uint8)
    if img.ndim == 2:
        colour = 0
    elif img.ndim == 3 and img.shape[2] == 3:
        colour = 2
    else:
        raise ValueError(f"write_png takes (H, W) or (H, W, 3) arrays, got {img.shape}")
    h, w = img.shape[:2]
    rows = img.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()
    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(_chunk(b"IEND", b""))


def to_rgb(img: np.ndarray) -> np.ndarray:
    """PIL's `convert("RGB")` of a decoded 8-bit image: gray replicated,
    alpha dropped."""
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=-1)
    if img.shape[2] == 2:
        return np.repeat(img[..., :1], 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


# ---------------------------------------------------------------------------
# Pillow's resample (libImaging/Resample.c) for 8-bit images
# ---------------------------------------------------------------------------

_PRECISION_BITS = 32 - 8 - 2


def _bicubic(x: np.ndarray) -> np.ndarray:
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


def _coefficients(in_size: int, out_size: int):
    """Per output pixel: the first input index, and fixed-point weights over
    a window of `ksize` inputs (zero past the image)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    weights = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = _bicubic((np.arange(xmax) + xmin - center + 0.5) / filterscale)
        total = w.sum()
        if total != 0.0:
            w = w / total
        fixed = w * (1 << _PRECISION_BITS)
        weights[xx, :xmax] = np.where(fixed < 0, np.trunc(fixed - 0.5), np.trunc(fixed + 0.5))
        first[xx] = xmin
    return first, weights


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass along `axis` of an (H, W, C) uint8 image, rounded and
    clipped to 8 bits as Pillow does between its passes."""
    in_size = img.shape[axis]
    first, weights = _coefficients(in_size, out_size)
    ksize = weights.shape[1]
    src = np.moveaxis(img.astype(np.int64), axis, 0)
    src = np.concatenate([src, np.zeros((ksize,) + src.shape[1:], np.int64)], axis=0)
    acc = np.full((out_size,) + src.shape[1:], 1 << (_PRECISION_BITS - 1), np.int64)
    for k in range(ksize):
        wk = weights[:, k].reshape((out_size,) + (1,) * (src.ndim - 1))
        acc += src[first + k] * wk
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize_bicubic(image: np.ndarray, height: int, width: int) -> np.ndarray:
    """Pillow's `Image.fromarray(image).resize((width, height))` (bicubic)
    of a uint8 (H, W) or (H, W, C) array."""
    img = np.asarray(image, np.uint8)
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    if img.shape[1] != width:
        img = _resample_axis(img, width, 1)
    if img.shape[0] != height:
        img = _resample_axis(img, height, 0)
    return img[..., 0] if squeeze else img
