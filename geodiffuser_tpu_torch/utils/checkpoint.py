"""Parameter files and batch-sweep resume records.

Counterpart of `geodiffuser_tpu/utils/checkpoint.py` (orbax there): a state
dict, or a nested dict of tensors flattened with '.', is written as one
safetensors file (an 8-byte little-endian header length, a JSON header
padded to 8 bytes, the raw little-endian data) and read back by
`models/weights.read_safetensors`, without the `safetensors` package.
`SweepManifest` is the JAX package's, unchanged.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, Optional

import torch

from geodiffuser_tpu_torch.models.weights import read_safetensors

SAFETENSORS_CODES = {
    torch.float64: "F64", torch.float32: "F32", torch.float16: "F16", torch.bfloat16: "BF16",
    torch.int64: "I64", torch.int32: "I32", torch.int16: "I16", torch.int8: "I8",
    torch.uint8: "U8", torch.bool: "BOOL",
}


def write_safetensors(path: str, tensors: Dict[str, torch.Tensor]) -> int:
    """Tensors (any device; dtypes of SAFETENSORS_CODES) as a .safetensors
    file, names sorted.  Returns the bytes written."""
    header, offset = {}, 0
    for name in sorted(tensors):
        t = tensors[name]
        if t.dtype not in SAFETENSORS_CODES:
            raise ValueError(f"{name}: dtype {t.dtype} has no safetensors code")
        n = t.numel() * t.element_size()
        header[name] = {"dtype": SAFETENSORS_CODES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)) + raw)
        for name in sorted(tensors):
            t = tensors[name].detach().contiguous().cpu()
            if t.dtype == torch.bfloat16:
                t = t.view(torch.int16)
            f.write(t.numpy().tobytes())
    return 8 + len(raw) + offset


def _flatten(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = v
    return out


def _unflatten_like(flat: Dict[str, torch.Tensor], like, prefix: str = ""):
    out = {}
    for k, v in like.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out[k] = _unflatten_like(flat, v, key)
        else:
            out[k] = flat[key].to(device=v.device, dtype=v.dtype)
    return out


def save_params(path: str, params: Any, force: bool = True) -> None:
    """Write a state dict (or a nested dict of tensors) to `path`."""
    path = os.path.abspath(path)
    if not force and os.path.exists(path):
        raise FileExistsError(path)
    write_safetensors(path, _flatten(params))


def load_params(path: str, like: Optional[Any] = None) -> Any:
    """The tensors of `path` as a flat dict (CPU, stored dtypes); with `like`,
    in `like`'s structure, each on its device and in its dtype, after a
    ValueError naming any key or shape that differs."""
    flat = read_safetensors(os.path.abspath(path))
    if like is None:
        return flat
    want = {k: tuple(v.shape) for k, v in _flatten(like).items()}
    got = {k: tuple(v.shape) for k, v in flat.items()}
    if want != got:
        diff = sorted(k for k in set(want) | set(got) if want.get(k) != got.get(k))
        raise ValueError(f"{path} does not match the structure given: {diff[:8]}")
    return _unflatten_like(flat, like)


class SweepManifest:
    """Resumable record of a batch sweep (driver side)."""

    def __init__(self, path: str):
        self.path = path
        self.done: Dict[str, float] = {}
        if os.path.exists(path):
            with open(path) as f:
                self.done = json.load(f)

    def is_done(self, folder: str) -> bool:
        return folder in self.done

    def mark(self, folder: str, seconds: float) -> None:
        self.done[folder] = seconds
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.done, f, indent=1)
        os.replace(tmp, self.path)
