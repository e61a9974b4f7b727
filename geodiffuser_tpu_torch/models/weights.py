"""Checkpoint loading, and JAX parameter trees -> the port's state_dicts.

`load_sd_checkpoint` loads a local Stable-Diffusion checkpoint in the
diffusers layout (the counterpart of `geodiffuser_tpu/models/weights.py:
load_sd_checkpoint`; the reference's `StableDiffusionPipeline.from_pretrained`,
diffusion.py:107):

    <dir>/unet/diffusion_pytorch_model.safetensors
    <dir>/vae/diffusion_pytorch_model.safetensors
    <dir>/text_encoder/model.safetensors
    <dir>/tokenizer/{vocab.json, merges.txt}      (models/tokenizer.py)

each file falling back to its `.bin` (`torch.load(weights_only=True)`).  The
port's modules carry the diffusers/HF names, so a checkpoint's state_dict
loads as it is: the keys `models/manifests/*.json` mark `unconsumed` are
dropped, the rest must match the module's keys and shapes exactly.  The
safetensors format is read here with `json` and numpy (an 8-byte
little-endian header length, a JSON header, raw little-endian data).

`from_jax_params` takes the JAX package's parameters as flax dicts of numpy
arrays and returns the diffusers/HF-named state_dicts of the port's UNet,
VAE and text encoder.  The layout rules are the inverse of those
`geodiffuser_tpu/models/weights.py` applies to a diffusers checkpoint:

    Dense kernel (in, out)             -> Linear weight (out, in)
    Conv kernel (kh, kw, in, out)      -> Conv2d weight (out, in, kh, kw)
    norm scale                         -> weight;  Embed embedding -> weight
    module names  down_blocks_0_resnets_1 -> down_blocks.0.resnets.1,
                  mid_block_attentions_0  -> mid_block.attentions.0,
                  to_out_0 -> to_out.0,  ff/net_0 -> ff.net.0,  mlp_fc1 -> mlp.fc1
"""

from __future__ import annotations

import functools
import json
import os
import pathlib
import re
import struct
from typing import TYPE_CHECKING, Dict

import numpy as np
import torch

from geodiffuser_tpu_torch.config import ModelConfig

if TYPE_CHECKING:
    from geodiffuser_tpu_torch.core.pipeline import Pipeline

_INDEXED = re.compile(
    r"(down_blocks|up_blocks|resnets|attentions|downsamplers|upsamplers|"
    r"transformer_blocks|to_out|net|layers)_(\d+)"
)


def _module_name(part: str) -> str:
    part = part.replace("mid_block_", "mid_block.").replace("mlp_fc", "mlp.fc")
    part = _INDEXED.sub(r"\1.\2", part)
    return re.sub(r"(\.\d+)_", r"\1.", part)


def _leaf(name: str, value: np.ndarray):
    if name == "kernel":
        if value.ndim == 4:
            return "weight", value.transpose(3, 2, 0, 1)
        return "weight", value.T
    if name in ("scale", "embedding"):
        return "weight", value
    return name, value


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _convert(tree: dict, rename=None) -> Dict[str, torch.Tensor]:
    tree = tree.get("params", tree)
    out = {}
    for path, value in _flatten(tree):
        value = np.array(value, np.float32)
        if rename is not None:
            special = rename(path, value)
            if special is not None:
                out[special[0]] = torch.from_numpy(np.ascontiguousarray(special[1]))
                continue
        leaf, value = _leaf(path[-1], value)
        name = ".".join(_module_name(p) for p in path[:-1]) + "." + leaf
        out[name] = torch.from_numpy(np.ascontiguousarray(value))
    return out


def _clip_rename(path, value):
    if path == ("token_embedding", "embedding"):
        return "text_model.embeddings.token_embedding.weight", value
    if path == ("position_embedding",):
        return "text_model.embeddings.position_embedding.weight", value
    leaf, value = _leaf(path[-1], value)
    if path[0].startswith("layers_"):
        mods = ("encoder",) + path[:-1]
    else:
        mods = path[:-1]
    return "text_model." + ".".join(_module_name(p) for p in mods) + "." + leaf, value


def from_jax_params(params_np: dict, config: ModelConfig) -> Dict[str, Dict[str, torch.Tensor]]:
    """{"unet", "vae", "text"} flax trees of numpy arrays -> the port's
    state_dicts (float32; `Pipeline.load_state_dicts` casts to the model
    type).  Raises ValueError when the trees were made for another
    architecture than `config`."""
    out = {
        "unet": _convert(params_np["unet"]),
        "vae": _convert(params_np["vae"]),
        "text": _convert(params_np["text"], _clip_rename),
    }
    got = (tuple(out["unet"]["conv_in.weight"].shape[:1]),
           tuple(out["text"]["text_model.embeddings.token_embedding.weight"].shape))
    want = ((config.block_out_channels[0],), (config.text_vocab_size, config.text_hidden_size))
    if got != want:
        raise ValueError(f"parameter trees are for another architecture: {got} != {want}")
    return out


# ---------------------------------------------------------------------------
# Checkpoint loading
# ---------------------------------------------------------------------------

MANIFESTS = pathlib.Path(__file__).resolve().parent / "manifests"
# component -> (file in the checkpoint directory, manifest)
COMPONENTS = {
    "unet": ("unet/diffusion_pytorch_model.safetensors", "sd14_unet.json"),
    "vae": ("vae/diffusion_pytorch_model.safetensors", "sd_vae.json"),
    "text": ("text_encoder/model.safetensors", "sd14_text_encoder.json"),
}
# safetensors dtype -> little-endian numpy dtype; BF16 is read as its bits
SAFETENSORS_DTYPES = {
    "F64": "<f8", "F32": "<f4", "F16": "<f2", "BF16": "<u2",
    "I64": "<i8", "I32": "<i4", "I16": "<i2", "I8": "i1", "U8": "u1", "BOOL": "?",
}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a .safetensors file, on the CPU, in its stored dtype
    (BF16 as `torch.bfloat16`).  Raises ValueError on a dtype outside
    `SAFETENSORS_DTYPES`."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = bytearray(f.read())
    header.pop("__metadata__", None)
    out = {}
    for name, info in header.items():
        if info["dtype"] not in SAFETENSORS_DTYPES:
            raise ValueError(f"{path}: tensor {name} has dtype {info['dtype']}; "
                             f"only {sorted(SAFETENSORS_DTYPES)} are read")
        dt = np.dtype(SAFETENSORS_DTYPES[info["dtype"]])
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        if end - begin != int(np.prod(shape)) * dt.itemsize:
            raise ValueError(f"{path}: tensor {name} spans {end - begin} bytes, not {shape}")
        arr = np.frombuffer(data, dt, count=int(np.prod(shape)), offset=begin).reshape(shape)
        if arr.ctypes.data % dt.itemsize:
            arr = arr.copy()
        if info["dtype"] == "BF16":
            out[name] = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            out[name] = torch.from_numpy(arr)
    return out


def read_state(path: str) -> Dict[str, torch.Tensor]:
    """A state_dict from a .safetensors file or a torch .bin/.pth (tensors
    only: `weights_only=True`; a {"state_dict": ...} wrapper is opened)."""
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and "state_dict" in state:
        state = state["state_dict"]
    return dict(state)


@functools.lru_cache(maxsize=None)
def unconsumed_keys(manifest: str) -> frozenset:
    """The keys a published checkpoint holds that no module consumes
    (e.g. the text encoder's `position_ids` buffer)."""
    with open(MANIFESTS / manifest) as f:
        return frozenset(json.load(f).get("unconsumed", ()))


def check_state_dict(module: torch.nn.Module, state: Dict[str, torch.Tensor], name: str) -> None:
    """Raise one ValueError listing the missing, extra and mis-shaped keys
    of `state` against `module` (JAX `_check_same_structure`)."""
    want = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in state.items()}
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    mismatched = sorted(k for k in set(want) & set(got) if want[k] != got[k])
    if missing or extra or mismatched:
        raise ValueError(
            f"{name} checkpoint mismatch:\n missing={missing[:8]}\n extra={extra[:8]}\n"
            f" shape-mismatch={[(k, want[k], got[k]) for k in mismatched[:8]]}")


def _component_path(checkpoint_dir: str, rel: str) -> str:
    path = os.path.join(checkpoint_dir, rel)
    if os.path.exists(path):
        return path
    alt = path.replace(".safetensors", ".bin")
    if os.path.exists(alt):
        return alt
    raise FileNotFoundError(f"missing {path}")


def load_sd_checkpoint(checkpoint_dir: str, pipeline: "Pipeline") -> Dict[str, Dict[str, torch.Tensor]]:
    """Load a diffusers-layout checkpoint into `pipeline`'s UNet, VAE and
    text encoder, each tensor cast to the model type
    (`Pipeline.load_state_dicts`).  Every component is read and checked
    before any is loaded.  Returns the state_dicts as read (CPU, stored
    dtypes)."""
    states = {}
    for name, (rel, manifest) in COMPONENTS.items():
        state = read_state(_component_path(checkpoint_dir, rel))
        drop = unconsumed_keys(manifest)
        states[name] = {k: v for k, v in state.items() if k not in drop}
    for name, module in pipeline.modules().items():
        check_state_dict(module, states[name], name)
    pipeline.load_state_dicts(states)
    return states


def load_vae_override(vae_dir: str, pipeline: "Pipeline") -> Dict[str, torch.Tensor]:
    """Load a standalone swap VAE into `pipeline` (the reference swaps the
    SD VAE for `stabilityai/sd-vae-ft-mse`, diffusion.py:126-128).
    `vae_dir` is a diffusers AutoencoderKL directory, its weights at its
    root or under `vae/`."""
    for rel in ("diffusion_pytorch_model.safetensors", "diffusion_pytorch_model.bin",
                "vae/diffusion_pytorch_model.safetensors", "vae/diffusion_pytorch_model.bin"):
        path = os.path.join(vae_dir, rel)
        if os.path.exists(path):
            break
    else:
        raise FileNotFoundError(f"no VAE weights under {vae_dir}")
    drop = unconsumed_keys(COMPONENTS["vae"][1])
    state = {k: v for k, v in read_state(path).items() if k not in drop}
    check_state_dict(pipeline.vae, state, "vae-override")
    pipeline.load_state_dicts({"vae": state})
    return state
