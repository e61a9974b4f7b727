"""JAX parameter trees -> the port's state_dicts.

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

import re
from typing import Dict

import numpy as np
import torch

from geodiffuser_tpu_torch.config import ModelConfig

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
