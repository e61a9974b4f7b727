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
dropped (SD-1.x's or SD-2.1's manifests, by the configuration:
`components`), the rest must match the module's keys and shapes exactly.
`convert_clip_vision` does the same for the CLIP ViT-B/32 vision tower, and
`read_checkpoint` / `load_perception_model` for the published SAM, Depth
Anything, DPT, MiDaS and ZoeDepth-NK files, each against its manifest.  The
safetensors format is read here with `json` and numpy (an 8-byte
little-endian header length, a JSON header, raw little-endian data).

`from_jax_params` takes the JAX package's parameters as flax dicts of numpy
arrays and returns the diffusers/HF-named state_dicts of the port's UNet,
VAE and text encoder (`sam_from_jax_params` and
`depth_anything_from_jax_params` those of the perception models).  The
layout rules are the inverse of those `geodiffuser_tpu/models/weights.py`
applies to a diffusers checkpoint:

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
# component -> (file in the checkpoint directory, manifest): SD-1.x
COMPONENTS = {
    "unet": ("unet/diffusion_pytorch_model.safetensors", "sd14_unet.json"),
    "vae": ("vae/diffusion_pytorch_model.safetensors", "sd_vae.json"),
    "text": ("text_encoder/model.safetensors", "sd14_text_encoder.json"),
}
# SD-2.1 (stabilityai/stable-diffusion-2-1): the same files and VAE
COMPONENTS_SD21 = dict(
    COMPONENTS,
    unet=(COMPONENTS["unet"][0], "sd21_unet.json"),
    text=(COMPONENTS["text"][0], "sd21_text_encoder.json"),
)
CLIP_VISION_MANIFEST = "clip_vision_vitb32.json"


def components(config: ModelConfig) -> dict:
    """The checkpoint files and manifests of `config`'s architecture:
    SD-2.x (Linear transformer projections) or SD-1.x."""
    return COMPONENTS_SD21 if config.use_linear_projection else COMPONENTS
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
    """A state_dict from a .safetensors file or a torch .bin/.pth/.pt (tensors
    only: `weights_only=True`; a {"state_dict": ...} or {"model": ...}
    wrapper, as ZoeDepth's and DPT's releases have, is opened)."""
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    state = torch.load(path, map_location="cpu", weights_only=True)
    for wrapper in ("state_dict", "model"):
        if isinstance(state, dict) and wrapper in state:
            state = state[wrapper]
    return dict(state)


@functools.lru_cache(maxsize=None)
def unconsumed_keys(manifest: str) -> frozenset:
    """The keys a published checkpoint holds that no module consumes
    (e.g. the text encoder's `position_ids` buffer)."""
    with open(MANIFESTS / manifest) as f:
        return frozenset(json.load(f).get("unconsumed", ()))


def read_checkpoint(path: str, manifest: str) -> Dict[str, torch.Tensor]:
    """The published file at `path` (`read_state`) as a state_dict under its
    published names, the keys `manifest` marks `unconsumed` dropped."""
    drop = unconsumed_keys(manifest)
    return {k: v for k, v in read_state(path).items() if k not in drop}


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
    for name, (rel, manifest) in components(pipeline.config).items():
        states[name] = read_checkpoint(_component_path(checkpoint_dir, rel), manifest)
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
    state = read_checkpoint(path, COMPONENTS["vae"][1])
    check_state_dict(pipeline.vae, state, "vae-override")
    pipeline.load_state_dicts({"vae": state})
    return state


def convert_clip_vision(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """An HF CLIPVisionModel(WithProjection) state_dict (ViT-B/32:
    `vision_model.…` and `visual_projection.weight`) as the port's
    `CLIPVisionEncoder` takes it: the keys the manifest marks `unconsumed`
    (the `position_ids` buffer) dropped; the port's module carries the HF
    names.  Counterpart of the JAX `convert_clip_vision`."""
    drop = unconsumed_keys(CLIP_VISION_MANIFEST)
    return {k: v for k, v in state.items() if k not in drop}


# ---------------------------------------------------------------------------
# Perception models: SAM and Depth Anything
# ---------------------------------------------------------------------------

def load_perception_model(module: torch.nn.Module, state: Dict[str, torch.Tensor],
                          name: str) -> None:
    """Check `state` against `module` (one ValueError listing every missing,
    extra and mis-shaped key) and load it, strictly, cast to the module's
    parameter type on its device."""
    check_state_dict(module, state, name)
    ref = next(module.parameters())
    module.load_state_dict({k: v.to(ref.device, ref.dtype) for k, v in state.items()},
                           strict=True)


_SAM_RENAMES = [
    (r"^image_encoder\.patch_embed_proj\.", "image_encoder.patch_embed.proj."),
    (r"\.blocks_(\d+)\.", r".blocks.\1."),
    (r"\.mlp_lin(\d)\.", r".mlp.lin\1."),
    (r"\.neck_(\d)\.", r".neck.\1."),
    (r"^mask_decoder\.(layers_\d+|final_attn_token_to_image|norm_final_attn)\.",
     r"mask_decoder.transformer.\1."),
    (r"\.layers_(\d+)\.", r".layers.\1."),
    (r"\.upscale_(\d)\.", r".output_upscaling.\1."),
    (r"\.hyper_(\d+)_lin(\d)\.", r".output_hypernetworks_mlps.\1.layers.\2."),
    (r"\.iou_lin(\d)\.", r".iou_prediction_head.layers.\1."),
]
# JAX leaves renamed whole, the vectors made nn.Embedding rows
_SAM_SPECIAL = {
    "prompt_encoder.pe_gaussian": "prompt_encoder.pe_layer.positional_encoding_gaussian_matrix",
    "prompt_encoder.not_a_point_embed": "prompt_encoder.not_a_point_embed.weight",
    "prompt_encoder.no_mask_embed": "prompt_encoder.no_mask_embed.weight",
    "mask_decoder.iou_token": "mask_decoder.iou_token.weight",
    "mask_decoder.mask_tokens": "mask_decoder.mask_tokens.weight",
    **{f"prompt_encoder.point_embed_{i}": f"prompt_encoder.point_embeddings.{i}.weight"
       for i in range(4)},
}
_DEPTH_ANYTHING_RENAMES = [
    (r"^pretrained\.patch_embed_proj\.", "pretrained.patch_embed.proj."),
    (r"\.blocks_(\d+)\.", r".blocks.\1."),
    (r"\.attn_(qkv|proj)\.", r".attn.\1."),
    (r"\.mlp_fc(\d)\.", r".mlp.fc\1."),
    (r"\.ls(\d)_gamma$", r".ls\1.gamma"),
    (r"^depth_head\.(projects|resize_layers)_(\d)\.", r"depth_head.\1.\2."),
    (r"^depth_head\.(layer\d_rn|refinenet\d|output_conv\d)", r"depth_head.scratch.\1"),
    (r"\.output_conv2_(\d)\.", r".output_conv2.\1."),
]


def _renamed(name: str, renames) -> str:
    for pattern, repl in renames:
        name = re.sub(pattern, repl, name)
    return name


def _perception_from_jax(tree: dict, renames, special=None) -> Dict[str, torch.Tensor]:
    """`renames`: (pattern, replacement) pairs applied in order to each
    dotted JAX name, or a function of that name."""
    tree = tree.get("params", tree)
    out = {}
    for path, value in _flatten(tree):
        value = np.array(value, np.float32)
        dotted = ".".join(path)
        if special and dotted in special:
            name = special[dotted]
            value = value.reshape(-1, value.shape[-1])
        else:
            leaf, value = _leaf(path[-1], value)
            name = ".".join(path[:-1] + (leaf,))
            name = renames(name) if callable(renames) else _renamed(name, renames)
        out[name] = torch.from_numpy(np.ascontiguousarray(value))
    return out


def sam_from_jax_params(tree: dict) -> Dict[str, torch.Tensor]:
    """The JAX package's `Sam` parameters (a flax dict of numpy arrays) as the
    port's `Sam` state_dict: the inverse of `geodiffuser_tpu/models/weights.py:
    convert_sam` (Dense and Conv kernels transposed back; ConvTranspose
    kernels (kh, kw, out, in) -> (in, out, kh, kw); the point embeddings
    (dim,) -> nn.Embedding rows (1, dim))."""
    return _perception_from_jax(tree, _SAM_RENAMES, _SAM_SPECIAL)


def depth_anything_from_jax_params(tree: dict) -> Dict[str, torch.Tensor]:
    """The JAX package's `DepthAnything` parameters as the port's state_dict:
    the inverse of `geodiffuser_tpu/models/weights.py:convert_depth_anything`."""
    return _perception_from_jax(tree, _DEPTH_ANYTHING_RENAMES)


# ---------------------------------------------------------------------------
# Depth backends: MiDaS DPT-Large / DPT-Hybrid / v2.1, ZoeDepth, ZoeDepth-NK
# ---------------------------------------------------------------------------

def _post(n: int, part: str) -> str:
    return f"pretrained.act_postprocess{n + 1}.{part}."


# the JAX DPT trees' names (geodiffuser_tpu/models/midas_dpt.py) -> the
# published ones: the inverse of convert_dpt_large / convert_dpt_hybrid /
# convert_midas_v21 and of the core part of convert_zoedepth_nk
_DPT_RENAMES = [
    (r"^patch_embed_proj\.", "pretrained.model.patch_embed.proj."),
    (r"^(cls_token|pos_embed)$", r"pretrained.model.\1"),
    (r"^blocks_(\d+)\.", r"pretrained.model.blocks.\1."),
    (r"\.attn_(qkv|proj)\.", r".attn.\1."),
    (r"\.mlp_fc(\d)\.", r".mlp.fc\1."),
    (r"^readout_(\d)\.", lambda m: _post(int(m[1]), "0.project.0")),
    (r"^projects_(\d)\.", lambda m: _post(int(m[1]), "3")),
    (r"^resize_layers_(\d)\.", lambda m: _post(int(m[1]), "4")),
    (r"^(layer\d_rn|refinenet\d)\.", r"scratch.\1."),
    (r"^head_conv(\d)\.", lambda m: f"scratch.output_conv.{2 * int(m[1]) - 2}."),
    # DPT-Hybrid's ResNetV2 stem
    (r"^stem_conv\.", "pretrained.model.patch_embed.backbone.stem.conv."),
    (r"^stem_norm\.", "pretrained.model.patch_embed.backbone.norm."),
    (r"^stages_(\d)_blocks_(\d+)\.",
     r"pretrained.model.patch_embed.backbone.stages.\1.blocks.\2."),
    (r"\.downsample_conv\.", ".downsample.conv."),
]
# MiDaS v2.1: the stem and ResNet layer1 in one Sequential, frozen BatchNorm
_MIDAS_V21_RENAMES = [
    (r"^conv1\.", "pretrained.layer1.0."),
    (r"^bn1\.", "pretrained.layer1.1."),
    (r"^layer1_(\d+)\.", r"pretrained.layer1.4.\1."),
    (r"^layer([234])_(\d+)\.", r"pretrained.layer\1.\2."),
    (r"\.downsample_conv\.", ".downsample.0."),
    (r"\.downsample_bn\.", ".downsample.1."),
    (r"\.mean$", ".running_mean"),
    (r"\.var$", ".running_var"),
    (r"^(layer\d_rn|refinenet\d)\.", r"scratch.\1."),
    (r"^head_conv(\d)\.", lambda m: f"scratch.output_conv.{2 * int(m[1]) - 2}."),
]
# the metric heads of ZoeDepth and ZoeDepth-NK (zoedepth_nk.py:502-513)
_ZOE_HEAD_RENAMES = [
    (r"\.net_(\d)\.", r"._net.\1."),
    (r"\.mlp_(\d)\.", r".mlp.\1."),
    (r"^(projectors|attractors)_(\d)\.", r"\1.\2."),
    (r"^(seed_bin_regressors|conditional_log_binomial)_(nyu|kitti)\.", r"\1.\2."),
    (r"^attractors_(nyu|kitti)_(\d)\.", r"attractors.\1.\2."),
    (r"^mlp_classifier_(\d)\.", r"mlp_classifier.\1."),
    (r"^patch_transformer\.layers_(\d)\.", r"patch_transformer.transformer_encoder.layers.\1."),
    (r"\.layers\.(\d)\.(in_proj_weight|in_proj_bias|out_proj)", r".layers.\1.self_attn.\2"),
]


def _zoe_name(name: str) -> str:
    if name.startswith("core."):
        return "core.core." + _renamed(name[len("core."):], _DPT_RENAMES)
    return _renamed(name, _ZOE_HEAD_RENAMES)


def dpt_large_from_jax_params(tree: dict) -> Dict[str, torch.Tensor]:
    """The JAX package's `DPTLarge` or `DPTHybrid` (any variant) parameters
    as the port's state_dict (the published names): the inverse of
    `convert_dpt_large` and `convert_dpt_hybrid`."""
    return _perception_from_jax(tree, _DPT_RENAMES)


# the hybrid's tree is the ViT's plus its ResNetV2 stem, which `_DPT_RENAMES`
# also maps: one bridge serves both, under each model's name
dpt_hybrid_from_jax_params = dpt_large_from_jax_params


def midas_v21_from_jax_params(tree: dict) -> Dict[str, torch.Tensor]:
    """The JAX `MidasNetV21` parameters as the port's state_dict: the inverse
    of `convert_midas_v21` (FrozenBatchNorm's mean and var as the running
    statistics)."""
    return _perception_from_jax(tree, _MIDAS_V21_RENAMES)


def zoedepth_from_jax_params(tree: dict) -> Dict[str, torch.Tensor]:
    """The JAX single-head `ZoeDepth` parameters as the port's state_dict
    (published ZoeDepth names; no published file of this model exists)."""
    return _perception_from_jax(tree, _zoe_name)


def _split_qkv(tree):
    """BEiT's fused `qkv_kernel` leaf as a `qkv` Dense, so that it is
    transposed as a kernel."""
    if not isinstance(tree, dict):
        return tree
    return {("qkv" if k == "qkv_kernel" else k): ({"kernel": v} if k == "qkv_kernel"
                                                  else _split_qkv(v))
            for k, v in tree.items()}


def zoedepth_nk_from_jax_params(tree: dict) -> Dict[str, torch.Tensor]:
    """The JAX `ZoeDepthNK` parameters as the port's state_dict (ZoeD-M12-NK's
    names): the inverse of `convert_zoedepth_nk`."""
    return _perception_from_jax(_split_qkv(tree.get("params", tree)), _zoe_name)
