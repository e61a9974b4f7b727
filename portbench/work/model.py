"""The work of a window, counted from the configuration's widths, the image
size and the reference algorithm's schedule, never from what the program
launched: model FLOPs for `mfu`, and the attention and removal-correlation
work that the flash and correlation rooflines divide.

Model FLOPs are the matmul and convolution FLOPs of the reference's plain
modules, counted by `torch.utils.flop_counter` on the meta device (two per
multiply-add): a UNet forward per stream, the VAE encode and decode per
image and the text encoder per prompt.  The edit schedule is the
reference's (`reference/gd/core/editor.py:step_plan`): an inversion step is
one stream per edit (two with guidance), an optimize step a taps pass and an
edit pass of one stream each and the edit pass's backward at twice the
forward, a CFG step after an optimize step two streams and any other CFG
step three.
"""

from __future__ import annotations

import functools
from typing import Dict, List

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import program
from portbench.work import attention


@functools.lru_cache(maxsize=8)
def _flops(model_key: tuple, image_size: int) -> Dict[str, float]:
    from portbench.reference.gd import config as ref_cfg
    from portbench.reference.gd.core.pipeline import MODULES

    model = {k: list(v) if isinstance(v, tuple) else v for k, v in model_key}
    cfg = program.model_config(ref_cfg, model, "float32")
    lat = image_size // 8
    out = {}
    with torch.device("meta"):
        mods = {name: cls(cfg) for name, cls in MODULES.items()}
        calls = {
            "unet": lambda: mods["unet"](torch.zeros(1, lat, lat, cfg.in_channels), 500,
                                         torch.zeros(1, cfg.text_max_length,
                                                     cfg.cross_attention_dim)),
            "vae_encode": lambda: mods["vae"].encode(torch.zeros(1, image_size, image_size, 3)),
            "vae_decode": lambda: mods["vae"].decode(
                torch.zeros(1, lat, lat, cfg.vae_latent_channels)),
            "text": lambda: mods["text"](torch.zeros(1, cfg.text_max_length, dtype=torch.long)),
        }
        for name, call in calls.items():
            with FlopCounterMode(display=False) as counter:
                call()
            out[name] = float(counter.get_total_flops())
    return out


def model_flops(config: Dict) -> Dict[str, float]:
    """FLOPs of one UNet stream, one VAE encode and decode, one text encode."""
    key = tuple(sorted((k, tuple(v) if isinstance(v, list) else v)
                       for k, v in config["model"].items()))
    return _flops(key, config["image_size"])


def edit_group_work(config: Dict, cfg, plans: List[Dict], edits: int, rows: List[Dict],
                    full_blend: List[bool]) -> Dict[str, float]:
    """The work of lockstep groups of `edits` edits each: `rows` holds each
    edit's live rows per loss resolution ({"inpaint": {res: n}, "warped":
    {res: n}}), `full_blend` each group's choice of the CFG steps' blend."""
    f = model_flops(config)
    groups = len(full_blend)
    guided = cfg.prompt != cfg.uncond_text
    inv_streams = len(plans) * (2 if guided else 1)
    opt_steps = sum(p["optimize"] for p in plans)
    fwd_streams = inv_streams + opt_steps * (1 + 1 + 2) + opt_steps * 2 + (len(plans) - opt_steps) * 3
    per_edit = fwd_streams * f["unet"] + f["vae_encode"] + 2 * f["vae_decode"]
    texts = 2 * groups
    mode = "remover" if cfg.edit_type == "geometry_remover" else "editor"
    fa = attention.unet_self_attention(config)
    flash = {"flops": 0.0, "bytes": 0.0}
    for n, r in enumerate(rows):
        full, blends = attention.edit_flash_maps(mode, plans, guided, full_blend[n // edits])
        fr = attention.unet_self_attention(config, r["warped"])
        for k in flash:
            flash[k] += full * fa[k] + blends * fr[k]
    corr = attention.removal_correlation(config, cfg, [r["inpaint"] for r in rows], opt_steps)
    return dict(
        model_flops=groups * edits * per_edit + texts * f["text"],
        flash_flops=flash["flops"], flash_bytes=flash["bytes"],
        corr_flops=corr["flops"], corr_bytes=corr["bytes"],
    )


def dift_work(config: Dict, images: int) -> Dict[str, float]:
    """The work of `images` DIFT featurizations: a VAE encode, a text
    encode and `ensemble` UNet streams each."""
    f = model_flops(config)
    n = config["dift"]["ensemble"]
    fa = attention.unet_self_attention(config)
    return dict(
        model_flops=images * (f["vae_encode"] + f["text"] + n * f["unet"]),
        flash_flops=images * n * fa["flops"], flash_bytes=images * n * fa["bytes"],
    )
