"""Attention and removal-correlation work from the configuration's widths.

Each input is counted once and each output once, in the model type; the
operations are two per multiply-add.  The flash roofline's work is the
UNet's self-attention at maps of 1024 keys or more (the 64^2 and 32^2
levels at 512^2): one softmax(q k^T) v per stream and layer, and in an
edit the edited attention's maps as the reference's schedule runs them
(`edit_flash_maps`); the removal correlation's is that of the live inpaint
rows of each edit at each loss resolution.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

FLASH_MIN_KEYS = 1024
BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def unet_levels(model: Dict, image_size: int):
    """(resolution, heads, head width, attention layers) of each UNet level
    that has attention: the down blocks but the last, the mid block, and the
    up blocks but the first (`models/unet.py`)."""
    chans = model["block_out_channels"]
    n = len(chans)
    per_block = model.get("transformer_layers_per_block", 1)
    heads = model.get("attention_head_dims") or [model["num_attention_heads"]] * n
    out = []
    for level in range(n):
        layers = 0
        if level < n - 1:
            layers += model["layers_per_block"] + model["layers_per_block"] + 1
        else:
            layers += 1
        res = image_size // 8 // 2 ** level
        out.append((res, heads[level], chans[level] // heads[level], layers * per_block))
    return out


def unet_self_attention(config: Dict, rows: Optional[Dict[int, int]] = None) -> Dict[str, float]:
    """Flash work of one UNet stream, {"flops", "bytes"}: full maps, or
    with `rows` maps of that many query rows at each resolution (q and the
    output of those rows, k and v whole)."""
    e = BYTES[config["dtype"]]
    flops = n_bytes = 0.0
    for res, h, d, layers in unet_levels(config["model"], config["image_size"]):
        l = res * res
        if l < FLASH_MIN_KEYS:
            continue
        lq = l if rows is None else rows.get(res, 0)
        flops += layers * 4.0 * h * lq * l * d
        n_bytes += layers * (e * 2.0 * h * (lq + l) * d + 4.0 * h * lq)
    return {"flops": flops, "bytes": n_bytes}


def edit_flash_maps(mode: str, plans: List[Dict], guided: bool, full_blend: bool) -> Tuple[int, int]:
    """(full maps, warped-row maps) that one edit's self-attention layer
    runs over the reference's schedule (`reference/gd/core/editor.py`,
    `edit_attention.py`).  The inversion runs a map a stream.  An optimize
    step runs the base stream's taps pass, then in its edit pass the tap
    again and the edit stream.  A CFG step runs two vanilla streams and the
    edit stream.  The edit stream runs one map outside the self-replace
    window; inside it the remover adds the identity map past the object
    step, and the editor adds the warped queries' map (over the rows of the
    warped mask in a CFG step before the object step, over all rows with
    `full_blend` or in an optimize step; none in a CFG step past the
    object step)."""
    full = len(plans) * (2 if guided else 1)
    rows = 0
    for p in plans:
        window, past = p["self_window"], p["past_obj"]
        for losses in ((True, False) if p["optimize"] else (False,)):
            # the taps pass and the tap again, or two vanilla streams; the edit stream
            full += 3
            if not window:
                continue
            if mode == "remover":
                full += past
            elif losses or (not past and full_blend):
                full += 1
            elif not past:
                rows += 1
    return full, rows


def removal_correlation(config: Dict, cfg, live_rows: List[Dict[int, int]],
                        opt_steps: int) -> Dict[str, float]:
    """Correlation work of `opt_steps` optimize steps of each edit whose
    live rows per loss resolution are `live_rows` (one dict an edit).  Each
    self and cross layer at a loss resolution takes, per head and live row
    set K, P_e = softmax(q_e k^T) (K x Lk), P_b = softmax(q_b k_b^T)
    (L x Lk) and corr = P_e P_b^T (K x L)."""
    e = BYTES[config["dtype"]]
    ctx = config["model"]["text_max_length"]
    flops = n_bytes = 0.0
    for res, h, d, layers in unet_levels(config["model"], config["image_size"]):
        l = res * res
        for rows in live_rows:
            k = rows.get(res)
            if not k:
                continue
            for lk in (l, ctx):    # the self layer, then the cross layer
                flops += layers * h * 2.0 * (k * lk * d + l * lk * d + k * l * lk)
                n_bytes += layers * h * (e * (k * d + 2 * lk * d + l * d) + 4.0 * (2 * l + 5 * k))
    return {"flops": opt_steps * flops, "bytes": opt_steps * n_bytes}
