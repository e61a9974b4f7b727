"""`portbench/work/` against counts made by hand at tiny sizes."""

import dataclasses

import pytest

from portbench.work import attention, model

TINY = {
    "block_out_channels": [32, 64, 64, 64], "layers_per_block": 1, "num_attention_heads": 2,
    "attention_head_dims": None, "transformer_layers_per_block": 1, "text_max_length": 77,
}


def test_unet_levels_follow_the_unet():
    # per level: the down block's attentions, the up block's (one more), the
    # mid block's at the last level
    levels = attention.unet_levels(TINY, 64)
    assert levels == [(8, 2, 16, 3), (4, 2, 32, 3), (2, 2, 32, 3), (1, 2, 32, 1)]
    sd14 = attention.unet_levels(dict(TINY, block_out_channels=[320, 640, 1280, 1280],
                                      layers_per_block=2, num_attention_heads=8), 512)
    assert sd14 == [(64, 8, 40, 5), (32, 8, 80, 5), (16, 8, 160, 5), (8, 8, 160, 1)]
    sd21 = attention.unet_levels(dict(TINY, block_out_channels=[320, 640, 1280, 1280],
                                      layers_per_block=2, attention_head_dims=[5, 10, 20, 20]), 512)
    assert [(r, h, d) for r, h, d, _ in sd21] == [(64, 5, 64), (32, 10, 64), (16, 20, 64), (8, 20, 64)]


def test_flash_work_by_hand():
    config = {"dtype": "bfloat16", "image_size": 512,
              "model": dict(TINY, block_out_channels=[320, 640, 1280, 1280], layers_per_block=2,
                            num_attention_heads=8)}
    work = attention.unet_self_attention(config)
    # 64^2 (L 4096, 8 heads of 40) and 32^2 (L 1024, 8 heads of 80), five layers each;
    # 16^2 and 8^2 have fewer than 1024 keys
    flops = 5 * 4 * 8 * 4096 * 4096 * 40 + 5 * 4 * 8 * 1024 * 1024 * 80
    n_bytes = 5 * (2 * 4 * 8 * 4096 * 40 + 4 * 8 * 4096) + 5 * (2 * 4 * 8 * 1024 * 80 + 4 * 8 * 1024)
    assert work == {"flops": flops, "bytes": n_bytes}


def test_warped_row_maps_by_hand():
    config = {"dtype": "bfloat16", "image_size": 512,
              "model": dict(TINY, block_out_channels=[320, 640, 1280, 1280], layers_per_block=2,
                            num_attention_heads=8)}
    # 300 query rows against 4096 keys at 64^2, 70 against 1024 at 32^2
    work = attention.unet_self_attention(config, {64: 300, 32: 70})
    flops = 5 * 4 * 8 * 300 * 4096 * 40 + 5 * 4 * 8 * 70 * 1024 * 80
    n_bytes = (5 * (2 * 8 * (2 * 300 + 2 * 4096) * 40 + 4 * 8 * 300)
               + 5 * (2 * 8 * (2 * 70 + 2 * 1024) * 80 + 4 * 8 * 70))
    assert work == {"flops": flops, "bytes": n_bytes}


def test_edit_flash_maps_follow_the_schedule():
    from portbench.reference.gd import config as ref_cfg
    from portbench.reference.gd.core import editor

    cfg = ref_cfg.EditConfig()
    plans = [editor.step_plan(cfg, i) for i in range(50)]
    # 50 steps: optimize at 0, 2, ..., 32 (17), self-replace window below 47,
    # past the object step from 45.  Inversion 50 maps; an optimize step 4
    # (taps pass; tap, edit stream, warped queries), its CFG step and the 33
    # others 3 (two vanilla streams, the edit stream) and, before step 45, a
    # warped-row map (the full warped map with the full-row blend)
    assert attention.edit_flash_maps("editor", plans, False, False) == (50 + 17 * 4 + 50 * 3, 45)
    assert attention.edit_flash_maps("editor", plans, False, True) == (50 + 17 * 4 + 50 * 3 + 45, 0)
    assert attention.edit_flash_maps("editor", plans, True, False) == (100 + 17 * 4 + 50 * 3, 45)
    # the remover: no warped queries; the identity map at steps 45 and 46
    assert attention.edit_flash_maps("remover", plans, False, False) == (50 + 17 * 3 + 50 * 3 + 2, 0)


def test_correlation_work_by_hand():
    config = {"dtype": "bfloat16", "image_size": 64, "model": TINY}
    # one edit with 10 live rows at 8^2 (L 64): a self layer (Lk 64) and a
    # cross layer (Lk 77), three layers, two heads of 16, two optimize steps
    work = attention.removal_correlation(config, None, [{8: 10}], 2)
    per_head = sum(2 * (10 * lk * 16 + 64 * lk * 16 + 10 * 64 * lk) for lk in (64, 77))
    assert work["flops"] == 2 * 3 * 2 * per_head
    per_head_bytes = sum(2 * (10 * 16 + 2 * lk * 16 + 64 * 16) + 4 * (2 * 64 + 5 * 10)
                         for lk in (64, 77))
    assert work["bytes"] == 2 * 3 * 2 * per_head_bytes


def _tiny_config():
    from geodiffuser_tpu_torch.config import ModelConfig

    m = dataclasses.asdict(ModelConfig.tiny())
    m.pop("dtype")
    return {"model": m, "image_size": 64, "dtype": "float32"}


def test_text_encoder_flops_by_hand():
    f = model.model_flops(_tiny_config())
    h, l, layers = 32, 77, 2
    per_layer = (4 * 2 * l * h * h          # q, k, v, out projections
                 + 2 * 2 * l * h * 4 * h    # the MLP
                 + 2 * 2 * l * l * h)       # q k^T and p v
    assert f["text"] == layers * per_layer


def test_edit_group_work_counts_the_schedule():
    from portbench.reference.gd import config as ref_cfg
    from portbench.reference.gd.core import editor

    config = _tiny_config()
    cfg = ref_cfg.EditConfig(num_ddim_steps=6, image_size=64)
    plans = [editor.step_plan(cfg, i) for i in range(6)]
    f = model.model_flops(config)
    rows = [{"inpaint": {8: 3}, "warped": {8: 2}}, {"inpaint": {8: 4}, "warped": {8: 5}}] * 3
    work = model.edit_group_work(config, cfg, plans, 2, rows, [False] * 3)
    # optimize steps 0 and 2: each a taps pass, an edit pass and its backward
    # (4 streams) and a CFG step of 2 streams; the other four steps 3 streams;
    # the inversion 6 steps of 1 stream (the prompt is the unconditional text)
    streams = 6 + 2 * (4 + 2) + 4 * 3
    per_edit = streams * f["unet"] + f["vae_encode"] + 2 * f["vae_decode"]
    assert work["model_flops"] == pytest.approx(3 * 2 * per_edit + 3 * 2 * f["text"])
