"""Tiny versions of the benchmark's cells for CPU tests: the port's tiny
models in float32 at 64^2, groups of two edits at six DDIM steps, two DIFT
draws."""

from __future__ import annotations

import dataclasses
import json

from portbench import run

TINY_STEPS = 6


def cell(name: str):
    """(workload, configuration, traffic) of cell `name` cut to the tiny size."""
    from geodiffuser_tpu_torch.config import ModelConfig

    bench = run.benchmark()
    workload, config, traffic = run.cell_files(bench, name)
    config = json.loads(json.dumps(config))
    model = dataclasses.asdict(ModelConfig.tiny_sd21() if "dift" in config else ModelConfig.tiny())
    model.pop("dtype")
    config.update(model=model, dtype="float32", image_size=64)
    if "edit" in config:
        config["edit"]["num_ddim_steps"] = TINY_STEPS
    if "dift" in config:
        config["dift"]["ensemble"] = 2
    traffic = dict(traffic, pool=2)
    if "group_size" in traffic:
        traffic["group_size"] = 2
    if "check_images" in traffic:
        traffic["check_images"] = 2
    return workload, config, traffic
