"""Batch edit driver: sweep a tree of experiment folders (the reference's
large_scale_editor.py, rebuilt): the port of
`geodiffuser_tpu/parallel/driver.py`.

    python -m geodiffuser_tpu_torch.parallel.driver EXP_ROOT \\
        [--checkpoint-dir DIR] [--steps N] [--size 512] [--device cuda]

Every `EXP_ROOT/<category>/<n>/` folder is routed by its category
(`exp_io.edit_type_for_category`) to the editor, the remover or the stitch,
run with the reference's tuned per-type configuration
(perform_exp, large_scale_editor.py:199-317), and gets result_ls.png and
loss_log.json beside its inputs.  Over the reference sweep
(large_scale_editor.py:320-402): folders with a result are skipped (resume),
one session per edit type is reused across its edits, each folder caches its
DDIM inversion, the native prefetcher decodes the next folders while the
card runs the current edit, and processes named by GEODIFF_NUM_PROCESSES /
GEODIFF_PROCESS_ID split the folders between them.  Edits run one at a
time: the JAX package's lockstep group of edits (`--group-size` > 1) is not
ported yet.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import subprocess
import time
from typing import Dict, Optional

import numpy as np

from geodiffuser_tpu_torch.config import EDITOR_LOSS_WEIGHTS, EditConfig, ModelConfig, SplatConfig
from geodiffuser_tpu_torch.parallel import sharding
from geodiffuser_tpu_torch.utils import exp_io

log = logging.getLogger("geodiffuser_tpu_torch.driver")

# Tuned per-type configs (large_scale_editor.py:199-317)
REMOVER_SWEEP_WEIGHTS = {
    "self": {"sim": 55.0, "movement": 0.0, "removal": 4.6, "smoothness": 30.0, "amodal": 0.0},
    "cross": {"sim": 45.0, "movement": 0.0, "removal": 4.6, "smoothness": 15.0, "amodal": 0.0},
}


def config_for_edit_type(edit_type: str, num_ddim_steps: int = 50) -> EditConfig:
    if edit_type == "geometry_remover":
        return EditConfig(
            edit_type=edit_type,
            num_ddim_steps=num_ddim_steps,
            guidance_scale=5.0,
            optimize_steps=0.85,
            latent_replace=0.4,
            cross_replace_steps=0.9,
            self_replace_steps=0.9,
            obj_edit_step=1.0,
            skip_optim_steps=2,
            loss_weights=REMOVER_SWEEP_WEIGHTS,
        )
    if edit_type == "geometry_stitch":
        # tuned stitch block (large_scale_editor.py:233-246): lr 0.03,
        # latent_replace 0.2, softer splat (tau 0.1, radius 1.0, ppp 30);
        # the rest inherit perform_exp's defaults (optimize 0.85,
        # cross/self replace 0.9, obj_edit 1.0, guidance 5.0,
        # large_scale_editor.py:199-212).  Weights: config.STITCH_LOSS_WEIGHTS.
        return EditConfig(
            edit_type=edit_type,
            num_ddim_steps=num_ddim_steps,
            guidance_scale=5.0,
            lr=0.03,
            optimize_steps=0.85,
            latent_replace=0.2,
            cross_replace_steps=0.9,
            self_replace_steps=0.9,
            obj_edit_step=1.0,
            skip_optim_steps=2,
            splat=SplatConfig(radius=1.0, tau=0.1, points_per_pixel=30),
        )
    return EditConfig(
        edit_type="geometry_editor",
        num_ddim_steps=num_ddim_steps,
        guidance_scale=3.0,
        optimize_steps=0.65,
        latent_replace=0.1,
        cross_replace_steps=0.95,
        self_replace_steps=0.95,
        obj_edit_step=0.9,
        skip_optim_steps=2,
        loss_weights=EDITOR_LOSS_WEIGHTS,
    )


def _experiment_loader(folders, use_native: Optional[bool]):
    """Iterator of Experiments over `folders`, in order.

    Default (use_native=None): the native C++ prefetcher (exp_loader.cpp),
    whose threads decode experiment k+1 while the card runs k, or the
    synchronous Python reader if the native library cannot build or load.
    use_native=True takes the native prefetcher (raises on failure); False
    the Python reader."""
    if use_native is False:
        return (exp_io.read_exp(f) for f in folders)
    try:
        from geodiffuser_tpu_torch.native.loader import NativePrefetcher

        return NativePrefetcher(list(folders), threads=2)
    except (OSError, subprocess.CalledProcessError) as err:   # no g++, zlib or library
        if use_native:
            raise
        log.info("native prefetcher unavailable (%s); using python reader", err)
        return (exp_io.read_exp(f) for f in folders)


def edit_inputs(edit_type: str, exp: exp_io.Experiment, cfg: EditConfig, device="cuda"):
    """(image, depth, mask, transform) of an experiment's edit.  Stitch
    experiments (background_image.png present) are pre-composited on
    `device`, the warped object pasted onto the background, and run as an
    identity-transform edit on the warped mask (perform_stitch)."""
    if edit_type == "geometry_stitch" and exp.background_image is not None:
        from geodiffuser_tpu_torch.core.editor import stitch_composite

        comp, wmask = stitch_composite(cfg, exp.background_image, exp.input_image,
                                       exp.input_mask, exp.depth, exp.transform, device=device)
        h, w = comp.shape[:2]
        return comp, np.full((h, w), 0.5, np.float32), wmask, np.eye(4, dtype=np.float32)
    return exp.input_image, exp.depth, exp.input_mask, exp.transform


def run_folder_sweep(
    exp_root: str,
    checkpoint_dir: Optional[str] = None,
    num_ddim_steps: int = 50,
    image_size: int = 512,
    skip_existing: bool = True,
    group_size: Optional[int] = None,
    limit: Optional[int] = None,
    pipe=None,
    config_overrides: Optional[Dict] = None,
    use_native: Optional[bool] = None,
    device="cuda",
) -> Dict[str, float]:
    """Run every experiment under exp_root; returns {folder: seconds}.

    `pipe` injects a prebuilt Pipeline (tests use a tiny one), else an
    SD-1.4 pipeline is built on `device` from `checkpoint_dir` (random
    weights without one); `config_overrides` are dataclasses.replace kwargs
    applied to every per-type EditConfig (e.g. num_ddim_steps for smoke
    runs); `use_native` picks the experiment loader (see
    _experiment_loader).  `group_size` > 1 (the lockstep batch) raises
    NotImplementedError."""
    from geodiffuser_tpu_torch.core.editor import EditSession
    from geodiffuser_tpu_torch.core.pipeline import Pipeline

    if group_size is None:
        group_size = sharding.auto_group_size(image_size)
    if group_size > 1:
        raise NotImplementedError(
            f"group_size={group_size}: the lockstep multi-edit batch "
            "(geodiffuser_tpu/parallel/batch.py:ShardedEditSession.run_batch) is not ported "
            "yet; use group_size 0 or 1 for the sequential sweep")

    if pipe is None:
        pipe = Pipeline.create(ModelConfig(), image_size=image_size,
                               checkpoint_dir=checkpoint_dir, device=device)

    sessions: Dict[str, EditSession] = {}
    times: Dict[str, float] = {}
    todo = []
    for cat, folder in exp_io.list_experiments(exp_root):
        edit_type = exp_io.edit_type_for_category(cat)
        if edit_type is None:
            log.info("skipping category %s (%s)", cat, folder)
            continue
        if skip_existing and os.path.exists(os.path.join(folder, "result_ls.png")):
            log.info("skip existing %s", folder)
            continue
        todo.append((edit_type, folder))
        if limit and len(todo) >= limit:
            break

    # several processes: each sweeps its round-robin share (edits are
    # independent, nothing is exchanged)
    if sharding.process_count() > 1:
        todo = sharding.partition_for_process(todo)
        log.info("process %d/%d: %d experiments assigned",
                 sharding.process_index(), sharding.process_count(), len(todo))

    def get_session(edit_type: str) -> EditSession:
        if edit_type not in sessions:
            cfg = config_for_edit_type(edit_type, num_ddim_steps)
            if config_overrides:
                cfg = dataclasses.replace(cfg, **config_overrides)
            sessions[edit_type] = EditSession(pipe, cfg, device=device)
        return sessions[edit_type]

    loader = _experiment_loader([f for _, f in todo], use_native)
    try:
        for (et, folder), exp in zip(todo, loader):
            sess = get_session(et)
            img, dep, msk, tra = edit_inputs(et, exp, sess.cfg, device=sess.device)
            t0 = time.time()
            res = sess.run(img, dep, msk, tra, exp_folder=folder)
            dt = time.time() - t0
            exp_io.save_results(exp, res.edited_image, res.loss_log)
            times[folder] = dt
            log.info("%s (%s): %.1fs", folder, et, dt)
    finally:
        if hasattr(loader, "close"):
            loader.close()
    return times


def main(argv=None):
    ap = argparse.ArgumentParser(description="GeoDiffuser batch editor (PyTorch port)")
    ap.add_argument("exp_root")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="diffusers-layout SD checkpoint (unet/, vae/, text_encoder/, "
                         "tokenizer/); random weights without one")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--group-size", type=int, default=None,
                    help="lockstep group; default: auto (0, the sequential path: the "
                         "lockstep batch is not ported); values above 1 raise")
    ap.add_argument("--no-skip-existing", action="store_true")
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--no-native", action="store_true",
                    help="force the synchronous Python experiment reader")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the edits (cpu runs the kernels' plain versions)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    times = run_folder_sweep(
        args.exp_root,
        checkpoint_dir=args.checkpoint_dir,
        num_ddim_steps=args.steps,
        image_size=args.size,
        skip_existing=not args.no_skip_existing,
        group_size=args.group_size,
        limit=args.limit,
        use_native=False if args.no_native else None,
        device=args.device,
    )
    print(json.dumps({"edits": len(times),
                      "mean_sec": float(np.mean(list(times.values()) or [0]))}))


if __name__ == "__main__":
    main()
