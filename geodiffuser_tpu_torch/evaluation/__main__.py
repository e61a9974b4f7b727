"""Evaluation CLI: sweep an experiment tree and print per-method metric tables.

Counterpart of `geodiffuser_tpu/evaluation/__main__.py`, the reference
workflow (GeoDiffuser/evaluation/eval.txt:1-11):

    python -m geodiffuser_tpu_torch.evaluation --exp_root <tree> --metric md --weights_dir <sd21>
    python -m geodiffuser_tpu_torch.evaluation --exp_root <tree> --metric lpips --weights_dir <dir>
    python -m geodiffuser_tpu_torch.evaluation --path_1 <dir> --path_2 <dir> --metric clip
    python -m geodiffuser_tpu_torch.evaluation ... --device cpu

Semantics follow evaluation/image_fidelity.py:
  * `--metric lpips|clip` computes LPIPS(alex)@224 + CLIP ViT-B/32 cosine +
    IF=1-LPIPS per method result in every experiment folder (:183-206);
  * `--metric md` computes the DIFT-matched keypoint mean distance (SD-2.1
    features, its UNet's self-attention through the flash kernel on the
    card) + the masked warp-L1 (:125-181), skipping the Mix/Removal/Scaling/
    Rotation_2D categories like run_md_evaluation_on_exps (:400-408);
  * `--metric fid` scores one method's results against the inputs with the
    CLIP-FID embedder;
  * `--evaluation_type {2D,3D,all}` filters categories (:403-408);
  * `--path_1/--path_2` compares two flat folders of same-named images
    (:566-...).

The offline bundle (PSNR/SSIM/warp-L1/background preservation) needs no
weights.  A metric whose weight file is missing from `--weights_dir` is
reported as unavailable (LPIPS/CLIP are left out, FID falls back to a
downsampled-pixel embedder); any other error fails the run.  Runs on the
card unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from collections import defaultdict
from typing import Dict, Optional

import numpy as np
import torch

from geodiffuser_tpu_torch.core.pipeline import resolve_device
from geodiffuser_tpu_torch.evaluation import metrics
from geodiffuser_tpu_torch.utils import exp_io, png

# Per-method result files inside an experiment folder (ui_utils.py:130-140)
METHOD_RESULTS = {
    "ours": ("resized_result_ls.png", "result_ls.png", "result.png"),
    "zero123": ("zero123/lama_followed_by_zero123_result.png",),
    "object_edit": ("object_edit/result_object_edit.png",),
    "dragon_diffusion": ("dragon_diffusion/result_dragon_diffusion.png",),
    "diffusion_handles": ("diffhandles/im_edited_diffhandles.png",),
    "free_drag": ("free_drag/result_free_drag_resized.png",),
}

# Category sets (run_md_evaluation_on_exps, image_fidelity.py:400-408)
SKIP_CATEGORIES = {"Mix", "Removal", "Scaling", "Rotation_2D"}
CAT_2D = {"Translation_2D"}
CAT_3D = {"Translation_3D", "Rotation_3D"}


def _read_image(path: str) -> Optional[np.ndarray]:
    if not os.path.exists(path):
        return None
    return png.to_rgb(png.read_png(path))


def _resize_to(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """PIL's BILINEAR resize (Pillow-exact, `utils/png.py`)."""
    if img.shape[:2] == (h, w):
        return img
    return png.resize_bilinear(img, h, w)


def _category_of(folder: str) -> str:
    return os.path.basename(os.path.dirname(folder.rstrip("/")))


def _keep_category(cat: str, evaluation_type: str, metric: str) -> bool:
    if metric == "md" and cat in SKIP_CATEGORIES:
        return False
    if evaluation_type == "2D":
        return cat in CAT_2D
    if evaluation_type == "3D":
        return cat in CAT_3D
    return True


def _experiments(exp_root: str):
    """Yield (category, folder). Accepts a category-tree root, one category
    folder, or a single experiment folder."""
    if os.path.exists(os.path.join(exp_root, "input_image.png")):
        yield _category_of(exp_root), exp_root
        return
    found = list(exp_io.list_experiments(exp_root))
    if found:
        yield from found
        return
    # one category folder of numbered experiments
    for name in sorted(os.listdir(exp_root)):
        folder = os.path.join(exp_root, name)
        if os.path.isdir(folder) and os.path.exists(os.path.join(folder, "input_image.png")):
            yield os.path.basename(exp_root.rstrip("/")), folder


@torch.no_grad()
def _transform_field(exp, device):
    """Recompute t_coords + the warped mask from the saved inputs (the
    reference recomputes them in get_md_list_folder via
    get_transform_coordinates)."""
    from geodiffuser_tpu_torch.ops import image as image_ops
    from geodiffuser_tpu_torch.ops import splat as splat_ops
    from geodiffuser_tpu_torch.ops import transform_field as tf_ops

    as_t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    img = as_t(exp.input_image) / 255.0
    mask = image_ops.binarize(as_t(exp.input_mask))
    tf = tf_ops.build_transform_field(img, as_t(exp.depth), mask, as_t(exp.transform))
    warped = image_ops.binarize(splat_ops.splat_image(mask[..., None], tf.coords)[..., 0])
    return tf.coords.cpu().numpy(), warped.cpu().numpy()


def _pairwise(a: np.ndarray, b: np.ndarray, weights_dir: Optional[str],
              device) -> Dict[str, float]:
    out: Dict[str, float] = {}
    af = a.astype(np.float32) / 255.0
    bf = b.astype(np.float32) / 255.0
    out["psnr"] = metrics.psnr(af, bf)
    out["ssim"] = metrics.ssim(af, bf, device=device)
    try:
        lp = metrics.lpips(af, bf, weights_dir=weights_dir, device=device)
        out["lpips"] = lp
        out["if"] = 1.0 - lp
    except metrics.PretrainedWeightsUnavailable:
        pass
    try:
        out["clip_sim"] = metrics.clip_similarity(af, bf, weights_dir=weights_dir, device=device)
    except metrics.PretrainedWeightsUnavailable:
        pass
    return out


def _print_table(agg: Dict[str, Dict[str, list]]) -> Dict[str, Dict[str, float]]:
    summary: Dict[str, Dict[str, float]] = {}
    for method in sorted(agg):
        summary[method] = {
            k: float(np.mean(v)) for k, v in sorted(agg[method].items()) if v
        }
        cells = "  ".join(f"{k}={v:.4f}" for k, v in summary[method].items())
        print(f"{method:20s} {cells}")
    return summary


def _pixel_embed(img: np.ndarray) -> np.ndarray:
    """The FID fallback embedder: a 16x16 bilinear thumbnail in [0, 1]."""
    return (png.resize_bilinear(img, 16, 16).astype(np.float32) / 255.0).reshape(-1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m geodiffuser_tpu_torch.evaluation",
        description="GeoDiffuser experiment-tree evaluation "
                    "(reference: evaluation/image_fidelity.py)",
    )
    ap.add_argument("--exp_root", default=None)
    ap.add_argument("--metric", choices=["md", "lpips", "clip", "offline", "fid"],
                    default="clip")
    ap.add_argument("--method_type", default="ours",
                    help="for --metric fid: which method's results to score "
                         f"({', '.join(METHOD_RESULTS)})")
    ap.add_argument("--evaluation_type", choices=["2D", "3D", "all"], default="all")
    ap.add_argument("--path_1", default=None)
    ap.add_argument("--path_2", default=None)
    ap.add_argument("--weights_dir", default=None,
                    help="directory with LPIPS/CLIP weights (alexnet.pth, lpips_alex.pth, "
                         "clip_vision.safetensors), or for md the SD checkpoint (diffusers layout)")
    ap.add_argument("--output", default=None, help="write the summary as JSON")
    ap.add_argument("--max_points", type=int, default=50, help="md keypoint budget")
    ap.add_argument("--sd_version", choices=["2.1", "1.x"], default="2.1",
                    help="DIFT featurizer model for --metric md (the "
                         "reference uses SD-2.1, evaluation/dift_sd.py:16)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    if args.path_1 and args.path_2:
        agg: Dict[str, Dict[str, list]] = {"pairwise": defaultdict(list)}
        for name in sorted(os.listdir(args.path_1)):
            a = _read_image(os.path.join(args.path_1, name))
            b = _read_image(os.path.join(args.path_2, name))
            if a is None or b is None:
                continue
            b = _resize_to(b, *a.shape[:2])
            for k, v in _pairwise(a, b, args.weights_dir, device).items():
                agg["pairwise"][k].append(v)
        summary = _print_table(agg)
    elif args.exp_root and args.metric == "fid":
        # fid_is_score_geodiff.py flow: FID between inputs and one method's
        # results over the tree; CLIP-FID embedder (Inception is weight-gated)
        from geodiffuser_tpu_torch.evaluation import fid as fid_mod

        try:
            embed = fid_mod.CLIPFeatureExtractor(weights_dir=args.weights_dir, device=device)
        except (metrics.PretrainedWeightsUnavailable, FileNotFoundError) as exc:
            print(f"[INFO] FID embedder unavailable ({exc}); using a raw "
                  "downsampled-pixel embedder (rank-order comparisons only)",
                  file=sys.stderr)
            embed = _pixel_embed

        names = METHOD_RESULTS[args.method_type]
        value = None
        for name in names:
            try:
                value = fid_mod.fid_over_experiments(args.exp_root, embed, result_name=name)
                break
            except ValueError:
                continue
        if value is None:
            ap.error(f"no {args.method_type} results under {args.exp_root}")
        print(f"{args.method_type:20s} fid={value:.4f}")
        summary = {args.method_type: {"fid": float(value)}}
    elif args.exp_root:
        featurizer = None
        if args.metric == "md" and args.weights_dir:
            from geodiffuser_tpu_torch.evaluation.dift import build_featurizer

            featurizer = build_featurizer(weights_dir=args.weights_dir,
                                          sd_version=args.sd_version, device=device)
        elif args.metric == "md":
            print("[INFO] no --weights_dir: md (DIFT) unavailable, reporting "
                  "warp-L1 + offline metrics only", file=sys.stderr)

        agg = defaultdict(lambda: defaultdict(list))
        n_exps = 0
        for cat, folder in _experiments(args.exp_root):
            if not _keep_category(cat, args.evaluation_type, args.metric):
                continue
            exp = exp_io.read_exp(folder)
            n_exps += 1
            t_coords = warped = None
            if args.metric in ("md", "offline"):
                t_coords, warped = _transform_field(exp, device)
            src = exp.input_image
            for method, names in METHOD_RESULTS.items():
                res = None
                for n in names:
                    res = _read_image(os.path.join(folder, n))
                    if res is not None:
                        break
                if res is None:
                    continue
                res = _resize_to(res, *src.shape[:2])
                key = f"{cat}/{method}"
                if args.metric in ("lpips", "clip"):
                    for k, v in _pairwise(src, res, args.weights_dir, device).items():
                        agg[key][k].append(v)
                else:
                    agg[key]["warp_l1"].append(metrics.warp_error(
                        res.astype(np.float32) / 255.0,
                        src.astype(np.float32) / 255.0, t_coords, warped, device=device,
                    ))
                    bundle = metrics.evaluate_experiment(exp, res, t_coords, warped,
                                                         device=device)
                    for k, v in bundle.items():
                        agg[key][k].append(v)
                    if featurizer is not None:
                        from geodiffuser_tpu_torch.evaluation.dift import mean_distance_metric

                        md, _n_kp = mean_distance_metric(
                            featurizer, src, res, exp.input_mask, t_coords,
                            max_points=args.max_points,
                        )
                        if np.isfinite(md):
                            agg[key]["md"].append(md)
        print(f"[INFO] evaluated {n_exps} experiments under {args.exp_root}")
        summary = _print_table(agg)
    else:
        ap.error("pass --exp_root or --path_1/--path_2")
        return 2

    if args.output:
        with open(args.output, "w") as f:
            json.dump(summary, f, indent=2)
        print(f"[INFO] wrote {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
