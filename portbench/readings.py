"""Readings that the limits of a cell's compared numbers are set from.

    python3 portbench/readings.py --workload <name> --seeds <n> [<n> ...] [--seconds S]

For each seed, in one process: the cell is set up with that seed's weights
and inputs, runs a short window at its own load (`--seconds`; the unit in
flight is always finished, so at least one group or image), and then the
float32 reference recomputes the sampled outputs, once to judge the
program's (the lower reading) and once to judge the control's: the
reference computed as an fp8 (e4m3) path would compute it, from the same
inputs (the upper reading).  Prints one JSON line a seed with both sets of
gaps.  The benchmark's own runs do not run the control.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench import run  # noqa: E402


def readings(workload: str, seed: int, seconds: float, device="cuda", config=None, traffic=None):
    """{"seed", "units", "program": gaps, "control": gaps} of one seed."""
    bench = run.benchmark()
    w, cfg, tr = run.cell_files(bench, workload)
    cfg, tr = config or cfg, traffic or tr
    driver = importlib.import_module(f"portbench.drivers.{tr['driver']}")
    cell = driver.Cell(cfg, tr, seed, torch.device(device))
    cell.setup()
    units, window_s, _, _ = run.window(cell, seconds, False, torch.device(device))
    cell.release()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = cell.check(lower=True)
    del cell
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return dict(seed=seed, units=len(units), window_s=window_s, **out)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        t0 = time.perf_counter()
        rec = readings(args.workload, seed, args.seconds)
        rec["seconds"] = time.perf_counter() - t0
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
