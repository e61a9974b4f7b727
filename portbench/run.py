"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell (`BENCHMARK.json` `workloads`) names a configuration
(`portbench/configs/<config>.json`) and a traffic mix
(`portbench/traffic/<traffic>.json`, whose `driver` names the generator in
`portbench/drivers/`).  The run builds the port (`geodiffuser_tpu_torch`)
with weights from the seed and warms it up on the cell's own shapes
(set-up, `setup_s`), runs the mix's units of work back to back until
`--seconds` have passed and the unit in flight has finished (the window),
reads the peak of device memory, and then, with the program's state freed,
has the float32 reference recompute a sample of what the window produced
(`correct`).  With `--trace 1` the window runs under `torch.profiler` and
the line carries the cell's per-layer metrics (`portbench/metrics/<name>.py`)
and a breakdown; with `--trace 0` its end-to-end metrics.  The last line of
standard output is the result, a JSON object; everything else goes before
it or to standard error, whose last lines are the compared numbers beside
their limits.
"""

from __future__ import annotations

import time

START = time.perf_counter()   # set-up is counted from the process's start

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench import compare, trace  # noqa: E402

# top-level module names that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "geodiffuser_tpu")
GIB = float(1 << 30)
TRACE_SECONDS = 15.0   # a traced run profiles the units that start in this time


@dataclasses.dataclass
class Record:
    """What the per-layer metric readers read: the window's units of work
    (each {"work", "seconds", "timings"?}), its work counted by
    `portbench/work`, its length, and with a trace the device operations,
    the traced window [lo, hi] (ns) and the device's busy seconds in it."""

    units: List[Dict]
    work: Dict[str, float]
    window_s: float
    ops: Optional[list] = None
    lo: int = 0
    hi: int = 0
    busy_s: float = 0.0


def benchmark() -> Dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell_files(bench: Dict, name: str):
    """(workload entry, configuration, traffic mix) of the cell `name`."""
    workload = next((w for w in bench["workloads"] if w["name"] == name), None)
    if workload is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == workload["config"])
    config = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads((ROOT / "portbench" / "traffic" / f"{workload['traffic']}.json").read_text())
    return workload, config, traffic


def applies(metric: Dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def reader(name: str):
    path = ROOT / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> List[str]:
    """Forbidden top-level module names in `sys.modules`, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "not read"


def window(cell, seconds: float, traced: bool, device: torch.device):
    """Units back to back until `seconds` have passed and the one in flight
    has finished: (units, window seconds, profiler or None, traced units).
    A traced run profiles the units that start in its first
    `TRACE_SECONDS` (at least one) and runs the rest of the window
    unprofiled, so that reading the trace stays short."""
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    prof = None
    if traced:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
    units, traced_units = [], 0
    sync()
    t0 = time.perf_counter()
    if prof is not None:
        prof.__enter__()
    while True:
        with torch.profiler.record_function("unit"):
            units.append(cell.unit(len(units)))
            sync()
        elapsed = time.perf_counter() - t0
        if prof is not None and not traced_units and elapsed >= min(seconds, TRACE_SECONDS):
            prof.__exit__(None, None, None)
            traced_units = len(units)
        if elapsed >= seconds:
            break
    window_s = time.perf_counter() - t0
    return units, window_s, prof, traced_units


def run_cell(workload: Dict, config: Dict, traffic: Dict, seed: int, seconds: float,
             traced: bool, device, bench: Dict, start: float = START,
             limits: Optional[Dict[str, float]] = None) -> Dict:
    """One run of one cell on `device`: the result object, `checks` last."""
    device = torch.device(device)
    print(f"imports {time.perf_counter() - start:.2f} s", file=sys.stderr)
    driver = importlib.import_module(f"portbench.drivers.{traffic['driver']}")
    cell = driver.Cell(config, traffic, seed, device)
    try:
        cell.setup()
        if device.type == "cuda":
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - start
        print(f"set-up {setup_s:.3f} s", file=sys.stderr)

        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        units, window_s, prof, traced_units = window(cell, seconds, traced, device)
    except BaseException:
        cell.release()
        raise
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    done = sum(u["work"] for u in units)
    print(f"window {window_s:.3f} s, {len(units)} units, {done} {driver.UNIT}s, unit seconds "
          f"{[round(u['seconds'], 3) for u in units]}", file=sys.stderr)

    device_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                   "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                   "count": int(workload["chips"]), "memory_peak_bytes": int(peak)}
    breakdown = None
    if traced:
        t_read = time.perf_counter()
        ops, spans = trace.from_profiler(prof, ("unit",) + driver.LABELS)
        unit_spans = [s for s in spans if s[0] == "unit"]
        rec = Record(units=units[:traced_units], work={},
                     window_s=sum(u["seconds"] for u in units[:traced_units]), ops=ops,
                     lo=min(s[1] for s in unit_spans), hi=max(s[2] for s in unit_spans))
        rec.busy_s = trace.busy_seconds(ops, rec.lo, rec.hi)
        rec.work = cell.work(rec.units)
        print(f"trace of {traced_units} units: {len(ops)} device operations, {len(spans)} spans, "
              f"read in {time.perf_counter() - t_read:.1f} s", file=sys.stderr)
        if device.type != "cuda":
            # device metrics come from a card's run only
            rec.ops, rec.work = None, {}
        device_info.update(busy_s=rec.busy_s, window_s=(rec.hi - rec.lo) / 1e9)
        breakdown = {"device_ops": trace.top_ops(ops, rec.lo, rec.hi),
                     "idle_gaps": trace.gaps_by_span(ops, spans, rec.lo, rec.hi)}
        del prof, ops, spans

    cell.release()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_check = time.perf_counter()
    try:
        gaps = cell.check()["program"]
    except Exception:
        # what the program left is not what the check reads: no gap is known
        traceback.print_exc()
        gaps = {}
    print(f"gaps {json.dumps(gaps)}", file=sys.stderr)
    ok, rows = compare.judge(gaps, compare.limits(workload["name"]) if limits is None else limits)
    print(f"reference check {time.perf_counter() - t_check:.3f} s", file=sys.stderr)

    metrics = {}
    if traced:
        for m in bench["per_layer"]:
            if applies(m, workload["name"]):
                value = reader(m["name"])(rec)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {"setup_s": setup_s, "peak_gib": peak / GIB, driver.RATE[0]: done / window_s}
        for m in bench["end_to_end"]:
            if applies(m, workload["name"]):
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    result = {"correct": bool(ok), "attempted": int(done), "failed": 0, "metrics": metrics,
              "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["power_limit"] = power_limit() if device.type == "cuda" else "not read"
    result["checks"] = {r["name"]: {"value": r["value"], "limit": r["limit"]} for r in rows}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = benchmark()
    workload, config, traffic = cell_files(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < workload["chips"]:
        print(f"{args.workload} needs {workload['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    print(f"card: {torch.cuda.get_device_name(0)}, {power_limit()}", file=sys.stderr)
    result = run_cell(workload, config, traffic, args.seed % (1 << 63), args.seconds,
                      bool(args.trace), "cuda", bench)
    found = forbidden_modules()
    if found:
        print(f"modules that no run may load are loaded: {found}", file=sys.stderr)
        return 3
    for row in result["checks"].items():
        print(f"check {row[0]}: {row[1]['value']!r} limit {row[1]['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
