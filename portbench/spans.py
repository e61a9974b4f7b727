"""The program's own spans in a traced window, and the numbers read from them.

    python3 portbench/spans.py --workload <name> --seed <n> --seconds <s>

The port opens spans named "gd." and a constant inside itself
(`geodiffuser_tpu_torch/utils/profiling.annotate`: `gd.unet` and its
blocks, `gd.edit.step`, `gd.optimize.backward`, ...).  Under
`torch.profiler` they lie on the clock of the device operations, beside the
CUDA runtime calls that block the host until the device has drained.  This
module reads them:

  * `program_events(prof)`: the program's spans and the blocking runtime
    calls of a finished profiler;
  * `unet_host_s`: host seconds inside the outermost `gd.unet` spans, over
    the work done;
  * `loop_idle_s`: device idle seconds inside `gd.edit_loop` whose gap's
    middle lies outside every `gd.unet` span, over the work done;
  * `syncs_per_step`: blocking runtime calls starting inside `gd.edit.step`
    spans, over the number of those spans.

Each returns None where the trace holds nothing to read.  Run as a script,
it makes one traced run of a cell as `portbench/run.py --trace 1` does and
prints run.py's result line with a "program" object added: these numbers
and the idle gaps by the innermost of the traffic driver's and the program's spans.
`run.py` itself does not read the program's spans (PERF.md, Open questions).
"""

from __future__ import annotations

import bisect
import json
import pathlib
import re
import sys
from collections import Counter
from typing import List, Optional, Tuple

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import run, trace  # noqa: E402

Interval = trace.Interval
PREFIX = "gd."
# runtime calls after which the host waits for the device
SYNC = re.compile(r"^cuda(StreamSynchronize|DeviceSynchronize|EventSynchronize"
                  r"|Memcpy(?!\w*Async))")
RUNTIME = re.compile(r"^cuda[A-Z]")


def program_events(prof) -> Tuple[List[Interval], Optional[List[Interval]]]:
    """(the program's spans, the blocking runtime calls) of a finished
    `torch.profiler.profile` as (name, start_ns, end_ns) lists; the calls
    are None where the trace lists no CUDA runtime call at all."""
    import torch

    spans, syncs, runtime = [], [], False
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CPU:
            continue
        name = e.name()
        interval = (name, e.start_ns(), e.start_ns() + e.duration_ns())
        if name.startswith(PREFIX) and e.is_user_annotation():
            spans.append(interval)
        elif RUNTIME.match(name):
            runtime = True
            if SYNC.match(name):
                syncs.append(interval)
    return spans, (syncs if runtime else None)


def _named(spans: List[Interval], name: str, lo: int, hi: int) -> List[Interval]:
    return [sp for sp in spans if sp[0] == name and sp[2] > lo and sp[1] < hi]


def unet_host_s(spans: List[Interval], lo: int, hi: int, work: float) -> Optional[float]:
    unet = _named(spans, "gd.unet", lo, hi)
    if not unet or work <= 0:
        return None
    return sum(e - s for s, e in trace.union(unet, lo, hi)) / 1e9 / work


def loop_idle_s(ops: List[Interval], spans: List[Interval], lo: int, hi: int,
                work: float) -> Optional[float]:
    loops = _named(spans, "gd.edit_loop", lo, hi)
    if not loops or work <= 0:
        return None
    unet = trace.union(_named(spans, "gd.unet", lo, hi), lo, hi)
    starts = [s for s, _ in unet]
    idle = 0
    for _, s, e in loops:
        for a, b in trace.idle_gaps(ops, max(s, lo), min(e, hi)):
            mid = (a + b) // 2
            k = bisect.bisect_right(starts, mid) - 1
            if k < 0 or mid >= unet[k][1]:
                idle += b - a
    return idle / 1e9 / work


def syncs_per_step(spans: List[Interval], syncs: Optional[List[Interval]], lo: int,
                   hi: int) -> Optional[float]:
    steps = sorted((s, e) for _, s, e in _named(spans, "gd.edit.step", lo, hi))
    if not steps or syncs is None:
        return None
    starts = [s for s, _ in steps]
    inside = 0
    for _, s, _ in syncs:
        k = bisect.bisect_right(starts, s) - 1
        inside += k >= 0 and s < steps[k][1]
    return inside / len(steps)


def syncs_by_span(spans: List[Interval], syncs: List[Interval], lo: int, hi: int) -> dict:
    """{innermost program span: blocking runtime calls starting in it}."""
    cuts, names = trace.innermost(spans)
    out: Counter = Counter()
    for _, s, _ in syncs:
        if lo <= s < hi:
            at = bisect.bisect_right(cuts, s) - 1
            out[names[at] if at >= 0 else "no span"] += 1
    return dict(out.most_common())


def read(prof, ops: List[Interval], labelled: List[Interval], lo: int, hi: int,
         work: float) -> dict:
    """The program's numbers of one traced window [lo, hi] (ns) in which
    `work` units of work (edits, images) ran; `labelled` are the traffic driver's
    spans (`trace.from_profiler`)."""
    spans, syncs = program_events(prof)
    inside = [sp for sp in spans if sp[2] > lo and sp[1] < hi]
    return {
        "unet_host_s": unet_host_s(spans, lo, hi, work),
        "loop_idle_s": loop_idle_s(ops, spans, lo, hi, work),
        "syncs_per_step": syncs_per_step(spans, syncs, lo, hi),
        # the benchmark's own span around each UNet call, on the parent too
        "pipeline_unet_host_s": sum(e - s for s, e in trace.union(
            _named(labelled, "pipeline.unet", lo, hi), lo, hi)) / 1e9 / work,
        "idle_gaps": trace.gaps_by_span(ops, labelled + spans, lo, hi, n=24),
        "spans": dict(Counter(sp[0] for sp in inside)),
        "syncs": None if syncs is None else dict(Counter(
            sp[0] for sp in syncs if lo <= sp[1] < hi)),
        "syncs_by_span": None if syncs is None else syncs_by_span(spans, syncs, lo, hi),
        "span_ops": sum(op[0].startswith(PREFIX) for op in ops),
    }


def traced_run(workload, config, traffic, seed: int, seconds: float, device, bench) -> dict:
    """`run.run_cell`'s traced run of one cell, its result with the
    program's numbers added under "program"."""
    kept = {}
    window, from_profiler = run.window, trace.from_profiler

    def kept_window(*a, **kw):
        kept["units"], _, _, kept["traced"] = out = window(*a, **kw)
        return out

    def kept_trace(prof, labels):
        kept["prof"] = prof
        kept["ops"], kept["labelled"] = out = from_profiler(prof, labels)
        return out

    run.window, trace.from_profiler = kept_window, kept_trace
    try:
        result = run.run_cell(workload, config, traffic, seed, seconds, True, device, bench)
    finally:
        run.window, trace.from_profiler = window, from_profiler
    units = [s for s in kept["labelled"] if s[0] == "unit"]
    lo, hi = min(s[1] for s in units), max(s[2] for s in units)
    work = sum(u["work"] for u in kept["units"][:kept["traced"]])
    result["program"] = read(kept["prof"], kept["ops"], kept["labelled"], lo, hi, work)
    return result


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    bench = run.benchmark()
    workload, config, traffic = run.cell_files(bench, args.workload)
    if not torch.cuda.is_available():
        print(f"{args.workload} needs a CUDA device", file=sys.stderr)
        return 2
    print(f"card: {torch.cuda.get_device_name(0)}, {run.power_limit()}", file=sys.stderr)
    result = traced_run(workload, config, traffic, args.seed % (1 << 63), args.seconds, "cuda",
                        bench)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
