"""Reduction of a `torch.profiler` trace of the window to device time.

Device operations (kernels, copies, sets) are intervals on the trace's
timeline; the device is busy where their union covers the window, so
kernels that overlap are counted once.  An idle gap is named after the
innermost of the benchmark's host spans (`record_function`) around its
middle.  Every function but `from_profiler` works on plain lists, so a
recorded or made-up trace reads the same way.
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

Interval = Tuple[str, int, int]     # (name, start ns, end ns)


def from_profiler(prof, labels: Sequence[str]):
    """(device operations, host spans of `labels`) of a finished
    `torch.profiler.profile`, as (name, start_ns, end_ns) lists."""
    import torch

    device, spans = [], []
    wanted = set(labels)
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        end = start + e.duration_ns()
        name = e.name()
        annotation = getattr(e, "is_user_annotation", lambda: False)()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            # the device copies of the host spans are no device work
            if not annotation and name not in wanted:
                device.append((name, start, end))
        elif name in wanted:
            spans.append((name, start, end))
    return device, spans


def clip(ops: List[Interval], lo: int, hi: int) -> List[Interval]:
    return [(n, max(s, lo), min(e, hi)) for n, s, e in ops if e > lo and s < hi]


def union(ops: List[Interval], lo: int, hi: int) -> List[Tuple[int, int]]:
    """The union of the operations' intervals inside [lo, hi], merged."""
    merged: List[List[int]] = []
    for _, s, e in sorted(clip(ops, lo, hi), key=lambda op: op[1]):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def busy_seconds(ops: List[Interval], lo: int, hi: int) -> float:
    return sum(e - s for s, e in union(ops, lo, hi)) / 1e9


def idle_gaps(ops: List[Interval], lo: int, hi: int) -> List[Tuple[int, int]]:
    gaps, at = [], lo
    for s, e in union(ops, lo, hi):
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if hi > at:
        gaps.append((at, hi))
    return gaps


def own_seconds(ops: List[Interval], pattern: str, lo: int, hi: int) -> float:
    """Summed own time of the operations whose names match `pattern`."""
    rx = re.compile(pattern)
    return sum(e - s for n, s, e in clip(ops, lo, hi) if rx.search(n)) / 1e9


def top_ops(ops: List[Interval], lo: int, hi: int, n: int = 10) -> List[list]:
    """[[name, seconds]] of the `n` operation names that took most time."""
    by_name: Dict[str, int] = defaultdict(int)
    for name, s, e in clip(ops, lo, hi):
        by_name[short(name)] += e - s
    return [[k, v / 1e9] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:n]]


def innermost(spans: List[Interval]) -> Tuple[List[int], List[str]]:
    """The host timeline cut where any span starts or ends: (cut times,
    each piece's innermost span, "no span" outside all).  Spans of one
    thread nest, so a stack gives the innermost."""
    marks = sorted([(s, 1, -e, name) for name, s, e in spans]
                   + [(e, 0, 0, name) for name, s, e in spans])
    cuts, names, stack = [], [], []
    for t, opening, _, name in marks:
        if opening:
            stack.append(name)
        elif name in stack:
            del stack[len(stack) - 1 - stack[::-1].index(name)]
        cuts.append(t)
        names.append(stack[-1] if stack else "no span")
    return cuts, names


def gaps_by_span(ops: List[Interval], spans: List[Interval], lo: int, hi: int,
                 n: int = 10) -> List[list]:
    """[[span name, seconds]]: the device's idle time inside [lo, hi], each
    gap given to the innermost host span around its middle, the `n`
    largest sums."""
    cuts, names = innermost(spans)
    by_span: Dict[str, int] = defaultdict(int)
    for s, e in idle_gaps(ops, lo, hi):
        at = bisect.bisect_right(cuts, (s + e) // 2) - 1
        by_span[names[at] if at >= 0 else "no span"] += e - s
    return [[k, v / 1e9] for k, v in sorted(by_span.items(), key=lambda kv: -kv[1])[:n]]


def short(name: str, width: int = 120) -> str:
    """A kernel's name without its trailing argument list, at most `width`
    long."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i] if i else name
                break
    return name[:width]
