"""Tracing and phase timing.

Counterpart of `geodiffuser_tpu/utils/profiling.py` (the reference has no
active profiling: commented torch.profiler scaffolding, editor.py:247-249):

  * `trace(logdir)`: a `torch.profiler` context recording CPU activity, and
    CUDA activity where a card is present, written as a Chrome trace
    (open it in Perfetto or chrome://tracing) under `logdir`;
  * `annotate(name, args)`: a named span in that trace
    (`torch.profiler.record_function`), and a shared no-op while no
    profiler records;
  * `PhaseTimer`: accumulated wall-clock seconds by phase, each phase also
    a span of "gd." and its name, the device synchronized before a phase's
    clock stops where `block_on` holds CUDA tensors (where the JAX timer
    blocks on its arrays).

The port's own spans are named "gd." and a constant (`gd.unet`,
`gd.edit.step`, ...); a step's index and kind go in `args`.  While a
profiler records, their host events lie on the clock of its device
operations, so a trace can give each idle gap of the device to the span
the host was in.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Optional

import torch
from torch.autograd import profiler as autograd_profiler


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the body; on a clean exit write `trace_<pid>_<ms>.json` (a
    Chrome trace) under `logdir`.  Yields the `torch.profiler.profile`."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(
        os.path.join(logdir, f"trace_{os.getpid()}_{int(time.time() * 1000)}.json"))


_NO_SPAN = contextlib.nullcontext()


def annotate(name: str, args: Optional[str] = None):
    """Named span for the ops run inside it (shows up in `trace`'s file).
    Without a recording profiler it is one shared no-op context: on an
    H100 machine's host an open `record_function` costs about 10 us a span
    even when nothing records, the check 0.3 us."""
    if not autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return torch.profiler.record_function(name, args)


def _cuda_devices(tree) -> set:
    if isinstance(tree, torch.Tensor):
        return {tree.device} if tree.device.type == "cuda" else set()
    if isinstance(tree, dict):
        tree = tree.values()
    if isinstance(tree, (list, tuple, type({}.values()))):
        return set().union(*(_cuda_devices(t) for t in tree))
    return set()


class PhaseTimer:
    """Accumulating named phase timer; the JAX timer's API and summary."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None):
        """Time the body inside a span of "gd." + `name`; `block_on` (a
        tensor or a list, tuple or dict of them) is waited for: each CUDA
        device it lives on is synchronized."""
        with annotate("gd." + name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                for device in _cuda_devices(block_on):
                    torch.cuda.synchronize(device)
                dt = time.perf_counter() - t0
                self.totals[name] = self.totals.get(name, 0.0) + dt
                self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {"total_s": round(v, 4), "count": self.counts[k],
                "mean_s": round(v / max(self.counts[k], 1), 4)}
            for k, v in sorted(self.totals.items(), key=lambda kv: -kv[1])
        }

    def dump(self, path: Optional[str] = None) -> str:
        s = json.dumps(self.summary(), indent=1)
        if path:
            with open(path, "w") as f:
                f.write(s)
        return s
