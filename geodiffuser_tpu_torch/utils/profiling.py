"""Tracing and phase timing.

Counterpart of `geodiffuser_tpu/utils/profiling.py` (the reference has no
active profiling: commented torch.profiler scaffolding, editor.py:247-249):

  * `trace(logdir)`: a `torch.profiler` context recording CPU activity, and
    CUDA activity where a card is present, written as a Chrome trace
    (open it in Perfetto or chrome://tracing) under `logdir`;
  * `annotate(name)`: a named span in that trace
    (`torch.profiler.record_function`);
  * `PhaseTimer`: accumulated wall-clock seconds by phase, the device
    synchronized before a phase's clock stops where `block_on` holds CUDA
    tensors (where the JAX timer blocks on its arrays).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Optional

import torch


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


def annotate(name: str):
    """Named span for the ops run inside it (shows up in `trace`'s file)."""
    return torch.profiler.record_function(name)


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
        """Time the body; `block_on` (a tensor or a list, tuple or dict of
        them) is waited for: each CUDA device it lives on is synchronized."""
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
