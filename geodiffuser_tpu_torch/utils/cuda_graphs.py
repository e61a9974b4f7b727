"""A function of fixed-shape CUDA tensors captured once as a CUDA graph and
replayed.

`CapturedCall(fn, inputs)` copies `inputs` into static buffers, runs `fn`
once eagerly on a side stream (lazy set-up: kernel attributes, cuBLAS and
cuDNN plans), captures a second run into a `torch.cuda.CUDAGraph` with its
own memory pool, and keeps the captured run's output.  Memory freed inside
the capture stays reserved in that pool, outside what
`torch.cuda.memory_allocated` counts.  Each call copies
its arguments into the static buffers, replays the graph and returns that
same output tensor, overwritten by the next call.

Python does not run on a replay, so the kernel wrappers' launch counters
(`LAUNCHES` / `SHAPES`) count the warm-up and the capture's launches, and
none of a replay's: a profiler trace lists those.
"""

from __future__ import annotations

import time
from typing import Callable, Sequence

import torch


class CapturedCall:
    """`fn(*inputs)` as one CUDA graph; `inputs` fix the shapes, dtypes and
    device of every later call's arguments.  `capture_s` is the seconds
    the warm-up and the capture took."""

    def __init__(self, fn: Callable[..., torch.Tensor], inputs: Sequence[torch.Tensor]):
        t0 = time.perf_counter()
        self.inputs = [x.clone() for x in inputs]
        side = torch.cuda.Stream(self.inputs[0].device)
        side.wait_stream(torch.cuda.current_stream(self.inputs[0].device))
        with torch.cuda.stream(side):
            fn(*self.inputs)
        torch.cuda.current_stream(self.inputs[0].device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        # cuBLAS keeps a workspace per stream (tens of MiB) for the process's
        # life: dropped before the capture, the capture stream's is made in
        # the graph's pool; dropped after it, that one stays with the pool and
        # the warm-up stream's is freed, so nothing stays allocated past the
        # capture but the static buffers
        torch._C._cuda_clearCublasWorkspaces()
        with torch.cuda.graph(self.graph):
            self.output = fn(*self.inputs)
        torch._C._cuda_clearCublasWorkspaces()
        self.capture_s = time.perf_counter() - t0

    def __call__(self, *args: torch.Tensor) -> torch.Tensor:
        for static, x in zip(self.inputs, args, strict=True):
            static.copy_(x)
        self.graph.replay()
        return self.output
