"""The benchmark's side of the program under test (`geodiffuser_tpu_torch`).

Everything the benchmark takes from the port goes through here: its
configuration classes, its pipeline built with the benchmark's seeded
weights, and the spans the benchmark puts around the calls into each layer
(`torch.profiler.record_function`, read from the traced run).
"""

from __future__ import annotations

import dataclasses
import functools
import inspect
import sys
import time
from typing import Callable, Dict

import torch

from portbench import weights


def model_config(pkg, model: Dict, dtype: str):
    """`pkg.config.ModelConfig` (the port's or the reference's) from a
    configuration file's `model` group and dtype name."""
    fields = {k: tuple(v) if isinstance(v, list) else v for k, v in model.items()}
    return pkg.ModelConfig(**fields, dtype=getattr(torch, dtype))


def edit_config(pkg, edit: Dict, **over):
    """`pkg.EditConfig` from a configuration file's `edit` group."""
    fields = dict(edit)
    fields["splat"] = pkg.SplatConfig(**fields.pop("splat"))
    return pkg.EditConfig(**fields, **over)


def pipeline(model: Dict, dtype: str, image_size: int, seed: int, device):
    """The port's `Pipeline` with the benchmark's weights from `seed`: the
    modules are built on the meta device and filled on `device`, with the
    tokenizer and schedule `Pipeline.create` gives them."""
    from geodiffuser_tpu_torch import config as cfg_mod
    from geodiffuser_tpu_torch.core import pipeline as pipe_mod
    from geodiffuser_tpu_torch.core import scheduler as sched
    from geodiffuser_tpu_torch.models.tokenizer import load_tokenizer

    cfg = model_config(cfg_mod, model, dtype)
    dev = torch.device(device)
    mods = weights.build({"unet": pipe_mod.UNet2DCondition, "vae": pipe_mod.AutoencoderKL,
                          "text": pipe_mod.CLIPTextEncoder}, cfg, cfg.dtype, seed, dev)
    return pipe_mod.Pipeline(
        config=cfg, unet=mods["unet"], vae=mods["vae"], text_encoder=mods["text"],
        tokenizer=load_tokenizer(None, cfg.text_vocab_size, cfg.text_max_length),
        schedule=sched.make_schedule(cfg_mod.SchedulerConfig()), device=dev,
        image_size=image_size)


class Unet(torch.nn.Module):
    """A pipeline's UNet inside a span of `pipeline.unet`; once `arm(pick)`
    is called it keeps the output of its call number `pick` for `take`."""

    def __init__(self, inner: torch.nn.Module):
        super().__init__()
        self.inner = inner
        self.keep = None
        self.pick = 0
        self.calls = 0

    def arm(self, pick: int = 0) -> None:
        self.keep, self.pick, self.calls = [], pick, 0

    def forward(self, *args, **kwargs):
        with torch.profiler.record_function("pipeline.unet"):
            out = self.inner(*args, **kwargs)
        if self.keep is not None:
            if self.calls == self.pick:
                self.keep.append(out.detach().clone())
            self.calls += 1
        return out

    def take(self):
        """The kept output, None where the call never came."""
        out, self.keep = (self.keep or [None])[0], None
        return out


def wrap(owner, attr: str, label: str, before: Callable = None, after: Callable = None):
    """Put `owner.attr` (a function or bound method) inside a span of
    `label`; `before(args)` sees the call's bound arguments by name and
    returns a token, `after(token, result)` sees it with the result."""
    fn = getattr(owner, attr)
    sig = inspect.signature(fn)

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        token = None
        if before is not None:
            bound = sig.bind(*args, **kwargs)
            bound.apply_defaults()
            token = before(bound.arguments)
        with torch.profiler.record_function(label):
            out = fn(*args, **kwargs)
        if after is not None and token is not None:
            after(token, out)
        return out

    setattr(owner, attr, wrapped)
    return fn


def host(x):
    """A detached host copy of a tensor, or of every tensor in a dict, list,
    tuple or dataclass."""
    if torch.is_tensor(x):
        return x.detach().to("cpu", copy=True)
    if isinstance(x, dict):
        return {k: host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(host(v) for v in x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: host(getattr(x, f.name)) for f in dataclasses.fields(x)}
    return x


class Phases:
    """Seconds of each named phase of a set-up, printed to standard error."""

    def __init__(self, what: str):
        self.what = what
        self.t = time.perf_counter()
        self.parts = []

    def done(self, name: str) -> None:
        now = time.perf_counter()
        self.parts.append(f"{name} {now - self.t:.2f} s")
        self.t = now

    def report(self) -> None:
        print(f"{self.what}: " + ", ".join(self.parts), file=sys.stderr)
