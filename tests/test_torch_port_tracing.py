"""The port's spans (`utils/profiling.annotate`) on the CPU: ModelConfig.tiny(),
float32, one torch thread.

A tiny lockstep group (E = 2, 3 DDIM steps) and a tiny DIFT call run under
a CPU `torch.profiler`; their "gd." spans must form one tree on the calling
thread, each where its layer runs, one `gd.edit.step` a step, one
`gd.unet` a UNet call and one `gd.dift.draw` a draw.  Without a profiler
`annotate` is one shared no-op.  The group's `timings` keep their keys and
equal their phase spans' lengths.
"""

import contextlib

import numpy as np
import pytest
import torch

from geodiffuser_tpu_torch.config import EditConfig, ModelConfig
from geodiffuser_tpu_torch.core.pipeline import Pipeline
from geodiffuser_tpu_torch.evaluation.dift import SDFeaturizer
from geodiffuser_tpu_torch.ops import camera
from geodiffuser_tpu_torch.parallel.batch import ShardedEditSession
from geodiffuser_tpu_torch.utils import profiling

SIZE = 64
STEPS = 3
PHASES = ("preprocess", "inversion", "edit_loop", "decode_post")

# each span's parent among the spans (None: outermost)
PARENTS = {
    "gd.preprocess": {None}, "gd.inversion": {None}, "gd.edit_loop": {None},
    "gd.decode_post": {None},
    "gd.text.encode": {"gd.preprocess"}, "gd.vae.encode": {"gd.preprocess"},
    "gd.vae.decode": {"gd.decode_post"},
    "gd.inversion.step": {"gd.inversion"},
    "gd.edit.step": {"gd.edit_loop"}, "gd.edit.drain": {"gd.edit.step", "gd.edit_loop"},
    "gd.edit.warp": {"gd.edit.step"},
    "gd.optimize": {"gd.edit.step"}, "gd.optimize.backward": {"gd.optimize"},
    "gd.optimize.update": {"gd.optimize"},
    "gd.cfg": {"gd.edit.step"}, "gd.cfg.finish": {"gd.cfg"},
    "gd.unet": {"gd.inversion.step", "gd.optimize", "gd.cfg", "gd.dift.draw"},
    "gd.unet.mid_block": {"gd.unet"},
    "gd.attn.edit": {"gd.unet.down_blocks.0", "gd.unet.down_blocks.1", "gd.unet.down_blocks.2",
                     "gd.unet.mid_block", "gd.unet.up_blocks.1", "gd.unet.up_blocks.2",
                     "gd.unet.up_blocks.3"},
    "gd.dift.draw": {None},
}
PARENTS.update({f"gd.unet.{kind}_blocks.{i}": {"gd.unet"} for kind in ("down", "up")
                for i in range(4)})


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _spans(prof):
    """The "gd." spans of a finished profiler, (name, start_ns, end_ns), in
    order of start."""
    return sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.is_user_annotation() and e.name().startswith("gd.")),
                  key=lambda s: (s[1], -s[2]))


def _parents(spans):
    """Each span's innermost enclosing span (None outside all); fails where
    two spans overlap without nesting."""
    out, stack = [], []
    for name, s, e in spans:
        while stack and stack[-1][2] <= s:
            stack.pop()
        if stack:
            assert e <= stack[-1][2], f"{name} overlaps {stack[-1][0]} without nesting"
        out.append(stack[-1][0] if stack else None)
        stack.append((name, s, e))
    return out


def _profiled(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _spans(prof)


def _unet_calls(pipe):
    calls = []
    handle = pipe.unet.register_forward_pre_hook(lambda module, args: calls.append(1))
    return calls, handle


def test_annotate_is_a_shared_no_op_without_a_profiler():
    off = profiling.annotate("gd.unet")
    assert off is profiling.annotate("gd.edit.step", "step=0")
    assert isinstance(off, contextlib.nullcontext)
    with off, off:   # re-entered and nested alike
        pass
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert isinstance(profiling.annotate("gd.unet"), torch.profiler.record_function)


def test_group_span_tree_and_timings():
    pipe = Pipeline.create(ModelConfig.tiny(), image_size=SIZE, device="cpu")
    yy, xx = np.mgrid[0:SIZE, 0:SIZE]
    mask = (((xx - 25) ** 2 + (yy - 35) ** 2) < 12 ** 2).astype(np.float32)
    images = np.stack([np.random.RandomState(s).rand(SIZE, SIZE, 3).astype(np.float32)
                       for s in (0, 1)])
    transform = camera.compose_transform(tx=0.05)
    session = ShardedEditSession(pipe, EditConfig(num_ddim_steps=STEPS), device="cpu")
    calls, handle = _unet_calls(pipe)
    res, spans = _profiled(lambda: session.run_batch(
        images, np.full((2, SIZE, SIZE), 0.5, np.float32), np.stack([mask, mask]),
        np.stack([transform, transform])))
    handle.remove()

    names = [n for n, _, _ in spans]
    assert set(names) == set(PARENTS) - {"gd.dift.draw"}
    for (name, _, _), parent in zip(spans, _parents(spans)):
        assert parent in PARENTS[name], (name, parent)
    assert names.count("gd.edit.step") == STEPS
    assert names.count("gd.inversion.step") == STEPS
    assert names.count("gd.unet") == len(calls) > 0
    for block in [n for n in PARENTS if n.startswith("gd.unet.")]:
        assert names.count(block) == len(calls)
    assert names.count("gd.optimize") == names.count("gd.optimize.backward") >= 1

    assert list(res.timings) == [*PHASES, "total"]
    for phase in PHASES:
        (span,) = [s for s in spans if s[0] == "gd." + phase]
        assert res.timings[phase] == pytest.approx((span[2] - span[1]) / 1e9, abs=5e-3)
    assert res.timings["total"] >= sum(res.timings[p] for p in PHASES)


def test_dift_span_tree():
    pipe = Pipeline.create(ModelConfig.tiny_sd21(), image_size=SIZE, device="cpu")
    feat = SDFeaturizer(pipe, ensemble=2)
    calls, handle = _unet_calls(pipe)
    _, spans = _profiled(lambda: feat(np.random.RandomState(0).rand(SIZE, SIZE, 3)))
    handle.remove()
    names = [n for n, _, _ in spans]
    assert names.count("gd.dift.draw") == 2
    assert names.count("gd.unet") == len(calls) == 2
    assert {"gd.vae.encode", "gd.text.encode"} <= set(names)
    parents = _parents(spans)
    assert [p for (n, _, _), p in zip(spans, parents) if n == "gd.unet"] == ["gd.dift.draw"] * 2
    assert "gd.attn.edit" not in names
