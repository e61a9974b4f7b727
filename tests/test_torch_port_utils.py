"""The port's packaging and its profiling and checkpoint utilities, on the
CPU: every data file the port opens from its own tree at run time is
package data in pyproject.toml; `PhaseTimer`, `SweepManifest`,
`save_params` / `load_params` and `trace` against the JAX package's
`utils/profiling.py` and `utils/checkpoint.py` where those have a
counterpart.
"""

import fnmatch
import json
import os
import pathlib
import tomllib

import pytest
import torch
from safetensors.torch import load_file

from geodiffuser_tpu.utils import checkpoint as jcheckpoint
from geodiffuser_tpu.utils import profiling as jprofiling
from geodiffuser_tpu_torch.kernels import _build
from geodiffuser_tpu_torch.models import weights
from geodiffuser_tpu_torch.native import loader
from geodiffuser_tpu_torch.utils import checkpoint, profiling

REPO = pathlib.Path(__file__).resolve().parent.parent


def _package_of(path: pathlib.Path):
    """(dotted name, directory) of the innermost package holding `path`."""
    d = path.parent
    while not (d / "__init__.py").exists():
        d = d.parent
    return ".".join(d.relative_to(REPO).parts), d


def test_runtime_data_files_are_package_data():
    """The CUDA sources the kernels build from, the native loader's source
    and the checkpoint manifests each match a package-data pattern of their
    package, so a wheel carries them; the JAX package's entries and the two
    console scripts are there."""
    with open(REPO / "pyproject.toml", "rb") as f:
        project = tomllib.load(f)
    data = project["tool"]["setuptools"]["package-data"]
    runtime = [*sorted(_build.CSRC.glob("*.cu*")), loader._SRC,
               *sorted(weights.MANIFESTS.glob("*.json"))]
    assert len(runtime) >= 18 and all(p.exists() for p in runtime)
    assert {"dpt_large.json", "zoedepth_nk.json", "sam_vit_h.json",
            "depth_anything_vitl14.json"} <= {p.name for p in runtime}
    for path in runtime:
        package, root = _package_of(path)
        rel = path.relative_to(root).as_posix()
        assert any(fnmatch.fnmatch(rel, pat) for pat in data.get(package, ())), (package, rel)
    assert data["geodiffuser_tpu.native"] == ["*.cpp"]
    scripts = project["project"]["scripts"]
    assert scripts["geodiffuser-sweep"] == "geodiffuser_tpu.parallel.driver:main"
    assert scripts["geodiffuser-torch-sweep"] == "geodiffuser_tpu_torch.parallel.driver:main"


def test_phase_timer_summary_matches_jax(tmp_path):
    """The same totals give the JAX summary (keys, rounding, order by total)
    and dump; a phase counts and synchronizes nothing for CPU tensors."""
    ours, theirs = profiling.PhaseTimer(), jprofiling.PhaseTimer()
    for t in (ours, theirs):
        t.totals = {"encode": 0.123456, "edit": 2.5, "decode": 0.04}
        t.counts = {"encode": 1, "edit": 3, "decode": 2}
    assert ours.summary() == theirs.summary()
    assert list(ours.summary()) == ["edit", "encode", "decode"]
    assert list(ours.summary()["edit"]) == ["total_s", "count", "mean_s"]
    assert ours.dump(str(tmp_path / "a.json")) == theirs.dump(str(tmp_path / "b.json"))
    assert (tmp_path / "a.json").read_text() == (tmp_path / "b.json").read_text()
    timer = profiling.PhaseTimer()
    for _ in range(2):
        with timer.phase("step", block_on={"x": [torch.ones(3)], "y": (torch.zeros(1),)}):
            torch.ones(4).sum()
    assert timer.counts == {"step": 2} and timer.totals["step"] > 0


def test_sweep_manifest_writes_the_jax_file(tmp_path):
    ours, theirs = str(tmp_path / "ours.json"), str(tmp_path / "theirs.json")
    for cls, path in ((checkpoint.SweepManifest, ours), (jcheckpoint.SweepManifest, theirs)):
        m = cls(path)
        assert not m.is_done("Translation_3D/0")
        m.mark("Translation_3D/0", 1.5)
        m.mark("Removal/3", 0.25)
    assert pathlib.Path(ours).read_text() == pathlib.Path(theirs).read_text()
    again = checkpoint.SweepManifest(theirs)
    assert again.is_done("Removal/3") and again.done["Translation_3D/0"] == 1.5
    assert not os.path.exists(ours + ".tmp")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16],
                         ids=["f32", "bf16", "f16"])
def test_params_round_trip_bit_equal(tmp_path, dtype):
    """A nested dict of tensors, flattened with '.', written and read back
    with equal bits: flat, in `like`'s structure and dtype, and by the
    safetensors package; a file of another structure is refused."""
    g = torch.Generator().manual_seed(0)
    params = {"unet": {"conv_in.weight": torch.randn(4, 3, 3, 3, generator=g).to(dtype),
                       "conv_in.bias": torch.randn(4, generator=g).to(dtype)},
              "step": torch.arange(5)}
    path = str(tmp_path / "params.safetensors")
    checkpoint.save_params(path, params)
    flat = checkpoint.load_params(path)
    assert set(flat) == {"unet.conv_in.weight", "unet.conv_in.bias", "step"}
    ref = load_file(path)
    want = {"unet.conv_in.weight": params["unet"]["conv_in.weight"],
            "unet.conv_in.bias": params["unet"]["conv_in.bias"], "step": params["step"]}
    for k, v in want.items():
        assert flat[k].dtype == v.dtype and torch.equal(flat[k].view(-1), v.view(-1))
        assert ref[k].dtype == v.dtype and torch.equal(ref[k], v)
    back = checkpoint.load_params(path, like=params)
    assert back["unet"]["conv_in.weight"].dtype == dtype
    assert torch.equal(back["unet"]["conv_in.weight"], params["unet"]["conv_in.weight"])
    with pytest.raises(ValueError, match="conv_in.bias"):
        checkpoint.load_params(path, like={"unet": {"conv_in.weight": params["unet"]
                                                    ["conv_in.weight"]}, "step": params["step"]})
    with pytest.raises(FileExistsError):
        checkpoint.save_params(path, params, force=False)


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    logdir = tmp_path / "trace"
    with profiling.trace(str(logdir)):
        with profiling.annotate("denoise_step"):
            (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    files = list(logdir.glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "denoise_step" for e in events)
