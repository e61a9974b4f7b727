"""Import and device rules of the PyTorch port."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from geodiffuser_tpu_torch.config import EditConfig, ModelConfig
from geodiffuser_tpu_torch.core import editor
from geodiffuser_tpu_torch.core.pipeline import Pipeline
from geodiffuser_tpu_torch.kernels import _build
from geodiffuser_tpu_torch.kernels import flash_attention as fa
from geodiffuser_tpu_torch.kernels import removal_corr as rc
from geodiffuser_tpu_torch.kernels import splat as ks

IMPORT_ALL = r"""
import importlib, pkgutil, sys
import geodiffuser_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "flax", "geodiffuser_tpu", "PIL", "safetensors"))
print(len(names), bad)
assert len(names) >= 21, names
assert {"geodiffuser_tpu_torch.kernels.splat", "geodiffuser_tpu_torch.core.editor",
        "geodiffuser_tpu_torch.core.edit_attention", "geodiffuser_tpu_torch.core.inversion",
        "geodiffuser_tpu_torch.utils.exp_io", "geodiffuser_tpu_torch.utils.png",
        "geodiffuser_tpu_torch.native.loader", "geodiffuser_tpu_torch.parallel.driver",
        "geodiffuser_tpu_torch.parallel.sharding"} <= set(names), names
assert not bad, bad
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    out = subprocess.run([sys.executable, "-c", IMPORT_ALL], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


IMPORT_DRIVER = r"""
import sys
import geodiffuser_tpu_torch.parallel.driver, geodiffuser_tpu_torch.native.loader
import geodiffuser_tpu_torch.utils.png, geodiffuser_tpu_torch.models.weights
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "geodiffuser_tpu", "PIL", "safetensors"))
assert not bad, bad
"""


def test_driver_path_imports_neither_jax_pil_nor_safetensors():
    """The batch driver, the native loader, the PNG codec and the checkpoint
    loader: no JAX, no JAX package, no PIL and no safetensors package."""
    out = subprocess.run([sys.executable, "-c", IMPORT_DRIVER], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_need_a_card_unless_asked_for_cpu(no_card):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Pipeline.create(ModelConfig.tiny(), image_size=64)
    pipe = Pipeline.create(ModelConfig.tiny(), image_size=64, device="cpu")
    assert pipe.device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        editor.EditSession(pipe, EditConfig(num_ddim_steps=2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        editor.perform_geometric_edit(pipe, np.zeros((64, 64, 3)), np.full((64, 64), 0.5),
                                      np.zeros((64, 64)), np.eye(4))
    assert editor.EditSession(pipe, EditConfig(num_ddim_steps=2), device="cpu").device.type == "cpu"
    remover = EditConfig(edit_type="geometry_remover", num_ddim_steps=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        editor.EditSession(pipe, remover)
    assert editor.EditSession(pipe, remover, device="cpu").mode == "remover"
    scene = (np.zeros((64, 64, 3)), np.zeros((64, 64, 3)), np.zeros((64, 64)),
             np.full((64, 64), 0.5), np.eye(4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        editor.stitch_composite(EditConfig(edit_type="geometry_stitch"), *scene)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        editor.perform_stitch(pipe, *scene)
    with pytest.raises(ValueError, match="edit_type"):
        editor.EditSession(pipe, EditConfig(edit_type="geometry_resizer"), device="cpu")


def test_kernel_wrappers_refuse_cpu_tensors_and_never_fall_back(monkeypatch):
    """The CUDA wrappers raise on CPU tensors; only the public wrappers take
    the plain version, and only for CPU tensors.  Without nvcc the build
    raises instead of falling back."""
    q = torch.zeros(2, 64, 40)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_fwd_cuda(q, q, q, 0.1)
    with pytest.raises(ValueError, match="CUDA"):
        rc.corr_fwd_cuda(q, q, q, q, torch.zeros(64), torch.zeros(64), torch.zeros(64), 0.1)
    img, coords = torch.zeros(8, 8, 3), torch.zeros(8, 8, 3)
    with pytest.raises(ValueError, match="CUDA"):
        ks.splat_fused_cuda(img, coords, 1.3, 1.0, 20.0)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build._nvcc()
    counts = dict(fa.LAUNCHES), dict(ks.LAUNCHES)
    fa.flash_attention(q, q, q, 0.1)     # CPU tensors: the plain version, no launch counted
    ks.splat_fused(img, coords)
    assert (fa.LAUNCHES, ks.LAUNCHES) == counts
