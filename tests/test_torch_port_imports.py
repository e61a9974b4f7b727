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

IMPORT_ALL = r"""
import importlib, pkgutil, sys
import geodiffuser_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith("jax.") or n == "flax" or n.startswith("flax.")
             or n == "geodiffuser_tpu" or n.startswith("geodiffuser_tpu."))
print(len(names), bad)
assert len(names) >= 20, names
assert not bad, bad
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    out = subprocess.run([sys.executable, "-c", IMPORT_ALL], capture_output=True, text=True,
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


def test_kernel_wrappers_refuse_cpu_tensors_and_never_fall_back(monkeypatch):
    """The CUDA wrappers raise on CPU tensors; only the public wrappers take
    the plain version, and only for CPU tensors.  Without nvcc the build
    raises instead of falling back."""
    q = torch.zeros(2, 64, 40)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_fwd_cuda(q, q, q, 0.1)
    with pytest.raises(ValueError, match="CUDA"):
        rc.corr_fwd_cuda(q, q, q, q, torch.zeros(64), torch.zeros(64), torch.zeros(64), 0.1)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build._nvcc()
    counts = dict(fa.LAUNCHES)
    fa.flash_attention(q, q, q, 0.1)     # CPU tensors: the plain version, no launch counted
    assert fa.LAUNCHES == counts
