"""Build the port's CUDA kernels and load them with ctypes.

At first use every `csrc/*.cu` is compiled for `sm_90a` by its own `nvcc`
(all started together), linked into one shared library with a plain C
interface, and loaded.  The library lands in `geodiffuser_tpu_torch/_build/`
under a name that hashes the sources and flags, so a changed source is
rebuilt and an unchanged one is reused; ptxas's report of every kernel
(registers, spills, shared memory, warnings) is kept beside it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# seconds the last build took (0.0 when the library was already built)
build_seconds = 0.0

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
SIGNATURES = {
    "gd_flash_fwd": [_P] * 5 + [_I] * 4 + [_F, _I, _I, _P],
    "gd_flash_bwd": [_P] * 10 + [_I] * 4 + [_F, _I, _I, _I, _P],
    "gd_corr_spans": [_I],
    "gd_corr_fwd": [_P] * 15 + [_I] * 5 + [_F, _I, _P],
    "gd_corr_bwd": [_P] * 11 + [_I] * 4 + [_F, _I, _P],
    "gd_corr_fwd_bf16": [_P] * 16 + [_I] * 8 + [_F, _P],
    "gd_corr_bwd_bf16": [_P] * 17 + [_I] * 5 + [_F, _P],
    "gd_splat_workspace": [_I] * 4,
    "gd_splat_fused": [_P] * 4 + [_I] * 4 + [_F] * 3 + [_P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with "
                           "the CUDA toolkit (set CUDA_HOME or put nvcc on PATH)")
    return path


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    cus, headers = _sources()
    for p in cus + headers:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> pathlib.Path:
    """Compile (if needed) and return the path of the shared library."""
    global build_seconds
    out = BUILD / f"libgeodiff_{_digest()}.so"
    if out.exists():
        build_seconds = 0.0
        return out
    t0 = time.time()
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    cus, _ = _sources()
    with tempfile.TemporaryDirectory(dir=BUILD) as tmp:
        objs = [os.path.join(tmp, p.stem + ".o") for p in cus]
        procs = [
            subprocess.Popen([nvcc, *FLAGS, "-c", str(src), "-o", obj],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(cus, objs)
        ]
        errors, report = [], []
        for src, proc in zip(cus, procs):
            log, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{src.name}:\n{log}")
            report.append(f"== {src.name}\n{log}")
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        out.with_suffix(".ptxas.txt").write_text("\n".join(report))
        so = os.path.join(tmp, out.name)
        link = subprocess.run([nvcc, *FLAGS, "-shared", *objs, "-o", so],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + link.stdout + link.stderr)
        os.replace(so, out)
    build_seconds = time.time() - t0
    return out


def ptxas_report() -> str:
    """ptxas's report of the built library's kernels (written by `build`)."""
    return build().with_suffix(".ptxas.txt").read_text()


@functools.lru_cache(maxsize=1)
def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    handle = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(handle, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return handle


def check(err: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")


def dtype_code(t) -> int:
    import torch

    codes = {torch.float32: 0, torch.bfloat16: 1}
    if t.dtype not in codes:
        raise TypeError(f"kernel inputs must be float32 or bfloat16, got {t.dtype}")
    return codes[t.dtype]


def stream_ptr(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(*tensors) -> None:
    dev = tensors[0].device
    for t in tensors:
        if not t.is_cuda or t.device != dev:
            raise ValueError("kernel inputs must all lie on one CUDA device")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
