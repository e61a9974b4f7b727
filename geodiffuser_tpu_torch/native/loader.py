"""ctypes bindings of the port's native experiment loader (exp_loader.cpp).

The port's copy of `geodiffuser_tpu/native/loader.py`.  The library is
compiled with g++ at first use into `geodiffuser_tpu_torch/_build/`, under a
name that hashes the source and the flags (as `kernels/_build.py` names the
kernel library), so a changed source is rebuilt.  `NativePrefetcher` yields
the port's `utils.exp_io.Experiment`, the same fields `exp_io.read_exp`
reads; a folder the native decoder cannot read (a PNG variant it does not
decode, a big-endian .npy) is handed to `exp_io.read_exp`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import tempfile
from typing import List, Optional

import numpy as np

from geodiffuser_tpu_torch.utils import exp_io

_DIR = pathlib.Path(__file__).resolve().parent
_SRC = _DIR / "exp_loader.cpp"
BUILD = _DIR.parent / "_build"
FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]
LIBS = ["-lz", "-lpthread"]
# kImages / kArrays of exp_loader.cpp
_IMAGES = ("input_image", "input_mask", "background_image", "transformed_image", "result")
_ARRAYS = ("depth", "transform", "image_shape")
_lib = None


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(FLAGS + LIBS).encode())
    h.update(_SRC.read_bytes())
    return BUILD / f"libexploader_{h.hexdigest()[:16]}.so"


def ensure_built() -> ctypes.CDLL:
    """Compile (if needed) and load the library; raises when g++ fails."""
    global _lib
    if _lib is not None:
        return _lib
    so = library_path()
    if not so.exists():
        BUILD.mkdir(parents=True, exist_ok=True)
        # build beside the target, then rename: concurrent builds never
        # load a half-written file
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
        os.close(fd)
        try:
            subprocess.run(["g++", *FLAGS, str(_SRC), "-o", tmp, *LIBS], check=True,
                           capture_output=True)
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    lib = ctypes.CDLL(str(so))
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.gd_load_npy.restype = ctypes.c_int
    lib.gd_load_npy.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
                                i64p, ctypes.POINTER(ctypes.c_int)]
    lib.gd_load_png.restype = ctypes.c_int
    lib.gd_load_png.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64, i64p, i64p]
    lib.gd_prefetcher_create.restype = ctypes.c_void_p
    lib.gd_prefetcher_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.gd_prefetcher_next.restype = ctypes.c_void_p
    lib.gd_prefetcher_next.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.gd_exp_ok.restype = ctypes.c_int
    lib.gd_exp_ok.argtypes = [ctypes.c_void_p]
    lib.gd_exp_path.restype = ctypes.c_char_p
    lib.gd_exp_path.argtypes = [ctypes.c_void_p]
    lib.gd_exp_image.restype = ctypes.c_int
    lib.gd_exp_image.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, i64p, i64p]
    lib.gd_exp_array.restype = ctypes.c_int
    lib.gd_exp_array.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int64, i64p,
        ctypes.POINTER(ctypes.c_int), ctypes.c_char_p, i64p,
    ]
    lib.gd_exp_free.argtypes = [ctypes.c_void_p]
    lib.gd_prefetcher_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def load_npy(path: str) -> np.ndarray:
    """A little-endian C-order .npy file as float64."""
    lib = ensure_built()
    out = np.empty(1 << 24, np.float64)
    shape = (ctypes.c_int64 * 8)()
    ndim = ctypes.c_int()
    rc = lib.gd_load_npy(path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                         out.size, shape, ctypes.byref(ndim))
    if rc != 0:
        raise IOError(f"gd_load_npy({path}) rc={rc}")
    shp = tuple(shape[i] for i in range(ndim.value))
    n = int(np.prod(shp)) if shp else 1
    return out[:n].reshape(shp).copy()


def load_png(path: str) -> np.ndarray:
    """An 8-bit non-interlaced PNG as (H, W, 3) uint8 RGB."""
    lib = ensure_built()
    out = np.empty((4096, 4096, 3), np.uint8)
    h = ctypes.c_int64()
    w = ctypes.c_int64()
    rc = lib.gd_load_png(path.encode(), out.ctypes.data_as(ctypes.c_void_p), out.size,
                         ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        raise IOError(f"gd_load_png({path}) rc={rc}")
    return out.reshape(-1)[: h.value * w.value * 3].reshape(h.value, w.value, 3).copy()


class NativePrefetcher:
    """Background-threaded experiment loader: threads decode the next
    folders while the caller works on the current one.

        for exp in NativePrefetcher(folders, threads=2):   # exp_io.Experiment
            ...
    """

    def __init__(self, folders: List[str], threads: int = 2, max_queue: int = 4):
        self.lib = ensure_built()
        self.folders = list(folders)
        arr = (ctypes.c_char_p * len(self.folders))(*[f.encode() for f in self.folders])
        self._handle = self.lib.gd_prefetcher_create(arr, len(self.folders), threads, max_queue)
        self._served = 0

    def __iter__(self):
        return self

    def _image(self, e, which: int) -> Optional[np.ndarray]:
        h, w = ctypes.c_int64(), ctypes.c_int64()
        if not self.lib.gd_exp_image(e, which, None, ctypes.byref(h), ctypes.byref(w)):
            return None
        img = np.empty((h.value, w.value, 3), np.uint8)
        self.lib.gd_exp_image(e, which, img.ctypes.data_as(ctypes.c_void_p), ctypes.byref(h),
                              ctypes.byref(w))
        return img

    def _array(self, e, which: int) -> Optional[np.ndarray]:
        shape, ndim = (ctypes.c_int64 * 8)(), ctypes.c_int()
        descr, nbytes = ctypes.create_string_buffer(16), ctypes.c_int64()
        args = (shape, ctypes.byref(ndim), descr, ctypes.byref(nbytes))
        if not self.lib.gd_exp_array(e, which, None, 0, *args):
            return None
        raw = np.empty(nbytes.value, np.uint8)
        self.lib.gd_exp_array(e, which, raw.ctypes.data_as(ctypes.c_void_p), nbytes, *args)
        shp = tuple(shape[i] for i in range(ndim.value))
        return raw.view(np.dtype(descr.value.decode()))[: int(np.prod(shp))].reshape(shp)

    def __next__(self) -> exp_io.Experiment:
        if self._served >= len(self.folders):
            raise StopIteration
        e = self.lib.gd_prefetcher_next(self._handle, self._served)
        self._served += 1
        if not e:
            raise StopIteration
        try:
            path = self.lib.gd_exp_path(e).decode()
            if not self.lib.gd_exp_ok(e):
                return exp_io.read_exp(path)
            images = {name: self._image(e, i) for i, name in enumerate(_IMAGES)}
            arrays = {name: self._array(e, i) for i, name in enumerate(_ARRAYS)}
            shape = arrays.pop("image_shape")
            return exp_io.Experiment(
                input_mask=images.pop("input_mask")[..., 0].astype(np.float32) / 255.0,
                image_shape=np.array([512, 512]) if shape is None else shape,
                path=path, **images, **arrays,
            )
        finally:
            self.lib.gd_exp_free(e)

    def close(self) -> None:
        """Stop the threads and free what they decoded ahead."""
        if getattr(self, "_handle", None):
            self.lib.gd_prefetcher_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
