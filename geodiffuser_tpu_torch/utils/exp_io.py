"""Experiment-folder IO: the on-disk DDIM inversion cache.

A copy of `geodiffuser_tpu/utils/exp_io.py:INVERSION_CACHE_FILE`,
`load_inversion` and `save_inversion` (that module imports PIL for its PNG
IO, which the port does not need here).  The file format is the JAX
package's, so either package reads a cache the other wrote: one
`inversion.npz` per experiment folder holding `key` (a string) and
`all_latents` (float32, (T + 1, S0, h, w, 4)).
"""

from __future__ import annotations

import os
import zipfile
from typing import Optional

import numpy as np

INVERSION_CACHE_FILE = "inversion.npz"


def load_inversion(folder: str, key: str) -> Optional[np.ndarray]:
    """The cached DDIM inversion trajectory for `key`, or None.

    `all_latents` is a pure function of (image, prompt, scheduler, model),
    so the experiment folder caches it for the iterate-on-transform-knobs
    workflow.  The file holds exactly one entry; a key mismatch (another
    prompt, config or model) or a file that cannot be read is a miss, and
    the next save overwrites it.
    """
    path = os.path.join(folder, INVERSION_CACHE_FILE)
    if not os.path.exists(path):
        return None
    try:
        with np.load(path, allow_pickle=False) as z:
            if str(z["key"]) != key:
                return None
            return z["all_latents"]
    except (OSError, KeyError, ValueError, EOFError, zipfile.BadZipFile):
        return None


def save_inversion(folder: str, key: str, all_latents: np.ndarray) -> None:
    """Write the trajectory for `key` into `folder` (an existing directory;
    nothing is written otherwise), replacing the file in one rename."""
    if not os.path.isdir(folder):
        return
    tmp = os.path.join(folder, INVERSION_CACHE_FILE + ".tmp.npz")
    np.savez(tmp, key=np.str_(key), all_latents=np.asarray(all_latents, np.float32))
    os.replace(tmp, os.path.join(folder, INVERSION_CACHE_FILE))
