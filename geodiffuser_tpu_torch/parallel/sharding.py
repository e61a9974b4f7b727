"""The batch driver's process share: the part of
`geodiffuser_tpu/parallel/sharding.py` one card needs.

Edits never communicate, so a sweep run by several processes (one a card,
or one a host) is a partition of its experiment folders: each process runs
its round-robin share, and nothing is exchanged, so no `torch.distributed`
group is made.  A launcher names the processes with the variables the JAX
package's `maybe_initialize_distributed` reads:

    GEODIFF_NUM_PROCESSES=4 GEODIFF_PROCESS_ID=$i \\
        python -m geodiffuser_tpu_torch.parallel.driver EXP_ROOT ...

Several edits share a card as one lockstep group (`parallel/batch.py`).
`per_chip_packing` and `device_hbm_gib` are the JAX package's sizing of
such a group, its thresholds set for a TPU; nothing reads them yet: the
driver's default stays the sequential path (`auto_group_size`), and the
GPU's packing waits for a benchmark that measures the group.  A group runs on
the session's one card, so the JAX package's mesh and placement helpers
(`make_mesh`, `edit_sharding`, `replicate_params`) have no counterpart
here: there is no mesh to build on one card.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence


def process_count() -> int:
    """The number of processes sharing the sweep (GEODIFF_NUM_PROCESSES, 1
    when unset)."""
    return int(os.environ.get("GEODIFF_NUM_PROCESSES", "1"))


def process_index() -> int:
    """This process's index among them (GEODIFF_PROCESS_ID, 0 when unset)."""
    index = int(os.environ.get("GEODIFF_PROCESS_ID", "0"))
    if not 0 <= index < process_count():
        raise ValueError(f"GEODIFF_PROCESS_ID={index} is outside 0..{process_count() - 1}")
    return index


def partition_for_process(items: Sequence, n_proc: Optional[int] = None,
                          pid: Optional[int] = None) -> List:
    """This process's share of a work list: round-robin by process index
    (keeps per-category runs interleaved so processes finish together)."""
    n_proc = process_count() if n_proc is None else n_proc
    pid = process_index() if pid is None else pid
    if n_proc <= 1:
        return list(items)
    return [it for i, it in enumerate(items) if i % n_proc == pid]


def device_hbm_gib(device="cuda") -> Optional[float]:
    """Memory of one CUDA device in GiB
    (`torch.cuda.get_device_properties(dev).total_memory`), or None for a
    CPU device or when no card is present."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    return torch.cuda.get_device_properties(dev).total_memory / 2 ** 30


def per_chip_packing(hbm_gib: Optional[float], image_size: int = 512) -> int:
    """Edits resident per card for a device of `hbm_gib` GiB: the JAX
    package's thresholds (`geodiffuser_tpu/parallel/sharding.py:
    per_chip_packing`, set on another machine): 4 from 14 GiB, 2 from 8, else
    1; doubled (at most 8) at 256^2 and below; 1 when the memory is unknown.
    No packing has been tuned on a GPU by it (`auto_group_size`)."""
    if hbm_gib is None:
        return 1
    if hbm_gib >= 14.0:
        per = 4
    elif hbm_gib >= 8.0:
        per = 2
    else:
        per = 1
    if image_size <= 256:
        per = min(8, per * 2)
    return per


def auto_group_size(image_size: int = 512) -> int:
    """The driver's default lockstep group: 0, the sequential single-edit
    path.  The JAX package packs edits only on a TPU, where its packing was
    measured; a GPU default waits for a benchmark that measures the group
    (`--group-size N` runs one)."""
    return 0
