"""The batch driver's process share: the part of
`geodiffuser_tpu/parallel/sharding.py` one card needs.

Edits never communicate, so a sweep run by several processes (one a card,
or one a host) is a partition of its experiment folders: each process runs
its round-robin share, and nothing is exchanged, so no `torch.distributed`
group is made.  A launcher names the processes with the variables the JAX
package's `maybe_initialize_distributed` reads:

    GEODIFF_NUM_PROCESSES=4 GEODIFF_PROCESS_ID=$i \\
        python -m geodiffuser_tpu_torch.parallel.driver EXP_ROOT ...

Packing several edits into one lockstep batch on a card (`make_mesh`,
`per_chip_packing`, `edit_sharding` and `parallel/batch.py` in the JAX
package) is not ported yet.
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


def auto_group_size(image_size: int = 512) -> int:
    """The driver's default lockstep group: 0, the sequential single-edit
    path.  The JAX package packs edits only on a TPU, where the packing was
    measured; none has been measured on a GPU, and the lockstep batch is not
    ported."""
    return 0
