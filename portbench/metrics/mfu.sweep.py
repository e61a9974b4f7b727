"""Model FLOPs of the edit groups over their time at the bf16 peak, %."""

from portbench.metrics import layers


def read(rec):
    return layers.mfu(rec)
