"""Model FLOPs of the DIFT featurizations over their time at the bf16 peak, %."""

from portbench.metrics import layers


def read(rec):
    return layers.mfu(rec)
