"""Least time of the featurizations' self-attention work over the flash
forward kernels' device time, %."""

from portbench.metrics import layers


def read(rec):
    return layers.roofline(rec, "flash_flops", "flash_bytes", layers.FLASH_FWD)
