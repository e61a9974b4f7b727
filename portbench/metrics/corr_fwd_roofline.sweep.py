"""Least time of the removal-correlation work of the live rows over the
correlation forward kernels' device time, %."""

from portbench.metrics import layers


def read(rec):
    return layers.roofline(rec, "corr_flops", "corr_bytes", layers.CORR_FWD)
