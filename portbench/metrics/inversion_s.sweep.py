"""Seconds an edit in the DDIM inversion (`timings.inversion`)."""

from portbench.metrics import layers


def read(rec):
    return layers.per_unit(rec, "inversion")
