"""Seconds an edit in the edit loop (`timings.edit_loop`)."""

from portbench.metrics import layers


def read(rec):
    return layers.per_unit(rec, "edit_loop")
