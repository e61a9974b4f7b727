"""Share of the traced edit groups in which the device runs nothing, %."""

from portbench.metrics import layers


def read(rec):
    return layers.device_idle(rec)
