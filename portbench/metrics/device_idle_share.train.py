"""device_idle_share.train: the share of the profiled train steps' window,
in %, in which no operation ran on the device: 100 * (1 - union of the
device operations' intervals / the window)."""

from portbench.harness.readers import idle_share


def read(data: dict):
    return idle_share(data, "steps")
