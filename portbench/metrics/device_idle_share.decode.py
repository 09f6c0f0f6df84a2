"""device_idle_share.decode: the share of the profiled serving window, in
%, in which no operation ran on the device: 100 * (1 - union of the
device operations' intervals / the window)."""

from portbench.harness.readers import idle_share


def read(data: dict):
    return idle_share(data, "batches")
