"""decode_mfu: a served batch's share of the chip's peak, in %: the least
time of its required work (counts/work.py ``decode_batch``: for each part
the larger of operations at 989 TFLOP/s and bytes at 3.35 TB/s, summed)
over the batch's time in the traced run's window (host clock)."""

from portbench.counts import work


def read(data: dict):
    if not data.get("batches") or data.get("window_s", 0) <= 0:
        return None
    parts = work.decode_batch(data["model"], data["vocab"], data["batch"],
                              data["positions"], data["tc"])
    least = sum(work.least_s(p) for p in parts)
    return 100.0 * least / (data["window_s"] / data["batches"])
