"""flash_attention_roofline: the flash-attention kernels' share of their
roofline, in %: the least time of the profiled steps' calls (24 forward,
24 dK/dV, 24 dQ a step at this configuration; counts/work.py
``flash_bounds``, from each call's shapes and key pads) over the
profiler's device time of the three kernels."""

from portbench.counts import work
from portbench.harness.readers import FLASH_KERNELS, family_seconds


def read(data: dict):
    trace = data.get("trace")
    if trace is None or not data.get("profiled_batches"):
        return None
    seconds = family_seconds(trace, [k for ks in FLASH_KERNELS.values()
                                     for k in ks])
    if seconds <= 0:
        return None
    bound = 0.0
    for batch in data["profiled_batches"]:
        for b, h, d, tq, kv_pad, causal, calls in work.train_flash_calls(
                batch, data["model"]):
            for w in work.flash_bounds(b, h, d, tq, kv_pad, causal).values():
                bound += calls * work.least_s(w)
    return 100.0 * bound / seconds
