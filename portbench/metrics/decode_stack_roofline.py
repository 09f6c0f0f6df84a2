"""decode_stack_roofline: the decode stack step's share of its roofline,
in %: the least time of its calls in the profiled batches (each position's
``stack_call`` bound, counts/work.py) over the profiler's device time of
its kernels."""

from portbench.counts import work
from portbench.harness.readers import stack_seconds


def read(data: dict):
    trace = data.get("trace")
    if trace is None or "batches" not in data:
        return None
    seconds = stack_seconds(trace)
    if seconds <= 0:
        return None
    m, b, n = data["model"], data["batch"], data["positions"]
    bound = sum(work.least_s(work.stack_call(m, b, pos, data["tc"], n))
                for pos in range(n))
    return 100.0 * bound * data["profiled_batches"] / seconds
