"""train_step_mfu: the train step's share of the chip's bf16 peak, in %:
model operations a step (counts/work.py ``train_step_flops``: the frozen
backbone forward, forward and backward of the trainable products, nothing
recomputed) times the steps of the traced run's window (outside the
profiled part), over the window's seconds and 989 TFLOP/s."""

from portbench.counts import work


def read(data: dict):
    if not data.get("steps") or data.get("window_s", 0) <= 0:
        return None
    flops = work.train_step_flops(data["model"], data["vocab"], data["batch"],
                                  data["tc"], data["tp"], data["tq"])
    return (100.0 * flops * data["steps"] / data["window_s"]
            / work.BF16_FLOPS_PER_S)
