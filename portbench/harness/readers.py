"""Reductions that the per-layer metric readers (``portbench/metrics``)
share: device time by kernel family, and the idle share of a window."""

from __future__ import annotations

from typing import Iterable, Optional

from portbench.harness.trace import Trace, whole_name

# the decode stack step's kernels (csrc/decode_stream.cu: 12 a layer and
# one); its one LayerNorm launch shares a name with the fused head's, which
# the head's product kernel follows
STACK_KERNELS = ("gemm_partial_kernel", "self_attn_kernel",
                 "cross_attn_kernel", "residual_ln_kernel",
                 "gemm_epilogue_kernel")
LAYERNORM, HEAD_PRODUCT = "layernorm_kernel", "head_cluster_kernel"
FLASH_KERNELS = {"flash_fwd": ("flash_fwd_mma_kernel", "flash_fwd_kernel"),
                 "flash_bwd_dkdv": ("flash_bwd_dkdv_mma_kernel",
                                    "flash_bwd_dkdv_kernel"),
                 "flash_bwd_dq": ("flash_bwd_dq_mma_kernel",
                                  "flash_bwd_dq_kernel")}


def family_seconds(trace: Trace, families: Iterable[str]) -> float:
    fams = tuple(families)
    return sum(e - s for name, s, e in trace.ops
               if any(whole_name(name, f) for f in fams)) / 1e6


def stack_seconds(trace: Trace) -> float:
    """Device seconds of the decode stack step's kernels."""
    total = family_seconds(trace, STACK_KERNELS) * 1e6
    kernels = [op for op in trace.ops
               if not op[0].startswith(("Memcpy", "Memset"))]
    for i, (name, s, e) in enumerate(kernels):
        if whole_name(name, LAYERNORM) and not (
                i + 1 < len(kernels)
                and whole_name(kernels[i + 1][0], HEAD_PRODUCT)):
            total += e - s
    return total / 1e6


def idle_share(data: dict, unit: str) -> Optional[float]:
    """100 * (1 - busy / window) of the traced window, for a run whose
    data has ``unit`` ("batches" or "steps")."""
    trace = data.get("trace")
    if trace is None or unit not in data or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
