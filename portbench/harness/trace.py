"""One profiler window of the traced run, reduced to device intervals.

The window runs spin kernels (``torch.cuda._sleep``) before its calls and
after them: after a window of thousands of kernels, the profiler of this
PyTorch build loses records at a window's edge, and spin kernels keep the
calls' own records whole (the program's ``tools/profiler_drops.py``).
Their records are left out; the window is the device time from the end of
the leading spins to the start of the trailing ones.
"""

from __future__ import annotations

import bisect
import re
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch

SPIN = "spin_kernel"
FILL = 64


@dataclass
class Trace:
    """Device operations [(name, start us, end us)] in start order, the
    window (start us, end us) and the host's events
    [(start us, end us, name)] in start order."""

    ops: List[Tuple[str, float, float]]
    window: Tuple[float, float]
    host: List[Tuple[float, float, str]]
    named: Optional["Trace"] = None

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy_s(self) -> float:
        """Seconds in which some device operation ran (their union)."""
        busy, end = 0.0, self.window[0]
        for _, s, e in self.ops:
            s, e = max(s, end), min(e, self.window[1])
            if e > s:
                busy += e - s
                end = e
        return busy / 1e6

    def gaps(self) -> List[Tuple[float, float]]:
        """The idle intervals of the window (us)."""
        out, end = [], self.window[0]
        for _, s, e in self.ops:
            if s > end:
                out.append((end, min(s, self.window[1])))
            end = max(end, e)
        if self.window[1] > end:
            out.append((end, self.window[1]))
        return [g for g in out if g[1] > g[0]]

    def host_at(self, t: float, scan: int = 4000) -> str:
        """The innermost host event open at ``t`` (us), or "python"."""
        i = bisect.bisect_right(self.host, (t, float("inf"), "")) - 1
        for j in range(i, max(i - scan, -1), -1):
            s, e, name = self.host[j]
            if e >= t:
                return name
        return "python"


def whole_name(name: str, family: str) -> bool:
    """Whether ``family`` is a whole identifier in the demangled name."""
    return re.search(rf"(?<![A-Za-z0-9_]){re.escape(family)}(?![A-Za-z0-9_])",
                     name) is not None


def _window(fn, calls: int, fill: int, host: bool):
    cuda = torch.cuda.is_available()
    acts = [torch.profiler.ProfilerActivity.CPU] if host or not cuda else []
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    spin = (lambda: torch.cuda._sleep(100)) if cuda else (lambda: None)
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(fill):
            spin()
        for _ in range(calls):
            fn()
        for _ in range(fill):
            spin()
        if cuda:
            torch.cuda.synchronize()
    return reduce(prof.events())


def profile(fn: Callable[[], None], calls: int, fill: int = FILL) -> Trace:
    """Runs ``fn`` ``calls`` times in one profiler window of the device
    alone, between ``fill`` spin kernels on either side, and returns its
    :class:`Trace` (on a machine without a card, of host events only).
    Recording every host operation slows the host several times over in
    a step of thousands of launches, so the host's events come from a
    second window of one call, ``Trace.named``, which names the gaps."""
    main = _window(fn, calls, fill, host=False)
    main.named = _window(fn, 1, fill, host=True)
    return main


def reduce(events) -> Trace:
    """The :class:`Trace` of a profiler's ``events()``."""
    ops, spins, host = [], [], []
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == torch.autograd.DeviceType.CUDA:
            (spins if SPIN in e.name else ops).append((e.name, s, t))
        elif t > s:
            host.append((s, t, e.name))
    ops.sort(key=lambda o: o[1])
    host.sort()
    if not ops:
        return Trace([], (0.0, 0.0), host)
    first, last = ops[0][1], max(o[2] for o in ops)
    lead = [e for _, s, e in spins if s < first]
    trail = [s for _, s, e in spins if s >= last]
    window = (max(lead) if lead else first, min(trail) if trail else last)
    return Trace(ops, window, host)


def breakdown(trace: Trace, top: int = 10) -> Dict[str, list]:
    """The device operations that took the most time, and the idle gaps
    summed by what the host was doing then (in ``trace.named`` where the
    host's events were recorded apart), each [[name, seconds], ...]."""
    by_op: Dict[str, float] = {}
    for name, s, e in trace.ops:
        by_op[name] = by_op.get(name, 0.0) + (e - s) / 1e6
    by_host: Dict[str, float] = {}
    named = trace.named or trace
    for s, e in named.gaps():
        key = named.host_at(0.5 * (s + e))
        by_host[key] = by_host.get(key, 0.0) + (e - s) / 1e6
    ranked = lambda d: [[k[:160], v] for k, v in
                        sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": ranked(by_op), "idle_gaps": ranked(by_host)}
