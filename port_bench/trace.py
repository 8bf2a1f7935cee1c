"""From a torch.profiler trace of the measured window to intervals and
sums: device busy time, idle gaps labelled by the benchmark's span the
host was in, and device time by kernel kind.

Spans are the benchmark's own: ``span(name)`` wraps a call into a layer
in ``torch.profiler.record_function("bench:" + name)`` while a trace is
on, and costs nothing otherwise.
"""

from __future__ import annotations

import bisect
import contextlib
from dataclasses import dataclass, field

SPAN_PREFIX = "bench:"
WINDOW = "window"


class Spans:
    """``spans(name)`` is a context that records a span in a traced run."""

    def __init__(self, on: bool):
        self.on = on

    def __call__(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        from torch.profiler import record_function
        return record_function(SPAN_PREFIX + name)


# kernel kinds by name (bench_train._kind's classes): cuDNN convs, then
# cuBLAS/CUTLASS GEMMs (cuBLAS's Hopper kernels are named nvjet_*);
# every other kernel is an elementwise, reduction or layout pass
_CONV = ("conv", "fprop", "dgrad", "wgrad", "cudnn", "implicit")
_GEMM = ("gemm", "cutlass", "cublas", "sm90_xmma", "s16816", "s1688",
         "nvjet")
_COPY = ("memcpy", "memset")


def kind(name: str) -> str:
    n = name.lower()
    if n.startswith(_COPY):
        return "copy"
    if any(k in n for k in _CONV):
        return "conv"
    if any(k in n for k in _GEMM):
        return "gemm"
    return "other"


@dataclass
class Trace:
    """Intervals in microseconds on the trace's clock, inside the window."""

    start: float
    end: float
    device: list = field(default_factory=list)   # (start, end, name)
    spans: list = field(default_factory=list)    # (start, end, name)

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    def busy_s(self) -> float:
        """Seconds in which any kernel or copy ran on the device."""
        return sum(b - a for a, b in _union(self.device)) / 1e6

    def seconds(self, pred) -> float:
        """Summed device seconds of the intervals whose name passes."""
        return sum(b - a for a, b, n in self.device if pred(n)) / 1e6

    def gaps(self) -> list[tuple[float, float]]:
        """The window's idle intervals on the device."""
        out, at = [], self.start
        for a, b in _union(self.device):
            if a > at:
                out.append((at, a))
            at = max(at, b)
        if self.end > at:
            out.append((at, self.end))
        return out

    def idle_by_span(self, top: int = 10) -> list:
        """Idle seconds summed by the span the host was in at each gap's
        middle (the spans inside the window do not nest), longest
        first."""
        spans = sorted(self.spans)
        starts = [a for a, _, _ in spans]
        by: dict[str, float] = {}
        for a, b in self.gaps():
            mid = (a + b) / 2
            i = bisect.bisect_right(starts, mid) - 1
            name = (spans[i][2] if i >= 0 and mid < spans[i][1]
                    else "outside any span")
            by[name] = by.get(name, 0.0) + (b - a) / 1e6
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:top]

    def top_ops(self, top: int = 10) -> list:
        """Device seconds summed by operation name, longest first."""
        by: dict[str, float] = {}
        for a, b, name in self.device:
            by[name] = by.get(name, 0.0) + (b - a) / 1e6
        return sorted(([k[:160], v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:top]


def _union(intervals) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b, *_ in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def from_profiler(prof) -> Trace:
    """The window's device intervals and spans from a finished
    ``torch.profiler.profile`` that ran one ``span("window")``."""
    from torch.autograd import DeviceType

    device, spans, window = [], [], None
    for e in prof.events():
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            # a span's annotation on the device's timeline is no work
            if not e.name.startswith(SPAN_PREFIX):
                device.append((a, b, e.name))
        elif e.name.startswith(SPAN_PREFIX):
            name = e.name[len(SPAN_PREFIX):]
            if name == WINDOW:
                window = (a, b)
            else:
                spans.append((a, b, name))
    if window is None:
        raise RuntimeError("the trace holds no window span")
    lo, hi = window
    clip = [(max(a, lo), min(b, hi), n) for a, b, n in device
            if b > lo and a < hi]
    return Trace(lo, hi, clip, spans)
