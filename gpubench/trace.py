"""The reduction of a ``torch.profiler`` trace to what the metrics read.

:func:`reduce_events` takes the profiler's events of a traced window and
returns a :class:`Trace`: the device operations as intervals with their
names, the host ranges (``record_function``: the program's own and the
benchmark's ``gpubench/...`` spans) as intervals, and the window. Every time
is in seconds on the profiler's clock. The arithmetic on it (busy time as
the union of device intervals, idle gaps labelled by the host range open
when each began, device time by kernel class) is plain functions here, so
that the tests can feed them a synthetic trace.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

# kernel name (lower case) -> class of the device-time breakdown: the
# program's six kernels by their CUDA names, then the library's kinds
KERNEL_CLASSES = (("K1", ("concat_bn_relu",)), ("K2", ("dense_layer",)),
                  ("K3", ("phase_head",)),
                  ("K4", ("dense_block_kernel", "dense_block_mma_kernel")),
                  ("K5", ("dense_block_recompute",)), ("K6", ("stem_pool",)),
                  ("convolutions", ("conv", "cudnn", "cutlass", "xmma", "gemm", "sm90")),
                  ("matrix products", ("nvjet",)),
                  ("concat copies", ("catarray",)), ("pooling", ("pool",)),
                  ("copies and fills", ("memcpy", "memset")),
                  ("elementwise", ("elementwise", "vectorized", "unrolled", "reduce")))

WINDOW_SPAN = "gpubench/window"


def kernel_class(name: str) -> str:
    low = name.lower()
    return next((c for c, keys in KERNEL_CLASSES if any(k in low for k in keys)), "other")


@dataclasses.dataclass
class Trace:
    window: Tuple[float, float]
    device: List[Tuple[float, float, str]]      # (start, end, name)
    host: List[Tuple[float, float, str]]        # record_function ranges

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]


def reduce_events(events) -> Trace:
    """A :class:`Trace` from ``profile.events()``: device operations
    (kernels, copies, fills) and the host's ``record_function`` ranges of
    the thread that traces (the profiler records no other thread's ranges);
    the window is the benchmark's ``gpubench/window`` range."""
    from torch.autograd import DeviceType

    device, host, window = [], [], None
    # a record_function range shows on the device's timeline too, as a user
    # annotation under the range's name: not an operation
    host_names = {ev.name for ev in events if ev.device_type != DeviceType.CUDA}
    for ev in events:
        start, end = ev.time_range.start * 1e-6, ev.time_range.end * 1e-6
        if ev.device_type == DeviceType.CUDA:
            if ev.name not in host_names and not getattr(ev, "is_user_annotation", False):
                device.append((start, end, ev.name))
        elif ev.name == WINDOW_SPAN:
            window = (start, end)
        elif ev.name.startswith(("gpubench/", "train_step/", "Optimizer.step")):
            host.append((start, end, ev.name))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN} range")
    device.sort()
    return Trace(window=window, device=device, host=sorted(host))


def clip(intervals, lo, hi):
    return [(max(s, lo), min(e, hi)) + tuple(rest) for s, e, *rest in intervals
            if e > lo and s < hi]


def union(intervals):
    """Merged ``(start, end)`` of intervals (extra fields dropped)."""
    merged = []
    for s, e, *_ in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [tuple(m) for m in merged]


def length(intervals):
    return sum(e - s for s, e, *_ in intervals)


def busy_s(trace: Trace) -> float:
    """Seconds of the window in which some device operation ran."""
    return length(union(clip(trace.device, *trace.window)))


def intersect(a, b):
    """Length of the overlap of two unions of intervals."""
    a, b = union(a), union(b)
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_gaps(trace: Trace):
    """The window's idle gaps ``(start, end)``: the time between merged
    device intervals, and before the first and after the last."""
    lo, hi = trace.window
    gaps, t = [], lo
    for s, e in union(clip(trace.device, lo, hi)):
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    return gaps


def label_at(trace: Trace, t: float) -> str:
    """The innermost host range open at ``t`` (the latest to open of
    those that hold it), or ``"no host span"``."""
    best = None
    for s, e, name in trace.host:
        if s > t:
            break
        if e >= t and (best is None or s >= best[0]):
            best = (s, name)
    return best[1] if best else "no host span"


def gaps_by_label(trace: Trace, top=10):
    """Idle seconds by the host range open when each gap began, the largest
    first: ``[[label, seconds], ...]``."""
    totals = {}
    for s, e in idle_gaps(trace):
        name = label_at(trace, s)
        totals[name] = totals.get(name, 0.0) + (e - s)
    return [[k, v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])[:top]]


def device_seconds(trace: Trace, match=None):
    """Summed duration of the window's device operations whose name
    ``match`` accepts (all, without it)."""
    lo, hi = trace.window
    return sum(e - s for s, e, name in clip(trace.device, lo, hi)
               if match is None or match(name))


def top_ops(trace: Trace, top=10):
    """``[[name, seconds], ...]`` of the device operations that took most
    time, summed by name (names cut to 100 characters)."""
    totals = {}
    for s, e, name in clip(trace.device, *trace.window):
        totals[name[:100]] = totals.get(name[:100], 0.0) + (e - s)
    return [[k, v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])[:top]]


def by_class(trace: Trace):
    totals = {}
    for s, e, name in clip(trace.device, *trace.window):
        c = kernel_class(name)
        totals[c] = totals.get(c, 0.0) + (e - s)
    return dict(sorted(totals.items(), key=lambda kv: -kv[1]))
