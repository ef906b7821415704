"""The program's own spans in a traced run, on the profiler's clock.

The program records spans (``dmmfods_tpu_torch.tracing``) on every thread
while a ``torch.profiler`` session runs, its serving engine's worker
included, whose ``record_function`` ranges the profiler does not see. Their
times are on ``time.perf_counter_ns``'s clock. :func:`of` maps them onto
the profiler's clock: every ``model/forward`` span lies inside the
benchmark's ``gpubench/engine.forward`` range of the same call (the wrapper
around ``engine.forward``), and the offset that puts the most of them
inside one is the clocks' offset, to within the few microseconds between
the wrapper's edges and the span's. That offset is only a first guess on
the device's timeline: in a stream cell the anchors are the benchmark's
host-clock times, mapped by an offset that a thread switch can put
milliseconds off, and within one trace the device's timestamps move
against ``time.perf_counter`` by up to some milliseconds a second, not
always at one rate (H100, torch 2.x). So :func:`of` then maps the spans
onto the device itself, where the trace has pageable device-to-host
copies: the host waits for such a copy, so each ends just before its
``engine/d2h`` span does (:func:`device_map`).

:func:`of` also lays the spans of the threads that ran device batches
(``engine/batch``), ``engine/request`` left out, into the trace's host
ranges, so that each idle gap of the device is labelled by the innermost
span the program had open when it began: by the metrics here, and by the
run's own breakdown of idle time, which reads the host ranges after the
metrics are read. The benchmark's ``gpubench/*`` ranges stay where those
spans do not reach, so what the program does not cover still shows under
their names.

A program without the recorder (a checkout before it) gives ``None``, and
the metrics that read its spans read nothing.
"""

from __future__ import annotations

import bisect
import collections
import importlib
import statistics

from gpubench import trace as tr

ANCHOR = "gpubench/engine.forward"
FORWARD = "model/forward"
BATCH = "engine/batch"
REQUEST = "engine/request"
# engine spans that are not host work on the batch: waiting for traffic,
# and waiting for the device
ENGINE_WAITS = ("engine/take", "engine/device_wait")

D2H = "engine/d2h"
PAIR = 0.04         # s: how far a copy may lie from its span under the first
                    # guess (under half a device batch)
OUTLIER = 0.003     # s: a copy's offset this far from its neighbours' is not used
AFTER = 1e-6        # s: the host leaves the engine/d2h span after its copy ends

# one span on the profiler's clock: seconds, as the trace's intervals
Mapped = collections.namedtuple("Mapped", "start end name tid id parent attrs")

_CACHE = "program_spans"   # the attribute of the run that holds of()'s answer


def recorded():
    """The program's recorded spans, or ``None`` where it has no recorder."""
    try:
        tracing = importlib.import_module("dmmfods_tpu_torch.tracing")
    except ImportError:
        return None
    return tracing.spans()


def clock_offset(spans, anchors):
    """Seconds to add to a span's time (ns / 1e9) to put it on the
    anchors' clock: the middle of the offsets that put the most
    ``model/forward`` spans inside some anchor ``(start, end, ...)``;
    ``None`` where no span fits in any anchor."""
    edges = []
    for s in spans:
        if s.name != FORWARD:
            continue
        ss, se = s.start * 1e-9, s.end * 1e-9
        for ws, we, *_ in anchors:
            if we - ws >= se - ss:
                # inside this anchor for every offset in [ws - ss, we - se]
                edges += [(ws - ss, 0), (we - se, 1)]
    edges.sort()                     # at one point, an opening before a closing
    depth = best = 0
    lo = hi = None
    for x, closing in edges:
        if not closing:
            depth += 1
            if depth > best:
                best, lo, hi = depth, x, None
        else:
            if depth == best and hi is None:
                hi = x
            depth -= 1
    return None if lo is None else (lo + hi) / 2


def device_map(spans, device, offset):
    """How to map a span's time (s) onto the device's timeline: knots ``[(t,
    offset), ...]`` sorted by ``t``, between which the offset is
    interpolated (:func:`shift`). A pageable device-to-host copy of
    ``device`` ``(start, end, name)`` blocks the host, so it ends just
    before its ``engine/d2h`` span: each such span, paired with the copy
    nearest it under the map so far (at first ``offset`` alone) within
    ``PAIR``, gives a knot at its end, the offset that ends it ``AFTER``
    the copy; a knot more than ``OUTLIER`` from the median of its four
    neighbours' is dropped. Pairs are made twice. ``[(0, offset)]`` where
    no copy pairs."""
    copies = [(s, e) for s, e, name in device if "DtoH" in name and "Pageable" in name]
    d2h = sorted((s.start * 1e-9, s.end * 1e-9) for s in spans if s.name == D2H)
    knots = [(0.0, offset)]
    for _ in range(2):
        pairs = []
        for ss, se in d2h:
            at = (ss + se) / 2 + shift(knots, (ss + se) / 2)
            near = min(copies, key=lambda c: abs((c[0] + c[1]) / 2 - at), default=None)
            if near is not None and abs((near[0] + near[1]) / 2 - at) < PAIR:
                pairs.append((se, near[1] + AFTER - se))
        kept = [(t, y) for i, (t, y) in enumerate(pairs)
                if len(pairs) < 3 or abs(y - statistics.median(
                    [v for _, v in pairs[max(0, i - 2):i] + pairs[i + 1:i + 3]])) < OUTLIER]
        if not kept:
            break
        knots = kept
    return knots


def shift(knots, t):
    """The offset at ``t`` of :func:`device_map`'s knots: interpolated
    between them, the nearest one's outside them."""
    i = bisect.bisect(knots, (t,))
    if i == 0:
        return knots[0][1]
    if i == len(knots):
        return knots[-1][1]
    (t0, y0), (t1, y1) = knots[i - 1], knots[i]
    return y0 + (y1 - y0) * (t - t0) / (t1 - t0)


def map_spans(spans, knots, window):
    """The spans that overlap ``window`` (profiler clock), mapped onto it by
    :func:`device_map`'s ``knots``."""
    lo, hi = window
    out = []
    for s in spans:
        start, end = (t * 1e-9 + shift(knots, t * 1e-9) for t in (s.start, s.end))
        if end > lo and start < hi:
            out.append(Mapped(start, end, s.name, s.tid, s.id, s.parent, s.attrs))
    return sorted(out)


def labelling(spans):
    """The spans that may label an idle gap: those of the threads that ran
    device batches, ``engine/request`` left out."""
    threads = {s.tid for s in spans if s.name == BATCH}
    return [s for s in spans if s.tid in threads and s.name != REQUEST]


def outside(ranges, cover):
    """The parts of ``ranges`` ``(start, end, name)`` that the sorted,
    disjoint intervals ``cover`` leave free."""
    out = []
    for start, end, name in ranges:
        for lo, hi in cover:
            if hi <= start or lo >= end:
                continue
            if lo > start:
                out.append((start, lo, name))
            start = max(start, hi)
        if start < end:
            out.append((start, end, name))
    return out


def of(run):
    """The program's spans of the run's traced slice, mapped onto the
    profiler's clock and sorted by start, or ``None`` (no trace, no recorder,
    or no span). The first call also lays the labelling spans into
    ``run.trace.host``, in place of the parts of the benchmark's own ranges
    that they cover (those ranges are on the host's clock, some milliseconds
    off the device's: they would take labels from the program's spans);
    later calls give the same answer."""
    if hasattr(run, _CACHE):
        return getattr(run, _CACHE)
    mapped = None
    spans = recorded() if run.trace is not None else None
    if spans:
        offset = clock_offset(spans, [h for h in run.trace.host if h[2] == ANCHOR])
        if offset is not None:
            knots = device_map(spans, run.trace.device, offset)
            mapped = map_spans(spans, knots, run.trace.window) or None
    setattr(run, _CACHE, mapped)
    if mapped:
        labels = [(s.start, s.end, s.name) for s in labelling(mapped)]
        cover = tr.union([(start, end) for start, end, _ in labels])
        run.trace.host = sorted(outside(run.trace.host, cover) + labels)
    return mapped


def begun(spans, name, window):
    """The spans called ``name`` that began inside ``window``."""
    lo, hi = window
    return [s for s in spans if s.name == name and lo <= s.start < hi]


def self_s(span, children):
    """A span's duration less the part of it that its children cover."""
    inner = tr.union(tr.clip([(c.start, c.end) for c in children.get(span.id, ())],
                             span.start, span.end))
    return span.end - span.start - tr.length(inner)


def host_ms_per_batch(run, names):
    """The mean over the device batches that began and ended inside the
    traced slice of the summed self time of their child spans called one of
    ``names``, in ms; ``None`` without spans or such batches. (A batch open
    at the slice's close is stretched by the profiler's own processing,
    which holds the interpreter.)"""
    spans = of(run)
    if not spans:
        return None
    lo, hi = run.trace.window
    batches = [b for b in begun(spans, BATCH, run.trace.window) if b.end <= hi]
    if not batches:
        return None
    children = collections.defaultdict(list)
    for s in spans:
        children[s.parent].append(s)
    total = sum(self_s(c, children) for b in batches for c in children[b.id]
                if c.name in names)
    return total / len(batches) * 1e3


def idle_ms_per(run, accept, per):
    """Idle ms of the traced slice whose label ``accept`` takes, over the
    spans called ``per`` begun in the slice; ``None`` without spans."""
    spans = of(run)
    if not spans:
        return None
    count = len(begun(spans, per, run.trace.window))
    if not count:
        return None
    trace = run.trace
    idle = sum(e - s for s, e in tr.idle_gaps(trace) if accept(tr.label_at(trace, s)))
    return idle / count * 1e3


def engine_work(label):
    """An ``engine/*`` label of host work on a batch."""
    return label.startswith("engine/") and label not in ENGINE_WAITS
