"""Spans and counters of the port: where the host's time goes.

A span is one timed stretch of one thread's work, opened as a context
manager::

    with tracing.span("engine/pad", frames=5):
        ...

It records its name, its start and end in nanoseconds on :func:`now`'s clock
(``time.perf_counter_ns``, the clock of ``time.perf_counter``), the thread
that ran it, the id of the span open on the same thread when it began (its
parent) and its attributes. Spans are recorded while the recorder is
:func:`enable`\\ d, and while a ``torch.profiler`` session runs: the profiler
records no ``record_function`` range of a thread started before it (the
serving engine's worker), so a profiled program keeps its spans here, to be
mapped onto the profiler's clock by whoever reads the trace. Under a
profiler a span also opens a ``torch.profiler.record_function`` range of its
name, which the profiler sees on its own thread, and which lands on the
device's timeline as an annotation; the span holds its range. Without a
profiler no range is opened: it would cost some 10 us a span and reach no
one.

Otherwise :func:`span` reads two module-level flags and returns one shared
no-op context: it records nothing, calls no ``record_function`` and
allocates nothing. The records stay in memory, at most ``MAX_SPANS`` of
them; past that the recorder drops and counts (:func:`dropped`).

The port's counters are :class:`LaunchCount`\\ s (each kernel's launches,
``ops.<module>.K?_LAUNCHES`` and ``ops.bn_relu.BN_RELU_LAUNCHES``; every
fold the model's eval-operand cache makes, in any form,
``ops.bn_relu.BN_FOLDS``) and
``serving.InferenceEngine.stats()``.

The spans the port records (``README.md`` says what each covers):
``engine/take``, ``engine/batch`` and inside it ``engine/group``,
``engine/pad``, ``engine/h2d``, ``model/forward``, ``engine/device_wait``,
``engine/d2h`` and ``engine/deliver``; ``engine/request`` (one record a
request, on the submitting thread); the model's stages under
``model/forward``; the train step's ``train_step/*`` phases.
"""

from __future__ import annotations

import itertools
import threading
import time

from torch.autograd import profiler as _profiler

MAX_SPANS = 1_000_000

now = time.perf_counter_ns

_on = False
_lock = threading.Lock()
_records: list = []
_dropped = 0
_ids = itertools.count(1)
_local = threading.local()


class LaunchCount:
    """How many times a kernel was launched: a plain integer, behind a lock
    because the serving worker thread and its caller may both launch."""

    def __init__(self):
        self._lock = threading.Lock()
        self.value = 0

    def add(self) -> None:
        with self._lock:
            self.value += 1

    def reset(self) -> None:
        with self._lock:
            self.value = 0


class _NoSpan:
    """The context :func:`span` returns while nothing is recorded."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        """Attributes known only once the span is open; dropped here."""


NOOP = _NoSpan()


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def _keep(record) -> None:
    global _dropped
    with _lock:
        if len(_records) < MAX_SPANS:
            _records.append(record)
        else:
            _dropped += 1


class Span:
    """One recorded span; times in ns on :func:`now`'s clock."""

    __slots__ = ("name", "start", "end", "tid", "id", "parent", "attrs", "_range")

    def __init__(self, name, attrs, start=0, end=0, tid=None):
        self.name, self.attrs = name, attrs
        self.start, self.end, self.tid, self.parent = start, end, tid, None
        self.id = next(_ids)
        self._range = None

    def __repr__(self):
        return (f"Span({self.name!r}, start={self.start}, end={self.end}, tid={self.tid}, "
                f"id={self.id}, parent={self.parent}, attrs={self.attrs!r})")

    def set(self, **attrs) -> None:
        """Attributes known only once the span is open."""
        self.attrs.update(attrs)

    def __enter__(self):
        stack = _stack()
        self.tid = threading.get_ident()
        self.parent = stack[-1] if stack else None
        stack.append(self.id)
        self.start = now()
        if _profiler._is_profiler_enabled:
            self._range = _profiler.record_function(self.name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc):
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        self.end = now()
        _stack().pop()
        _keep(self)
        return False


def span(name: str, **attrs):
    """A context manager that records ``name`` over its body while
    :func:`enabled`; else the shared no-op :data:`NOOP`."""
    if _on or _profiler._is_profiler_enabled:
        return Span(name, attrs)
    return NOOP


def no_span(name: str, **attrs):
    """:func:`span`'s signature, recording nothing: for code that records
    its spans in some callers only."""
    return NOOP


def record(name: str, start: int, end: int, *, tid=None, **attrs) -> None:
    """Record a span whose times were taken apart (``engine/request``:
    submitted on one thread, delivered on another), with no parent. Nothing
    is recorded unless :func:`enabled`."""
    if enabled():
        _keep(Span(name, attrs, start, end, tid))


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    """Stop recording; the records stay until :func:`clear`."""
    global _on
    _on = False


def enabled() -> bool:
    """Whether :func:`span` records now: enabled, or under a profiler."""
    return _on or _profiler._is_profiler_enabled


def spans() -> list:
    """The spans recorded so far, in the order they closed."""
    with _lock:
        return list(_records)


def dropped() -> int:
    """Spans not kept because ``MAX_SPANS`` were held."""
    return _dropped


def clear() -> None:
    global _dropped
    with _lock:
        _records.clear()
        _dropped = 0
