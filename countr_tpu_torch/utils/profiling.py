"""Profiling and tracing (counterpart of ``countr_tpu/utils/profiling.py``):
``trace``, a CLI's ``--profile_dir`` trace through ``torch.profiler`` in
place of ``jax.profiler``; ``PhaseTimers``, wall-clock per named phase
(the reference's "Mean load time" fields, FSC_test_cross(few-shot).py:
429-434); ``span``, the program's named spans, and ``annotate``, its
JAX-named alias.

A span costs nothing while no profiler runs: ``span`` then returns one
shared no-op context, with no clock reading and no profiler range.
While a ``torch.profiler.profile`` runs (a ``--profile_dir`` trace, a
benchmark's traced stretch), each span opens a profiler range named
``countr.<name>``, so that it shows on the host's track of the exported
trace, above the device's, and appends a ``SpanRecord`` to a bounded log
in memory (``span_log``). Its times are Unix-epoch nanoseconds
(``time.time_ns``), the clock of the profiler's own events, host and
device alike, so a reader can put the device's idle gaps under the spans
that were open then.

The range is torch's fast record function (``_RecordFunctionFast``, an
operator range), not ``record_function``'s user annotation: the profiler
copies a user annotation onto the device's track wherever it holds a
kernel, and a reader of device intervals would take the copy for work
on the device."""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from typing import Dict, Iterator, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as autograd_profiler
from torch._C._profiler import _RecordFunctionFast

SPAN_PREFIX = "countr."
SPAN_LOG_CAP = 1 << 20  # records; later ones are counted as dropped


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """Trace the enclosed region (the host, and the CUDA device when
    there is one) into ``log_dir/trace.json`` (Chrome trace format, for
    Perfetto or chrome://tracing); no-op when ``log_dir`` is falsy."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class PhaseTimers:
    """Accumulate wall-clock per named phase."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] = self.totals.get(name, 0.0) + time.perf_counter() - t0
            self.counts[name] = self.counts.get(name, 0) + 1

    def means(self) -> Dict[str, float]:
        return {f"Mean {k} time": self.totals[k] / max(self.counts[k], 1) for k in self.totals}


class SpanRecord(NamedTuple):
    """One closed span: ``parent`` is the id of the span that enclosed it
    on its thread (None for a root), ``call`` the id of that thread's
    outermost open span (its own for a root), so the spans of one
    ``count_batch`` call or one training step share it."""

    id: int
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]
    call: int
    thread: int


class _SpanLog:
    """The records of the closed spans, at most ``cap``; a lock, since the
    loader's producer thread records too."""

    def __init__(self, cap: int):
        self.cap = cap
        self.records: List[SpanRecord] = []
        self.dropped = 0
        self.lock = threading.Lock()
        self.ids = itertools.count()
        self.stacks = threading.local()  # each thread's open spans

    def add(self, rec: SpanRecord) -> None:
        with self.lock:
            if len(self.records) < self.cap:
                self.records.append(rec)
            else:
                self.dropped += 1


_LOG = _SpanLog(SPAN_LOG_CAP)
_OFF = contextlib.nullcontext()


class _Span:
    """An open span, recorded at exit. Stamped just after its profiler
    range opens and just after it closes, where the stamps lie closest to
    the profiler's own (within a few us; a process's first span, within
    ~0.1 ms)."""

    __slots__ = ("name", "label", "id", "parent", "call", "start_ns", "_rf", "_stack")

    def __init__(self, name: str, label: str):
        self.name, self.label = name, label

    def __enter__(self):
        stack = getattr(_LOG.stacks, "open", None)
        if stack is None:
            stack = _LOG.stacks.open = []
        self.id = next(_LOG.ids)
        self.parent = stack[-1].id if stack else None
        self.call = stack[0].id if stack else self.id
        self._stack = stack
        stack.append(self)
        self._rf = _RecordFunctionFast(self.label)
        self._rf.__enter__()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        try:
            self._rf.__exit__(*exc)
        finally:
            end = time.time_ns()
            self._stack.pop()
            _LOG.add(SpanRecord(self.id, self.name, self.start_ns, end, self.parent, self.call,
                                threading.get_ident()))
        return False


def span(name: str):
    """``with span("count.plan_set"): ...``: a span of the program, named
    ``countr.<name>`` in a profiler's trace and recorded in ``span_log``
    while a profiler runs; otherwise a shared no-op (no clock reading, no
    profiler range)."""
    if not autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, SPAN_PREFIX + name)


def annotate(name: str):
    """``span`` under the name as given (the JAX package's
    ``jax.profiler.TraceAnnotation`` names its span so)."""
    if not autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, name)


def span_log() -> List[SpanRecord]:
    """The closed spans recorded since the last ``clear_span_log``, in
    the order they closed (a copy)."""
    with _LOG.lock:
        return list(_LOG.records)


def spans_dropped() -> int:
    """The spans not recorded since the last ``clear_span_log``: the log
    was full (``SPAN_LOG_CAP``)."""
    return _LOG.dropped


def clear_span_log() -> None:
    with _LOG.lock:
        _LOG.records.clear()
        _LOG.dropped = 0
