"""The device's idle time under the program's own spans in a traced run.

While a profiler runs, the program records its spans
(``countr_tpu_torch.utils.profiling span``: name, start, end, thread) in
Unix-epoch nanoseconds, the clock of the profiler's events. A traced
run's summary (``lib/trace.py``) holds the device's intervals and the
benchmark's own spans on the summary's clock: Unix-epoch seconds, or,
where the torch build's events lack ``activity_type`` (torch 2.11) and
the summary is read from ``prof.events()``, seconds since the trace
started, a start the summary does not keep. So the program's spans are
put on the summary's clock by an anchor: a benchmark span around each
call into the program (``count_batch``, ``loader_next``) and the
program's span inside it (``count.batch``, ``data.next``); the offset is
the one that nests every anchor span of the program in its benchmark
span, the k-th in the k-th.

In some traced runs the trace's device times drift from its host times
(torch 2.11 on the H100: after a flat start the device's clock runs
0.05–4% fast, the same over a stretch, so the device seems to work up to
~130 ms after the host's read-back of that work returned). Where the
anchor's program span ends only after the device finished the call's
work (``count.batch`` ends after ``_collect_set``'s read-back), the
device's idle gap that follows each call pins the device's times to the
host's there (``retime``), and the device's intervals are put on the
host's times, linearly between the pins. A stretch without such pins
(pretrain-resident's host runs ahead of the device) keeps the trace's
times.

``idle_by_span`` then recomputes the stretch's idle gaps and splits each
gap by overlap among the program spans open on the thread that drove the
window: each part of a gap goes to the innermost span open then (the one
opened last), and a part under none to the remainder. A program without
spans (a checkout before them) gives None.
"""

from __future__ import annotations

import bisect
import heapq
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from benchmark.lib.trace import idle_gaps

Span = Tuple[str, float, float]  # name, start_s, end_s
# (the benchmark's span, the program's inside it, whether the program's ends
# after the device finished what the call launched)
Anchor = Tuple[str, str, bool]
COUNT_ANCHOR: Anchor = ("count_batch", "count.batch", True)
TRAIN_ANCHOR: Anchor = ("loader_next", "data.next", False)
SLACK_S = 50e-6  # how far the stamps of two nested spans may seem to cross
MAX_SHIFT = 2  # pairings of the anchor's spans tried either side of the k-th with the k-th
MIN_GAP_S = 0.002  # the least device gap that follows a call (a call plans for ~10 ms)
REACH_S = 0.005  # how far a call's gap may lie from where the drift so far puts it


def program_spans() -> Optional[List[Span]]:
    """The spans the program recorded on the caller's thread (a cell's
    window runs on the thread that calls the readers), in Unix-epoch
    seconds; None where the program records none."""
    try:
        from countr_tpu_torch.utils import profiling
    except ImportError:
        return None
    log = getattr(profiling, "span_log", None)
    if log is None:
        return None
    thread = threading.get_ident()
    return [(r.name, r.start_ns / 1e9, r.end_ns / 1e9) for r in log() if r.thread == thread]


def clock_offset(outer: Sequence[Span], inner: Sequence[Span]):
    """Seconds to take from ``inner``'s times to put them on ``outer``'s
    clock, where the k-th span of ``inner`` lies inside the k-th of
    ``outer`` (a shift of the pairing by up to ``MAX_SHIFT`` is tried, the
    most pairs winning); None where no pairing nests."""
    outer, inner = sorted(outer, key=lambda sp: sp[1]), sorted(inner, key=lambda sp: sp[1])
    best = None
    for shift in sorted(range(-MAX_SHIFT, MAX_SHIFT + 1), key=abs):
        pairs = [(outer[k], inner[k + shift]) for k in range(len(outer))
                 if 0 <= k + shift < len(inner)]
        if not pairs:
            continue
        lo = max(p[2] - o[2] for o, p in pairs)  # inner ends before outer
        hi = min(p[1] - o[1] for o, p in pairs)  # inner starts after outer
        if lo <= hi + SLACK_S and (best is None or len(pairs) > best[0]):
            best = (len(pairs), (lo + hi) / 2)
    return None if best is None else best[1]


def on_trace_clock(outer: Sequence[Span], spans: Sequence[Span], anchor: Anchor):
    """``spans`` (Unix-epoch seconds) on the clock of the benchmark's spans
    ``outer``, by ``anchor`` (benchmark span name, program span name);
    None where the anchor does not pair."""
    outer = [sp for sp in outer if sp[0] == anchor[0]]
    inner = [sp for sp in spans if sp[0] == anchor[1]]
    d = clock_offset(outer, inner) if outer and inner else None
    if d is None:
        return None
    return [(n, s - d, e - d) for n, s, e in spans]


def retime(busy: Sequence[Tuple[float, float]], spans: Sequence[Span],
           anchor: Anchor) -> List[Tuple[float, float]]:
    """The device intervals ``busy`` (sorted) on the host's times of
    ``spans``. Each span of a synced ``anchor`` ends just after the device
    finished its call's work, so a device gap of at least ``MIN_GAP_S``
    starts there: the one nearest to where the drift so far (its value and
    rate at the last pin) puts it, within ``REACH_S``, pins the drift at
    that end. The first pin is taken as no drift (the traces drift from 0 after
    a flat start), which also takes out the host's return after its
    read-back. Between pins the drift is linear, outside them constant;
    without a pin, ``busy`` is returned as it is."""
    ends = sorted(e for n, _, e in spans if n == anchor[1])
    if not anchor[2] or not ends or not busy:
        return list(busy)
    gaps = [s for s, e in idle_gaps(busy, busy[0][0], busy[-1][1] + 1.0) if e - s >= MIN_GAP_S]
    pins: List[Tuple[float, float]] = []  # (host time, device time)
    for h in ends:
        drift = pins[-1][1] - pins[-1][0] if pins else 0.0
        if len(pins) > 1:
            (h0, d0), (h1, d1) = pins[-2:]
            drift += ((d1 - h1) - (d0 - h0)) / (h1 - h0) * (h - h1)
        want = h + drift
        near = gaps[bisect.bisect_left(gaps, want - REACH_S):
                    bisect.bisect_right(gaps, want + REACH_S)]
        if near:
            pins.append((h, min(near, key=lambda g: abs(g - want))))
    if not pins:
        return list(busy)
    at = np.array([d for _, d in pins])
    drift = at - np.array([h for h, _ in pins])
    drift -= drift[0]  # the first pin: no drift yet, the host's return after the read-back
    out = np.array(busy, dtype=float)
    return [(float(s), float(e)) for s, e in out - np.interp(out, at, drift)]


def innermost(spans: Sequence[Span]) -> List[Span]:
    """Disjoint pieces (name, start, end), in time order, of the time the
    spans cover, each under the span opened last among those open then
    (on one thread's nested spans, the innermost)."""
    order = sorted(spans, key=lambda sp: sp[1])
    bounds = sorted({t for _, s, e in spans for t in (s, e)})
    heap: list = []  # (-start, length, k): the last opened on top
    out: List[Span] = []
    p = 0
    for a, b in zip(bounds, bounds[1:]):
        while p < len(order) and order[p][1] <= a:
            name, s, e = order[p]
            heapq.heappush(heap, (-s, e - s, p))
            p += 1
        while heap and order[heap[0][2]][2] <= a:
            heapq.heappop(heap)
        if not heap:
            continue
        name = order[heap[0][2]][0]
        if out and out[-1][0] == name and out[-1][2] == a:
            out[-1] = (name, out[-1][1], b)
        else:
            out.append((name, a, b))
    return out


def idle_by_span(layer: dict, anchor: Anchor, spans: Optional[Sequence[Span]] = None):
    """(idle seconds by span name, idle seconds under no span) of the
    traced stretch of ``layer["trace"]``, or None where it holds no trace,
    the anchor does not pair or no program span lies in the stretch. The
    stretch starts at its first device interval (``retime``d) or
    benchmark span and lasts ``window_s``. ``spans`` (on the summary's
    host times) defaults to ``program_spans()`` put there by
    ``anchor``."""
    tr = layer.get("trace")
    if not tr or tr.get("window_s", 0) <= 0:
        return None
    busy = [(s, e) for _, s, e in tr.get("device", ())]
    bench = [s for _, s, _ in tr.get("spans", ())]
    if not busy and not bench:
        return None
    lo = min(s for s, _ in busy + [(b, b) for b in bench])
    if spans is None:
        # the benchmark's spans in the stretch: torch 2.11's summary also
        # holds Unix-epoch copies of the host events before the trace's
        # first device event
        outer = [sp for sp in tr.get("spans", ()) if sp[2] > lo and sp[1] < lo + tr["window_s"]]
        spans = program_spans()
        spans = on_trace_clock(outer, spans, anchor) if spans else None
    if not spans:
        return None
    busy = retime(sorted(busy), spans, anchor)
    lo = min([s for s, _ in busy] + bench)
    hi = lo + tr["window_s"]
    inside = [(n, max(s, lo), min(e, hi)) for n, s, e in spans if e > lo and s < hi]
    if not inside:
        return None
    pieces = innermost(inside)
    by_name: Dict[str, float] = {}
    outside, k = 0.0, 0
    for gs, ge in idle_gaps(busy, lo, hi):
        while k < len(pieces) and pieces[k][2] <= gs:
            k += 1
        covered, j = 0.0, k
        while j < len(pieces) and pieces[j][1] < ge:
            name, a, b = pieces[j]
            part = min(b, ge) - max(a, gs)
            if part > 0:
                by_name[name] = by_name.get(name, 0.0) + part
                covered += part
            j += 1
        outside += (ge - gs) - covered
    return by_name, outside


def idle_share_under(layer: dict, anchor: Anchor, names: Sequence[str] = (),
                     prefixes: Sequence[str] = (), spans: Optional[Sequence[Span]] = None):
    """Per cent of the traced stretch's ``window_s`` in which the device
    was idle under a span named in ``names`` or starting with one of
    ``prefixes`` (the innermost open); None as ``idle_by_span``."""
    got = idle_by_span(layer, anchor, spans)
    if got is None:
        return None
    by_name, _ = got
    secs = sum(v for n, v in by_name.items() if n in names or n.startswith(tuple(prefixes)))
    return 100.0 * secs / layer["trace"]["window_s"]
