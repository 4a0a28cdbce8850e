"""The device trace of a traced run, and what the readers take from it.

``Profile`` wraps a stretch of the measured window in ``torch.profiler``
(host and CUDA activities). Its summary holds every device interval
(kernels, copies, sets: name, start, end in seconds), the host spans
that the benchmark's own files opened (``span``: a
``record_function`` named ``bench.<name>``), the traced window's length
by the host's clock, the seconds in which some operation ran on the
device (the union of the intervals, so that two streams' overlapping
kernels count once), the device operations that took the most time and
the idle gaps by what the host was doing then."""

from __future__ import annotations

import time
from typing import Dict, List, Sequence, Tuple

SPAN_PREFIX = "bench."


def span(name: str):
    """A host span in the trace, read by the gap labels."""
    import torch

    return torch.profiler.record_function(SPAN_PREFIX + name)


def union_seconds(intervals: Sequence[Tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def merged(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def idle_gaps(busy: Sequence[Tuple[float, float]], lo: float, hi: float):
    """The gaps of [lo, hi) that no merged ``busy`` interval covers."""
    gaps, t = [], lo
    for s, e in merged(busy):
        if s > t:
            gaps.append((t, min(s, hi)))
        t = max(t, e)
    if t < hi:
        gaps.append((t, hi))
    return [(s, e) for s, e in gaps if e > s]


def label_gaps(gaps, spans: Sequence[Tuple[str, float, float]]) -> Dict[str, float]:
    """Idle seconds by the innermost host span covering each gap's middle
    ("host: outside the benchmark's spans" where none does)."""
    out: Dict[str, float] = {}
    for s, e in gaps:
        mid = (s + e) / 2
        best = None
        for name, a, b in spans:
            if a <= mid < b and (best is None or b - a < best[2] - best[1]):
                best = (name, a, b)
        key = best[0] if best else "outside the benchmark's spans"
        out[key] = out.get(key, 0.0) + (e - s)
    return out


def _raw_events(prof):
    """(name, is_device, start_s, end_s) of every event of the trace; the
    device's copies of the host's annotations (the spans) are left out:
    they are no operation on the device."""
    out = []
    try:
        events = prof.profiler.kineto_results.events()
        for ev in events:
            dev = "CPU" not in str(ev.device_type())
            if dev and "annotation" in str(ev.activity_type()):
                continue
            out.append((ev.name(), dev, ev.start_ns() * 1e-9, ev.end_ns() * 1e-9))
        return out
    except AttributeError:
        pass
    for ev in prof.events():
        dev = "CPU" not in str(ev.device_type)
        out.append((ev.name, dev, ev.time_range.start * 1e-6, ev.time_range.end * 1e-6))
    return out


class Profile:
    """``with Profile() as p: ...`` traces the enclosed work, which ends in
    a device synchronisation; ``p.summary`` then holds what the readers
    read, worked out at its first reading (after the window, so that the
    window does not pay for it)."""

    def __init__(self):
        self._summary = None
        self._prof = None

    @property
    def summary(self) -> Dict:
        if self._summary is None and self._prof is not None:
            self._summary = summarize(_raw_events(self._prof), self._window)
            self._prof = None
        return self._summary or {}

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():  # the CPU tests trace the host alone
            torch.cuda.synchronize()
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._window = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            self._prof = None
        return False


def summarize(events, window_s: float) -> Dict:
    device = [(n, s, e) for n, d, s, e in events
              if d and e > s and not n.startswith(SPAN_PREFIX)]
    spans = [(n[len(SPAN_PREFIX):], s, e) for n, d, s, e in events
             if not d and n.startswith(SPAN_PREFIX)]
    busy = union_seconds([(s, e) for _, s, e in device])
    by_name: Dict[str, float] = {}
    for n, s, e in device:
        by_name[n] = by_name.get(n, 0.0) + (e - s)
    if device:
        lo = min(s for _, s, _ in device)
        hi = lo + window_s
        host = [s for n, d, s, e in events if not d]
        if host:
            lo = min(lo, min(host))
            hi = max(max(e for _, _, e in device), lo + window_s)
    else:
        lo, hi = 0.0, window_s
    gaps = label_gaps(idle_gaps([(s, e) for _, s, e in device], lo, hi), spans)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    top_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {
        "window_s": window_s,
        "busy_s": min(busy, window_s),
        "device": device,
        "spans": spans,
        "breakdown": {"device_ops": [[n[:120], v] for n, v in top],
                      "idle_gaps": [[n[:120], v] for n, v in top_gaps]},
    }


def warm() -> None:
    """Start and stop the profiler once on a small device operation, so
    that the traced stretch does not pay for its first start."""
    import torch

    with Profile() as p:
        if torch.cuda.is_available():
            torch.ones(8, device="cuda").sum().item()
    p._prof = None


def kernel_seconds(summary: Dict, names: Sequence[str]) -> Tuple[float, int]:
    """Device seconds and intervals of the trace's operations whose name
    holds one of ``names``."""
    total, n = 0.0, 0
    for name, s, e in summary.get("device", ()):
        if any(k in name for k in names):
            total += e - s
            n += 1
    return total, n
