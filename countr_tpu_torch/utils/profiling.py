"""Profiling and tracing (counterpart of ``countr_tpu/utils/profiling.py``):
``trace``, a CLI's ``--profile_dir`` trace through ``torch.profiler`` in
place of ``jax.profiler``; ``PhaseTimers``, wall-clock per named phase
(the reference's "Mean load time" fields, FSC_test_cross(few-shot).py:
429-434); ``annotate``, a named span in the trace."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, Optional

import torch


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


def annotate(name: str):
    """A span named ``name`` in a ``torch.profiler`` trace (the JAX
    package's ``jax.profiler.TraceAnnotation``)."""
    return torch.profiler.record_function(name)
