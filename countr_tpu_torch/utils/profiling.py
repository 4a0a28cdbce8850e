"""Tracing of a CLI's inference phase (counterpart of
``countr_tpu/utils/profiling.py trace``): ``torch.profiler`` in place of
``jax.profiler``, behind ``--profile_dir``."""

from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional

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
