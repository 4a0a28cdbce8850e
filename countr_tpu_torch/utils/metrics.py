"""Counting metrics and structured logging of the CLIs (counterpart of
``CountingMetrics``, ``JsonlLogger``, ``TBWriter`` and ``measure_time`` in
``countr_tpu/utils/metrics.py``; reference: util/misc.py:545-562,
FSC_pretrain.py:174-178, :334-338, FSC_test_cross(few-shot).py:361-365,
:429-434).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional


class JsonlLogger:
    """Append JSON lines to <output_dir>/log.txt
    (reference: FSC_pretrain.py:334-338)."""

    def __init__(self, output_dir: Optional[str], enabled: bool = True):
        self.path = os.path.join(output_dir, "log.txt") if output_dir else None
        self.enabled = enabled and self.path is not None
        if self.enabled:
            os.makedirs(output_dir, exist_ok=True)

    def write(self, record: Dict):
        if not self.enabled:
            return
        with open(self.path, "a", encoding="utf-8") as f:
            f.write(json.dumps(record) + "\n")


class TBWriter:
    """Optional TensorBoard sink (reference: FSC_pretrain.py:174-178): a
    no-op where ``log_dir`` is None or no SummaryWriter imports."""

    def __init__(self, log_dir: Optional[str]):
        self._w = None
        if log_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                return
            self._w = SummaryWriter(log_dir=log_dir)

    @property
    def enabled(self) -> bool:
        return self._w is not None

    def scalar(self, tag: str, value: float, step: int):
        if self._w is not None:
            self._w.add_scalar(tag, value, step)

    def image(self, tag: str, img_hwc, step: int):
        if self._w is not None:
            self._w.add_image(tag, img_hwc, step, dataformats="HWC")

    def flush(self):
        if self._w is not None:
            self._w.flush()


class CountingMetrics:
    """MAE/RMSE/NAE accumulator over per-image count errors
    (reference: FSC_test_cross(few-shot).py:361-365, :429-434)."""

    def __init__(self):
        self.abs_errs: List[float] = []
        self.naes: List[float] = []

    def update(self, pred: float, gt: float):
        err = abs(pred - gt)
        self.abs_errs.append(err)
        self.naes.append(err / gt if gt > 0 else 0.0)

    @property
    def mae(self) -> float:
        return sum(self.abs_errs) / max(len(self.abs_errs), 1)

    @property
    def rmse(self) -> float:
        n = max(len(self.abs_errs), 1)
        return (sum(e * e for e in self.abs_errs) / n) ** 0.5

    @property
    def nae(self) -> float:
        return sum(self.naes) / max(len(self.naes), 1)

    def summary(self) -> Dict[str, float]:
        return {"MAE": self.mae, "RMSE": self.rmse, "NAE": self.nae}


class measure_time:
    """Wall-clock context manager (reference: util/misc.py:545-562)."""

    def __enter__(self):
        self._t0 = time.perf_counter()
        self.duration = 0.0
        return self

    def __exit__(self, *exc):
        self.duration = time.perf_counter() - self._t0
        return False
