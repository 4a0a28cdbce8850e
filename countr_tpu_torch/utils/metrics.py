"""Counting metrics and structured logging of the CLIs (counterpart of
``countr_tpu/utils/metrics.py``: ``SmoothedValue``, ``MetricLogger``,
``JsonlLogger``, ``TBWriter``, ``WandbWriter``, ``CountingMetrics`` and
``measure_time``; reference: util/misc.py:33-176, :331-335, :545-562,
FSC_pretrain.py:174-178, :334-338, FSC_finetune_cross.py:185-195,
FSC_test_cross(few-shot).py:361-365, :429-434).

The TensorBoard and W&B sinks are optional: each is a no-op where its
client does not import (or, for W&B, where no project is given).
"""

from __future__ import annotations

import collections
import json
import os
import time
from typing import Dict, Iterable, List, Optional


class SmoothedValue:
    """Windowed and global average of a scalar stream
    (reference: util/misc.py:33-100)."""

    def __init__(self, window: int = 20):
        self.deque = collections.deque(maxlen=window)
        self.total = 0.0
        self.count = 0

    def update(self, value: float, n: int = 1):
        self.deque.append(value)
        self.total += value * n
        self.count += n

    @property
    def avg(self) -> float:
        return sum(self.deque) / max(len(self.deque), 1)

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)


class MetricLogger:
    """Stream metrics to stdout at a cadence, with iteration timing
    (reference: util/misc.py:103-176)."""

    def __init__(self, delimiter: str = "  "):
        self.meters: Dict[str, SmoothedValue] = collections.defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __str__(self) -> str:
        return self.delimiter.join(
            f"{k}: {m.avg:.4f} ({m.global_avg:.4f})" for k, m in self.meters.items()
        )

    def log_every(self, iterable: Iterable, print_freq: int, header: str = ""):
        start = time.time()
        iter_t = SmoothedValue()
        last = time.time()
        for i, obj in enumerate(iterable):
            yield obj
            iter_t.update(time.time() - last)
            last = time.time()
            if i % print_freq == 0:
                print(f"{header} [{i}]  {self}  iter_time: {iter_t.avg:.4f}s", flush=True)
        total = time.time() - start
        print(f"{header} done in {total:.1f}s", flush=True)


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


def _no_tensorflow() -> None:
    """Make tensorboard take its TensorFlow stub (its own ``no_tensorflow``
    switch: the ``tensorboard.compat.notf`` module) unless TensorFlow is
    already imported. Otherwise importing torch's SummaryWriter imports
    TensorFlow where it is installed, seconds in every process that logs;
    the event files are the same."""
    import sys
    import types

    if "tensorflow" not in sys.modules:
        sys.modules.setdefault("tensorboard.compat.notf",
                               types.ModuleType("tensorboard.compat.notf"))


class TBWriter:
    """Optional TensorBoard sink (reference: FSC_pretrain.py:174-178): a
    no-op where ``log_dir`` is None or neither torch's SummaryWriter nor
    tensorboardX's can be made."""

    def __init__(self, log_dir: Optional[str]):
        self._w = None
        if log_dir:
            try:
                _no_tensorflow()
                from torch.utils.tensorboard import SummaryWriter

                self._w = SummaryWriter(log_dir=log_dir)
            except Exception:
                try:
                    from tensorboardX import SummaryWriter

                    self._w = SummaryWriter(log_dir=log_dir)
                except Exception:
                    self._w = None

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


def read_tb_events(log_dir: str) -> List[tuple]:
    """Every scalar and image in the event files of a TensorBoard
    directory (``TBWriter``'s), in the order written: (tag, step, value),
    a float for a scalar, the decoded [H, W, C] uint8 array for an image.
    Reads the TFRecord framing itself (the CRCs unchecked) and parses each
    record with tensorboard's ``Event`` message."""
    import glob
    import io
    import struct

    import numpy as np
    from PIL import Image
    from tensorboard.compat.proto import event_pb2

    out = []
    for path in sorted(glob.glob(os.path.join(log_dir, "events.out.tfevents.*"))):
        with open(path, "rb") as f:
            data = f.read()
        pos = 0
        while pos + 12 <= len(data):
            (n,) = struct.unpack_from("<Q", data, pos)
            event = event_pb2.Event.FromString(data[pos + 12:pos + 12 + n])
            pos += 12 + n + 4
            for v in event.summary.value:
                if v.HasField("image"):
                    img = Image.open(io.BytesIO(v.image.encoded_image_string))
                    out.append((v.tag, event.step, np.asarray(img)))
                elif v.HasField("simple_value"):
                    out.append((v.tag, event.step, float(v.simple_value)))
    return out


class WandbWriter:
    """Optional Weights & Biases sink (reference: FSC_finetune_cross.py:
    185-195, :320-326, util/misc.py:331-335): a no-op where no project is
    given or the wandb client cannot start. ``run_name``, ``team`` and
    ``run_id`` are the reference's --title, --team and --wandb_id
    (FSC_finetune_cross.py:92-101); a ``run_id`` resumes that run."""

    def __init__(self, project: Optional[str] = None, run_name: Optional[str] = None,
                 config: Optional[Dict] = None, team: Optional[str] = None,
                 run_id: Optional[str] = None):
        self._run = None
        if not project:
            return
        try:
            import wandb

            self._run = wandb.init(
                project=project, name=run_name, config=config,
                entity=team or None, id=run_id or None,
                resume="allow" if run_id else None,
            )
        except Exception:
            self._run = None

    @property
    def enabled(self) -> bool:
        return self._run is not None

    def log(self, record: Dict, step: Optional[int] = None):
        if self._run is not None:
            self._run.log(record, step=step)

    def image(self, tag: str, img_hwc, step: Optional[int] = None):
        """An image panel (reference: FSC_finetune_cross.py:352-405)."""
        if self._run is None:
            return
        try:
            import wandb

            self._run.log({tag: wandb.Image(img_hwc)}, step=step)
        except Exception:
            pass

    def log_artifact(self, path: str, name: str, kind: str = "model"):
        """Upload a checkpoint directory or file as an artifact
        (reference: util/misc.py:331-335)."""
        if self._run is None:
            return
        try:
            import wandb

            art = wandb.Artifact(name, type=kind)
            if os.path.isdir(path):
                art.add_dir(path)
            else:
                art.add_file(path)
            self._run.log_artifact(art)
        except Exception:
            pass

    def finish(self):
        if self._run is not None:
            self._run.finish()


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
