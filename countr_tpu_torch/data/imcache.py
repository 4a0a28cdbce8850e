"""Bounded in-memory cache of decoded, resized images (counterpart of
``countr_tpu/data/imcache.py``).

JPEG decode and the antialiased resize are deterministic per image; only
the augmentation after them is random. So epochs after the first skip
both. Entries are the uint8 resize output (``pil_resize_u8``), a quarter
of the bytes of float32, and /255 gives the float pipeline's values.

FIFO-bounded (default 2 GiB; ``COUNTR_TORCH_IMAGE_CACHE_MB`` overrides,
0 disables). A process-pool worker receives the cap only, not the
contents.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Optional, Tuple

DEFAULT_MB = 2048


def _nbytes(value: Tuple) -> int:
    return sum(v.nbytes for v in value if hasattr(v, "nbytes"))


class ImageCache:
    def __init__(self, cap_mb: Optional[float] = None):
        if cap_mb is None:
            cap_mb = float(os.environ.get("COUNTR_TORCH_IMAGE_CACHE_MB", DEFAULT_MB))
        self.cap_bytes = int(cap_mb * 2 ** 20)
        self._lock = threading.Lock()
        self._data: "OrderedDict[object, Tuple]" = OrderedDict()
        self._bytes = 0

    def get(self, key) -> Optional[Tuple]:
        with self._lock:
            return self._data.get(key)

    def put(self, key, value: Tuple) -> None:
        size = _nbytes(value)
        if self.cap_bytes <= 0 or size > self.cap_bytes:
            return
        with self._lock:
            if key in self._data:
                return
            while self._bytes + size > self.cap_bytes and self._data:
                _, old = self._data.popitem(last=False)
                self._bytes -= _nbytes(old)
            self._data[key] = value
            self._bytes += size

    def __len__(self) -> int:
        return len(self._data)

    # a process-pool worker starts with an empty cache, not a 2 GiB pickle
    def __getstate__(self):
        return {"cap_bytes": self.cap_bytes}

    def __setstate__(self, state):
        self.cap_bytes = state["cap_bytes"]
        self._lock = threading.Lock()
        self._data = OrderedDict()
        self._bytes = 0
