"""What every driver of the benchmark shares: the paths and cache
directories inside the checkout, the run's context, the statistics, the
device line, the check that neither JAX nor the JAX package was loaded,
and the load of a module of the benchmark by its file name.

Nothing here imports the program (``countr_tpu_torch``)."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
CACHE = BENCH / "cache"  # listed in benchmark/.gitignore

# top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "countr_tpu")


def set_cache_env() -> None:
    """Fixed cache directories inside the checkout, set before torch or
    Triton is imported: Triton's kernel cache, and torch's extension
    directory (the program builds its CUDA libraries into its own
    ``countr_tpu_torch/_build``). ``USE_FLAX=0`` keeps transformers, if
    anything imports it, from loading JAX."""
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ.setdefault("PYTHONHASHSEED", "0")
    for sub in ("triton", "torch_extensions"):
        (CACHE / sub).mkdir(parents=True, exist_ok=True)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def load_module(path: Path, name: Optional[str] = None):
    """Import the file ``path`` as a module (names may hold dots)."""
    name = name or "bench_" + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def forbidden_modules(modules=None) -> List[str]:
    """The loaded modules whose top-level name (before the first dot) is,
    whole, one of ``FORBIDDEN``: ``countr_tpu_torch`` is not
    ``countr_tpu``."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".", 1)[0] in FORBIDDEN})


def quantiles(values) -> tuple:
    """(q1, median, q3) as ``statistics.quantiles(values, n=4)`` gives them."""
    q1, q2, q3 = statistics.quantiles(list(values), n=4)
    return q1, q2, q3


def smi() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unread"
    except (OSError, subprocess.SubprocessError):
        return "unread"


@dataclasses.dataclass
class Check:
    """One number compared: ``ok`` when it is finite and at most ``limit``."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value is not None and math.isfinite(self.value) and self.value <= self.limit


@dataclasses.dataclass
class Context:
    """What a driver gets: the cell's names, the configuration and the
    traffic as their files hold them, and the run's arguments."""
    workload: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    t_start: float  # perf_counter at the process's start
    chips: int = 1
    device: str = "cuda"  # "cpu" in the CPU tests only

    def note(self, msg: str) -> None:
        print(f"[{self.workload['name']} +{time.perf_counter() - self.t_start:.1f}s] {msg}",
              file=sys.stderr, flush=True)


@dataclasses.dataclass
class Outcome:
    """What a driver returns. ``e2e``: the end-to-end metrics by name;
    ``layer``: what the per-layer readers read (spans, counters, the
    trace's summary, the work done); ``checks``: the numbers compared
    with their limits; ``faults``: reasons the run is not correct besides
    the checks (a request never answered, an exception)."""
    attempted: int
    failed: int
    e2e: Dict[str, float]
    memory_peak_bytes: int
    checks: List[Check]
    layer: Dict = dataclasses.field(default_factory=dict)
    faults: List[str] = dataclasses.field(default_factory=list)
    extra: Dict = dataclasses.field(default_factory=dict)


def seed_stream(seed: int, *salt: int):
    """A numpy Generator from the run's seed and a salt: the same seed
    gives the same stream, whatever its size (seeds past 2**32 too)."""
    import numpy as np

    return np.random.default_rng(np.random.SeedSequence([int(seed) % (1 << 63), *salt]))


def torch_seed(seed: int, *salt: int) -> int:
    """A 63-bit seed for a ``torch.Generator`` from the run's seed."""
    return int(seed_stream(seed, *salt).integers(0, 1 << 62))


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def reset_peak(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)


def peak_bytes(device) -> int:
    import torch

    return torch.cuda.max_memory_allocated(device) if torch.device(device).type == "cuda" else 0


def free(device) -> None:
    import gc

    import torch

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
