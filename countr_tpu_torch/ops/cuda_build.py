"""Build a CUDA C++ source of ``countr_tpu_torch/csrc`` into a shared
library with a plain C interface and load it with ctypes.

The library is compiled at first use with ``nvcc`` for ``sm_90a`` into
``countr_tpu_torch/_build/`` (listed in .gitignore), named after the hash
of the source, the shared headers (``csrc/*.cuh``) and the flags, so an
edited source is rebuilt and an unchanged one is loaded as it is. Each
build writes to a temporary name and is renamed into place, so
concurrent processes never load a half written file. ``nvcc`` is
``$CUDA_HOME/bin/nvcc``, else the one on PATH, else
``/usr/local/cuda/bin/nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# name -> (CDLL, build record); one load per process.
_LOADED: dict = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build_library(name: str):
    """Compile (if needed) and load ``csrc/<name>.cu``. Returns
    ``(lib, record)``; record holds ``path``, ``seconds`` (0.0 when the
    library was already built) and ``log`` (nvcc's -Xptxas -v report)."""
    if name in _LOADED:
        return _LOADED[name]
    src = CSRC_DIR / f"{name}.cu"
    headers = b"".join(p.read_bytes() for p in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(
        src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"lib{name}_{digest}.so"
    log_path = out.with_suffix(".log")
    seconds = 0.0
    if not out.exists():
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            capture_output=True, text=True,
        )
        seconds = time.perf_counter() - t0
        log_path.write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to build {src.name} (rc {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)
    log = log_path.read_text() if log_path.exists() else ""
    record = {"path": str(out), "seconds": seconds, "log": log}
    _LOADED[name] = (ctypes.CDLL(str(out)), record)
    return _LOADED[name]


def build_libraries(names) -> dict:
    """``build_library`` for several sources at once: one nvcc each, all
    started together. Returns ``{name: (lib, record)}``."""
    with ThreadPoolExecutor(len(names)) as pool:
        return dict(zip(names, pool.map(build_library, names)))
