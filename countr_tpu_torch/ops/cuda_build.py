"""Build a CUDA C++ source of ``countr_tpu_torch/csrc`` into a shared
library with a plain C interface and load it with ctypes; and the
checks and the call that the block kernels' wrappers share.

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

import torch

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


def activation(entry: str, name: str, x, ndim: int = 3):
    """Check that ``x`` is what the block kernels take as an activation:
    a contiguous, 16-byte aligned bf16 tensor of ``ndim`` dims on a CUDA
    device. Raises ValueError otherwise (no conversion: the kernels are
    bf16-only)."""
    if x.dtype != torch.bfloat16 or x.dim() != ndim or not x.is_contiguous():
        raise ValueError(f"{entry}: {name} must be a contiguous bf16 {ndim}-d tensor; "
                         f"got {x.dtype} {tuple(x.shape)}")
    if x.data_ptr() % 16:
        raise ValueError(f"{entry}: {name} must be 16-byte aligned")
    return x


def operand(entry: str, name: str, t, dtype, shape, device):
    """``t`` as the contiguous ``dtype`` tensor a kernel entry takes (a
    weight is cast, as the TPU kernels cast theirs at use), after checking
    its device and shape. Raises ValueError otherwise."""
    if t.device != device or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{entry}: {name} must be {tuple(shape)} on {device}; "
                         f"got {tuple(t.shape)} on {t.device}")
    t = t.to(dtype).contiguous()
    if t.data_ptr() % 16:
        raise ValueError(f"{entry}: {name} must be 16-byte aligned")
    return t


def launch(entry: str, fn, error_string, device, *args) -> None:
    """Call the C entry ``fn`` with ``args`` (tensors become their data
    pointers) and the current CUDA stream of ``device``; raise
    RuntimeError with the CUDA error when it returns nonzero."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*(a.data_ptr() if torch.is_tensor(a) else a for a in args), stream)
    if rc != 0:
        raise RuntimeError(f"{entry}: kernel launch failed: "
                           f"{error_string(rc).decode()} (code {rc})")
