"""ctypes binding of the native host core, ``native/src/host_ops.cpp``
(the port's own counterpart of ``countr_tpu/native.py``): the fused
per-sample augmentation ops of the training data path.

The library is compiled at first use with ``g++`` and the JAX package's
flags into ``countr_tpu_torch/_build/`` (listed in .gitignore), named after
the hash of the source, the flags and the host CPU's feature flags
(``-march=native``: a checkout copied to another host builds its own), so
an edited source is rebuilt. A build writes to a temporary name and is
renamed into place, so concurrent processes (test workers, the loader's
process pool) never load a half written file; within a process one lock
lets the loader's threads build and bind it once.

No silent fallback: where the JAX package returns None on a failed
build and its callers then take numpy paths that draw other random bits
(``gaussian_noise``: xoshiro here, ``rng.normal`` there), ``lib()``
raises with the compiler's output. The numpy paths, the JAX package's
deterministic spec, run only on request: ``COUNTR_TORCH_NATIVE=0`` in
the environment (read at every call, and inherited by worker processes).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

ABI_VERSION = 2  # ct_abi_version() of the source this binding was written for
ENV = "COUNTR_TORCH_NATIVE"
SOURCE = Path(__file__).resolve().parent.parent / "native" / "src" / "host_ops.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
FLAGS = ("-O3", "-march=native", "-ffast-math", "-shared", "-fPIC", "-std=c++17")

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def enabled() -> bool:
    """Whether the transforms take the native ops (the default) or, with
    ``COUNTR_TORCH_NATIVE=0``, their numpy versions."""
    return os.environ.get(ENV, "1") != "0"


def _cpu_flags() -> bytes:
    """The host CPU's feature flags (what -march=native compiles for)."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return line.encode()
    except OSError:
        pass
    return platform.processor().encode() + platform.machine().encode()


def _build() -> Path:
    """Compile the source (if this source, these flags and this CPU have
    no library yet); returns the library's path. Raises RuntimeError with
    g++'s output when the build fails."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(FLAGS).encode()
                            + _cpu_flags()).hexdigest()[:16]
    out = BUILD_DIR / f"libcountr_host_{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".tmp", prefix=out.name + ".", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *FLAGS, str(SOURCE), "-o", tmp],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build {SOURCE} (rc {proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _bind(so: ctypes.CDLL) -> ctypes.CDLL:
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    so.ct_abi_version.argtypes = []
    so.ct_abi_version.restype = ctypes.c_int
    so.ct_noise_clip.argtypes = [f32p, ctypes.c_int64, ctypes.c_float, ctypes.c_uint64]
    so.ct_noise_clip.restype = None
    so.ct_blend_scalar.argtypes = [f32p, ctypes.c_int64, ctypes.c_float, ctypes.c_float]
    so.ct_blend_scalar.restype = None
    so.ct_gray_mean.argtypes = [f32p, ctypes.c_int64]
    so.ct_gray_mean.restype = ctypes.c_float
    so.ct_blend_gray.argtypes = [f32p, ctypes.c_int64, ctypes.c_float]
    so.ct_blend_gray.restype = None
    so.ct_density_splat.argtypes = [
        f32p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_float, f32p,
    ]
    so.ct_density_splat.restype = None
    so.ct_splat_weighted.argtypes = [
        i32p, i32p, f32p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_float, f32p,
    ]
    so.ct_splat_weighted.restype = None
    return so


def lib() -> ctypes.CDLL:
    """The bound library, built at the first call of the process. Raises
    when it cannot be built or its ABI version is not ``ABI_VERSION``."""
    global _lib
    with _lock:
        if _lib is None:
            so = ctypes.CDLL(str(_build()))
            so.ct_abi_version.restype = ctypes.c_int
            version = so.ct_abi_version()
            if version != ABI_VERSION:
                raise RuntimeError(f"{SOURCE} has ABI version {version}; this binding "
                                   f"was written for {ABI_VERSION}")
            _lib = _bind(so)
        return _lib


def _f32(a: np.ndarray, what: str) -> np.ndarray:
    if a.dtype != np.float32 or not a.flags.c_contiguous or not a.flags.writeable:
        raise ValueError(f"{what} needs a writeable, contiguous float32 array; "
                         f"got {a.dtype}, contiguous {a.flags.c_contiguous}")
    return a


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


# -- typed wrappers (in place on contiguous float32 HWC images) -------------


def noise_clip(img: np.ndarray, std: float, seed: int) -> None:
    """img = clip(img + N(0, std)), the noise from xoshiro256++ seeded with
    ``seed``."""
    _f32(img, "noise_clip")
    lib().ct_noise_clip(_ptr(img), img.size, std, seed & (2 ** 64 - 1))


def blend_scalar(img: np.ndarray, other: float, factor: float) -> None:
    """img = clip(factor * img + (1 - factor) * other)."""
    _f32(img, "blend_scalar")
    lib().ct_blend_scalar(_ptr(img), img.size, other, factor)


def gray_mean(img: np.ndarray) -> float:
    """The mean Rec.601 luma of an HWC image."""
    _f32(img, "gray_mean")
    return lib().ct_gray_mean(_ptr(img), img.size // 3)


def blend_gray(img: np.ndarray, factor: float) -> None:
    """Each pixel blended with its own luma (saturation)."""
    _f32(img, "blend_gray")
    lib().ct_blend_gray(_ptr(img), img.size // 3, factor)


def splat_weighted(
    ys: np.ndarray, xs: np.ndarray, vals: np.ndarray, h: int, w: int,
    sigma: float, radius: Optional[int], scale: float,
) -> np.ndarray:
    """gaussian_filter (reflect) of the [h, w] map whose nonzeros are
    ``vals`` at (``ys``, ``xs``), times ``scale``."""
    out = np.empty((h, w), np.float32)
    ys = np.ascontiguousarray(ys, np.int32)
    xs = np.ascontiguousarray(xs, np.int32)
    vals = np.ascontiguousarray(vals, np.float32)
    if not ys.shape == xs.shape == vals.shape or ys.ndim != 1:
        raise ValueError(f"splat_weighted: ys, xs and vals must be 1-d of one length; "
                         f"got {ys.shape}, {xs.shape}, {vals.shape}")
    if ys.size and (ys.min() < 0 or ys.max() >= h or xs.min() < 0 or xs.max() >= w):
        raise ValueError(f"splat_weighted: a coordinate lies outside [{h}, {w}]")
    lib().ct_splat_weighted(
        ys.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        xs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        _ptr(vals), ys.shape[0], h, w, sigma,
        -1 if radius is None else int(radius), scale, _ptr(out),
    )
    return out


def density_splat(
    points: np.ndarray, h: int, w: int, sigma: float,
    radius: Optional[int], scale: float,
) -> np.ndarray:
    """gaussian_filter (reflect) of the binary dot map of (x, y)
    ``points`` (``dot_map``'s clamping), times ``scale``."""
    out = np.empty((h, w), np.float32)
    pts = np.ascontiguousarray(points, np.float32).reshape(-1, 2)
    lib().ct_density_splat(
        _ptr(pts), pts.shape[0], h, w, sigma,
        -1 if radius is None else int(radius), scale, _ptr(out),
    )
    return out
