"""The port's binding of the native host core (countr_tpu_torch/native.py)
against the JAX package's (countr_tpu/native.py): both libraries are
built from native/src/host_ops.cpp with the same g++ flags, so each of
the six functions gives the same bits on the same inputs and seed. Also:
the build failure raises with the compiler's output (no silent numpy
fallback), the numpy paths run only on request (COUNTR_TORCH_NATIVE=0),
and the ABI version is checked."""

import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from countr_tpu import native as jnative
from countr_tpu_torch import native as tnative


@pytest.fixture(scope="module", autouse=True)
def _both_built():
    assert jnative.lib() is not None, "the JAX package's native library did not build"
    tnative.lib()


def _img(seed=0, h=37, w=53):
    return np.random.default_rng(seed).uniform(0, 1, (h, w, 3)).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 2 ** 40 + 7, 2 ** 63 - 1])
def test_noise_clip(seed):
    a, b = _img(1), _img(1)
    jnative.noise_clip(a, 0.1, seed)
    tnative.noise_clip(b, 0.1, seed)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, _img(1))


@pytest.mark.parametrize("other,factor", [(0.0, 1.2), (0.37, 0.85)])
def test_blend_scalar(other, factor):
    a, b = _img(2), _img(2)
    jnative.blend_scalar(a, other, factor)
    tnative.blend_scalar(b, other, factor)
    np.testing.assert_array_equal(a, b)


def test_gray_mean_and_blend_gray():
    a, b = _img(3), _img(3)
    assert jnative.gray_mean(a) == tnative.gray_mean(b)
    jnative.blend_gray(a, 0.9)
    tnative.blend_gray(b, 0.9)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("sigma,radius,scale", [(1.0, None, 1.0), (4.0, 7, 60.0)])
def test_splat_weighted(sigma, radius, scale):
    rng = np.random.default_rng(4)
    h, w = 96, 128
    ys, xs = rng.integers(0, h, 50), rng.integers(0, w, 50)
    vals = rng.uniform(0.1, 1.0, 50).astype(np.float32)
    np.testing.assert_array_equal(
        tnative.splat_weighted(ys, xs, vals, h, w, sigma, radius, scale),
        jnative.splat_weighted(ys, xs, vals, h, w, sigma, radius, scale))


@pytest.mark.parametrize("sigma,radius", [(1.0, None), (4.0, 7)])
def test_density_splat(sigma, radius):
    rng = np.random.default_rng(5)
    h, w = 384, 512
    pts = np.stack([rng.uniform(-0.9, w + 3, 80), rng.uniform(-0.9, h + 3, 80)], 1)
    pts = np.concatenate([pts, pts[:5]])  # duplicates collapse
    got = tnative.density_splat(pts, h, w, sigma, radius, 60.0)
    np.testing.assert_array_equal(got, jnative.density_splat(pts, h, w, sigma, radius, 60.0))
    assert got.shape == (h, w) and got.dtype == np.float32
    assert tnative.density_splat(np.zeros((0, 2)), h, w, sigma, radius, 60.0).sum() == 0


def test_wrappers_check_their_inputs():
    with pytest.raises(ValueError, match="float32"):
        tnative.blend_scalar(_img().astype(np.float64), 0.0, 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        tnative.blend_gray(_img()[:, ::2], 1.0)
    with pytest.raises(ValueError, match="outside"):
        tnative.splat_weighted(np.array([0, 9]), np.array([0, 0]), np.ones(2), 8, 8, 1.0,
                               None, 1.0)


def test_numpy_path_only_on_request(monkeypatch):
    monkeypatch.delenv(tnative.ENV, raising=False)
    assert tnative.enabled()
    monkeypatch.setenv(tnative.ENV, "0")
    assert not tnative.enabled()


def test_first_use_from_many_threads(monkeypatch, tmp_path):
    """The loader's threads reach the library first together: one build,
    every thread bound to it (more threads than cores, a short switch
    interval), and the build directory holds that library alone."""
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnative, "_lib", None)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        start = threading.Barrier(16)

        def first_use(_):
            start.wait(timeout=60)
            return tnative.lib()

        with ThreadPoolExecutor(16) as pool:
            libs = list(pool.map(first_use, range(16), timeout=300))
    finally:
        sys.setswitchinterval(interval)
    assert all(lib is libs[0] for lib in libs)
    assert [p.suffix for p in (tmp_path / "build").iterdir()] == [".so"]


def test_failed_build_raises(monkeypatch, tmp_path):
    bad = tmp_path / "host_ops.cpp"
    bad.write_text("this is not C++ {\n")
    monkeypatch.setattr(tnative, "SOURCE", bad)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnative, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as err:
        tnative.lib()
    assert "error" in str(err.value)  # the compiler's own output
    assert not any((tmp_path / "build").glob("*.so"))


def test_abi_version_checked(monkeypatch):
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "ABI_VERSION", tnative.ABI_VERSION + 1)
    with pytest.raises(RuntimeError, match="ABI version"):
        tnative.lib()
