"""The port's device pipeline (countr_tpu_torch/engine/device_pipeline.py)
and the batched engine's host planner against the JAX package's, on the
CPU.

Tolerances: the planner (width_bucket, chunk_plan, stream_chunks,
plan_batch_sets and every array of _plan_set) is integer and copy work,
so exactly equal; extract_windows is a gather and one division, so
bitwise; extract_windows_resampled and accumulate are a few fp32
products and sums that XLA may contract into FMAs where torch rounds
each, so atol 1e-6 on values in [0, 1] and N(0, 1); finalize sums
~150k fp32 values in another order, so rtol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from countr_tpu.config import CounTRConfig as JaxConfig
from countr_tpu.engine import device_pipeline as jdp
from countr_tpu.engine.inference import CountingEngine as JaxEngine
from countr_tpu.models.countr import CounTR as JaxCounTR
from countr_tpu_torch.config import CounTRConfig as TorchConfig
from countr_tpu_torch.engine import device_pipeline as tdp
from countr_tpu_torch.engine.inference import CountingEngine as TorchEngine
from countr_tpu_torch.models.countr import CounTR as TorchCounTR
from tests.torch_port_helpers import TINY

TINY_RECTS = [(12, 12, 17, 17), (60, 60, 65, 65), (100, 100, 105, 105)]
PLAIN_RECTS = [(40, 40, 110, 120), (150, 60, 230, 140), (250, 200, 330, 300)]
# tests/test_bench_pipeline.py:91-101 (bench.py's FSC147-like geometry)
# plus narrow images (< 384), one of them in grid mode
WIDTHS = [384, 448, 512, 512, 576, 640, 512, 688, 512, 464, 576, 512]


def mixed_batch(n=64, narrow=True):
    rng = np.random.default_rng(3)
    widths = [WIDTHS[i % len(WIDTHS)] for i in range(n)]
    if narrow:
        widths[5], widths[9] = 368, 300  # image 9 is also a grid image
    images = [rng.integers(0, 256, (384, w, 3), np.uint8) for w in widths]
    rects = [list(TINY_RECTS) if i % 10 == 9 else list(PLAIN_RECTS) for i in range(n)]
    boxes = [rng.uniform(0, 1, (3, 64, 64, 3)).astype(np.float32) for _ in range(n)]
    return images, boxes, rects


def planners(mode="fp32", **kw):
    """The JAX engine and the port's at the same settings; planning
    touches no parameters."""
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if mode == "bf16" else (jnp.float32, torch.float32)
    jax_engine = JaxEngine(JaxCounTR(JaxConfig(**TINY, dtype=jdt)), {"params": {}}, **kw)
    torch_engine = TorchEngine(TorchCounTR(TorchConfig(**TINY, dtype=tdt)), device="cpu", **kw)
    return jax_engine, torch_engine


def test_width_bucket_matches_jax():
    for w in list(range(300, 1700, 7)) + [4608, 4609, 5000, 9000]:
        assert tdp.width_bucket(w) == jdp.width_bucket(w), w


@pytest.mark.parametrize("b", [4, 8, 16, 32])
def test_chunk_plan_and_stream_chunks_match_jax(b):
    for n in range(0, 100):
        for multiple in (1, 2, 8):
            assert tdp.chunk_plan(n, b, multiple) == jdp.chunk_plan(n, b, multiple)
        for n_plain in (0, n // 3, n):
            assert list(tdp.stream_chunks(n_plain, n, b)) == list(jdp.stream_chunks(n_plain, n, b))


@pytest.mark.parametrize("b, bucket, narrow", [(32, 48, False), (16, 48, True), (8, 7, True)])
def test_plan_batch_sets_matches_jax(b, bucket, narrow):
    images, _, rects = mixed_batch(narrow=narrow)
    jax_engine, torch_engine = planners(batch_windows=b, images_bucket=bucket)
    assert torch_engine.plan_batch_sets(images, rects) == jax_engine.plan_batch_sets(images, rects)
    for w in (300, 384, 385, 600, 1000):
        for r in (PLAIN_RECTS, TINY_RECTS, []):
            assert torch_engine.windows_per_image(w, r) == jax_engine.windows_per_image(w, r)
    for n in range(1, 70):
        assert torch_engine._row_bucket(n) == jax_engine._row_bucket(n)


def _assert_same_plan(got, want):
    assert set(got) == set(want)
    for key in ("u_bucket", "r_bucket", "den_width", "img_rows", "grid_flags", "den_owner_img"):
        assert got[key] == want[key], key
    for key in ("stackr", "rects_arr", "rects_valid"):
        np.testing.assert_array_equal(got[key], np.asarray(want[key]), err_msg=key)
        assert got[key].dtype == np.asarray(want[key]).dtype, key
    np.testing.assert_array_equal(got["bstack"].float().numpy(),
                                  np.asarray(want["bstack"], np.float32))
    assert set(got["plan"]) == set(want["plan"])
    assert got["plan"]["n_plain"] == want["plan"]["n_plain"]
    for key, arr in want["plan"].items():
        if key != "n_plain":
            np.testing.assert_array_equal(got["plan"][key], arr, err_msg=key)
            assert got["plan"][key].dtype == arr.dtype, key


@pytest.mark.parametrize("mode", ["fp32", "bf16"])
def test_plan_set_matches_jax(mode):
    """Every set of the mixed batch, uint8 pixels (bf16: the exemplar
    stack cast on the host, as the JAX package casts it)."""
    images, boxes, rects = mixed_batch()
    jax_engine, torch_engine = planners(mode, batch_windows=16)
    sets = jax_engine.plan_batch_sets(images, rects)
    assert len(sets) > 1 and any(TINY_RECTS == rects[i] for i in sets[0])
    for idxs in sets:
        _assert_same_plan(torch_engine._plan_set(idxs, images, boxes, rects, 3),
                          jax_engine._plan_set(idxs, images, boxes, rects, 3))


def test_plan_set_float_zero_shot_and_reference_policy_match_jax():
    images, boxes, rects = mixed_batch(12)
    images = [im.astype(np.float32) / 255.0 for im in images]
    jax_engine, torch_engine = planners(batch_windows=8)
    idxs = list(range(12))
    _assert_same_plan(torch_engine._plan_set(idxs, images, boxes, rects, 3),
                      jax_engine._plan_set(idxs, images, boxes, rects, 3))
    nothing = [[] for _ in images]
    _assert_same_plan(torch_engine._plan_set(idxs, images, [None] * 12, nothing, 0),
                      jax_engine._plan_set(idxs, images, [None] * 12, nothing, 0))
    jax_engine.narrow_policy = torch_engine.narrow_policy = "reference"
    _assert_same_plan(torch_engine._plan_set(idxs, images, boxes, rects, 3),
                      jax_engine._plan_set(idxs, images, boxes, rects, 3))


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_extract_windows_bitwise(dtype):
    rng = np.random.default_rng(0)
    pool = rng.integers(0, 256, (384, 2048, 3)).astype(dtype)
    if dtype == np.float32:
        pool /= 255.0
    starts = np.asarray([0, 640, 576, 1664, 100], np.int32)
    want = np.asarray(jdp.extract_windows(jnp.asarray(pool), jnp.asarray(starts)))
    got = tdp.extract_windows(torch.from_numpy(pool), torch.from_numpy(starts)).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def _grid_maps():
    """The resample maps of a real set: a narrow grid image (300), a plain
    one (512) and a grid image at 688, side by side in one pool."""
    images, boxes, rects = mixed_batch(20)
    _, torch_engine = planners(batch_windows=8)
    sp = torch_engine._plan_set([9, 8, 19], images, boxes, rects, 3)
    plan = sp["plan"]
    assert plan["ix0"].shape[0] == plan["img_owner"].shape[0] - plan["n_plain"] > 0
    return sp["stackr"], [plan[k] for k in tdp.MAP_KEYS]


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_extract_windows_resampled_matches_jax(dtype):
    pool, maps = _grid_maps()
    pool = pool if dtype == np.uint8 else pool.astype(np.float32) / 255.0
    want = np.asarray(jdp.extract_windows_resampled(jnp.asarray(pool),
                                                    *(jnp.asarray(m) for m in maps)))
    got = tdp.extract_windows_resampled(torch.from_numpy(pool),
                                        *(torch.from_numpy(m) for m in maps)).numpy()
    assert got.shape == want.shape == (maps[0].shape[0], 384, 384, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _accumulate_inputs():
    """Overlapping windows of two density rows, in stitch order, with a
    repeated (owner, start) pair."""
    rng = np.random.default_rng(1)
    dens = rng.standard_normal((7, 384, 384)).astype(np.float32)
    owners = np.asarray([0, 0, 0, 1, 1, 1, 0], np.int32)
    starts = np.asarray([0, 128, 216, 0, 100, 256, 128], np.int32)
    wcols = rng.uniform(0, 1, (7, 384)).astype(np.float32)
    density = rng.standard_normal((2, 384, 640)).astype(np.float32)
    return density, dens, owners, starts, wcols


def test_accumulate_matches_jax():
    density, dens, owners, starts, wcols = _accumulate_inputs()
    want = np.asarray(jdp.accumulate(*(jnp.asarray(a) for a in
                                       (density, dens, owners, starts, wcols))))
    got = tdp.accumulate(torch.from_numpy(density.copy()), torch.from_numpy(dens), owners,
                         starts, torch.from_numpy(wcols)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_accumulate_is_deterministic():
    density, dens, owners, starts, wcols = _accumulate_inputs()
    a, b = (tdp.accumulate(torch.from_numpy(density.copy()), torch.from_numpy(dens), owners,
                           starts, torch.from_numpy(wcols)).numpy() for _ in range(2))
    np.testing.assert_array_equal(a, b)


def test_finalize_matches_jax():
    """Counts and inclusive rect sums, with padded rects (valid 0), a
    whole-map rect and rects past the map's edge
    (tests/test_device_pipeline.py:62)."""
    rng = np.random.default_rng(2)
    density = rng.uniform(0, 1, (3, 384, 512)).astype(np.float32)
    rects = np.asarray(
        [[[10, 20, 50, 80], [0, 0, 383, 511], [300, 400, 999, 999]],
         [[100, 100, 150, 160], [0, 0, 0, 0], [0, 0, 0, 0]],
         [[380, 500, 400, 700], [5, 5, 5, 5], [-3, -3, 2, 2]]], np.int32)
    valid = np.asarray([[1, 1, 1], [1, 0, 0], [1, 1, 1]], np.float32)
    want = jdp.finalize(jnp.asarray(density), jnp.asarray(rects), jnp.asarray(valid))
    got = tdp.finalize(torch.from_numpy(density), torch.from_numpy(rects),
                       torch.from_numpy(valid))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5)
    np.testing.assert_allclose(got[1][0].item(), (density[0, 10:51, 20:81].sum()
                                                  + density[0].sum()
                                                  + density[0, 300:, 400:].sum()) / 60.0,
                               rtol=1e-5)
