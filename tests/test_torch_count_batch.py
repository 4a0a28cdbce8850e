"""The port's CountingEngine.count_batch (device="cpu") against the JAX
package's count_batch on the same tiny fp32 model (the weight bridge of
tests/torch_engine_cases.py), and against the port's own count, the
cases of tests/test_count_batch.py:29-154 (not the sharded mesh):
plain, grid and narrow images in one batch, uint8 and float pixels,
return_density=False and zero-shot.

Tolerances: against JAX, count, raw_count and e_cnt at rel 1e-4 / abs
1e-4 and the density at atol 1e-4 / rtol 1e-3 (fp32 forwards on two
frameworks, ~1e-6 apart per value; the stitch and finalize sum in
another order), grid_mode and n_windows equal; against count, rel 2e-4
(count stitches on the host in float64, count_batch on the device in
float32; JAX's own bound between the two, tests/test_count_batch.py:49).
"""

import numpy as np
import pytest

from tests.torch_engine_cases import RECTS, engines

TINY = [(5, 5, 12, 12), (50, 50, 120, 130), (10, 20, 60, 80)]
NARROW_TINY = [(5, 5, 12, 12), (40, 40, 80, 90), (100, 100, 150, 160)]


def batch(name: str):
    """(images, boxes, rects, shot_num, return_density) of a case."""
    rng = np.random.default_rng(11)
    if name == "zero_shot":
        imgs = [rng.uniform(0, 1, (384, w, 3)).astype(np.float32) for w in (512, 640)]
        return imgs, [None, None], [[], []], 0, True
    widths = (600, 416, 384, 368, 300, 1000)
    rects = [RECTS["plain"], TINY, RECTS["plain"], NARROW_TINY, RECTS["plain"], RECTS["many"]]
    imgs = [rng.integers(0, 256, (384, w, 3), dtype=np.uint8) for w in widths]
    if name == "float":
        imgs = [rng.uniform(0, 1, (384, w, 3)).astype(np.float32) for w in widths[:3]]
        rects = rects[:3]
    boxes = [rng.uniform(0, 1, (3, 64, 64, 3)).astype(np.float32) for _ in imgs]
    return imgs, boxes, rects, 3, name != "no_density"


CASES = ["mixed_uint8", "float", "no_density", "zero_shot"]


@pytest.fixture(scope="module")
def both():
    return engines()


@pytest.fixture(scope="module")
def results(both):
    jax_engine, torch_engine = both
    out = {}
    for name in CASES:
        imgs, boxes, rects, shot, dens = batch(name)
        out[name] = (torch_engine.count_batch(imgs, boxes, rects, shot, return_density=dens),
                     jax_engine.count_batch(imgs, boxes, rects, shot, return_density=dens))
    return out


@pytest.mark.parametrize("name", CASES)
def test_count_batch_matches_jax(results, name):
    got, want = results[name]
    _, _, rects, _, dens = batch(name)
    assert len(got) == len(want) == len(rects)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.grid_mode == w.grid_mode, i
        assert g.n_windows == w.n_windows, i
        for field in ("count", "raw_count", "e_cnt"):
            assert getattr(g, field) == pytest.approx(getattr(w, field), rel=1e-4, abs=1e-4), \
                (i, field)
        if dens:
            np.testing.assert_allclose(g.density, w.density, atol=1e-4, rtol=1e-3)
        else:
            assert g.density is None and w.density is None
    if name == "mixed_uint8":
        assert [g.grid_mode for g in got] == [False, True, False, True, False, False]


@pytest.mark.parametrize("name", CASES)
def test_count_batch_matches_count(both, results, name):
    _, torch_engine = both
    imgs, boxes, rects, shot, dens = batch(name)
    got, _ = results[name]
    for i in range(len(imgs)):
        single = torch_engine.count(imgs[i], boxes[i], rects[i], shot_num=shot)
        assert got[i].grid_mode == single.grid_mode
        assert got[i].n_windows == single.n_windows
        assert got[i].count == pytest.approx(single.count, rel=2e-4), i
        assert got[i].raw_count == pytest.approx(single.raw_count, rel=2e-4), i
        assert got[i].e_cnt == pytest.approx(single.e_cnt, rel=2e-4, abs=1e-6), i


def test_count_batch_counts_upload_bytes(both):
    """h2d_bytes counts what a set uploads: a uint8 pool (one byte a
    pixel, 2048-column bucket) beside the plan, far below a float pool."""
    _, torch_engine = both
    rng = np.random.default_rng(5)
    imgs = [rng.integers(0, 256, (384, 464, 3), dtype=np.uint8),
            rng.integers(0, 256, (384, 512, 3), dtype=np.uint8)]
    boxes = [rng.uniform(0, 1, (3, 64, 64, 3)).astype(np.float32) for _ in imgs]
    torch_engine.h2d_bytes = 0
    torch_engine.count_batch(imgs, boxes, [TINY, RECTS["plain"]], 3, return_density=False)
    assert 384 * 2048 * 3 < torch_engine.h2d_bytes < 384 * 2048 * 3 * 4
