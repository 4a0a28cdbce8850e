"""Shared set-up of the engine parity tests (tests/test_torch_engine*.py):
the JAX CountingEngine and the port's, on one tiny fp32 model."""

import numpy as np

from countr_tpu.engine.inference import CountingEngine as JaxEngine
from countr_tpu_torch.engine.inference import CountingEngine as TorchEngine
from tests.torch_port_helpers import jax_model, torch_model

WIDTHS = [384, 600, 1000]
# (y1, x1, y2, x2) rects, as tests/test_reference_loop_oracle.py:37-39:
# plain; the first rect tiny (<10x10, grid mode); five rects (TTN over
# all five, the tiny fifth past the 3-rect grid trigger).
RECTS = {
    "plain": [(20, 30, 80, 90), (100, 120, 180, 200), (200, 40, 300, 140)],
    "grid": [(5, 5, 12, 12), (100, 120, 180, 200), (200, 40, 300, 140)],
}
RECTS["many"] = RECTS["plain"] + [(40, 200, 90, 260), (6, 300, 13, 308)]
SMALL = dict(depth=1, decoder_depth=1)


def engines():
    model, params = jax_model(seed=4, jit=True, **SMALL)
    jax_engine = JaxEngine(model, params, batch_windows=4)
    torch_engine = TorchEngine(torch_model(params, **SMALL), batch_windows=4, device="cpu")
    return jax_engine, torch_engine


def case_inputs(w: int):
    rng = np.random.default_rng(w)
    image = (rng.uniform(0, 1, (384, w, 3)) * 255).astype(np.uint8)
    boxes = rng.uniform(0, 1, (3, 64, 64, 3)).astype(np.float32)
    return image, boxes


def assert_same_count(jax_engine, torch_engine, w: int, rects_name: str):
    import pytest

    image, boxes = case_inputs(w)
    rects = RECTS[rects_name]
    want = jax_engine.count(image, boxes, rects, shot_num=3)
    got = torch_engine.count(image, boxes, rects, shot_num=3)
    assert got.grid_mode == want.grid_mode == (rects_name == "grid")
    assert got.n_windows == want.n_windows
    for field in ("count", "raw_count", "e_cnt"):
        assert getattr(got, field) == pytest.approx(
            getattr(want, field), rel=1e-4, abs=1e-4), field
    return got, want
