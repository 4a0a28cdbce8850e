"""The port's CounTR (countr_tpu_torch/models/) against the JAX CounTR
on the same weights and inputs, tiny widths at the full 384 window.

- fp32, plain module path on both sides: the exemplar tokens and
  forward_tokens, with the reference head formulation and with the
  subpixel head; max|d| <= 1e-4 * max(1, max|ref|).
  Observed max|d| (seed 0, peak 1.2): 2.7e-6 for both heads; exemplar
  tokens 3.6e-7.
The bf16 fast mode is tests/test_torch_model_bf16.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from countr_tpu.models.countr import CounTR as JaxCounTR
from tests.torch_port_helpers import jax_model, torch_model


def _inputs(seed, b=2):
    rng = np.random.default_rng(seed)
    imgs = rng.uniform(0, 1, (b, 384, 384, 3)).astype(np.float32)
    boxes = rng.uniform(0, 1, (1, 3, 64, 64, 3)).astype(np.float32)
    return imgs, boxes


def _run_both(mode, subpixel, shot=3, seed=0, b=2, pred_scale=1.0):
    jm, params = jax_model(seed=seed, mode=mode, subpixel_head=subpixel)
    pred = params["params"]["density_head"]["pred"]
    pred["kernel"], pred["bias"] = pred["kernel"] * pred_scale, pred["bias"] * pred_scale
    tm = torch_model(params, mode=mode, subpixel_head=subpixel)
    imgs, boxes = _inputs(seed, b)
    dt = jnp.bfloat16 if mode == "bf16" else jnp.float32
    y_j = jm.apply(params, jnp.asarray(boxes, dt), shot, method=JaxCounTR.encode_exemplars)
    want = np.asarray(jm.apply(
        params, jnp.asarray(imgs), jnp.broadcast_to(y_j, (b, *y_j.shape[1:])),
        method=JaxCounTR.forward_tokens,
    ))
    with torch.inference_mode():
        y_t = tm.encode_exemplars(torch.from_numpy(boxes).to(tm.dec_dtype), shot)
        got = tm.forward_tokens(torch.from_numpy(imgs), y_t.expand(b, *y_t.shape[1:]))
    return (y_t.float().numpy(), np.asarray(y_j, np.float32)), (got.numpy(), want)


@pytest.mark.parametrize("subpixel", [False, True], ids=["reference_head", "subpixel_head"])
def test_forward_tokens_fp32(subpixel):
    (yt, yj), (got, want) = _run_both("fp32", subpixel, b=1)
    np.testing.assert_allclose(yt, yj, atol=1e-5, rtol=1e-4)
    assert got.shape == want.shape == (1, 384, 384)
    assert np.abs(got - want).max() <= 1e-4 * max(1.0, np.abs(want).max())


def test_zero_shot_tokens_fp32():
    jm, params = jax_model(seed=3)
    tm = torch_model(params)
    boxes = jnp.zeros((2, 1, 64, 64, 3))
    y_j = jm.apply(params, boxes, 0, method=JaxCounTR.encode_exemplars)
    y_t = tm.encode_exemplars(torch.zeros((2, 1, 64, 64, 3)), 0)
    # the shot token is a trained parameter: its tokens carry autograd
    np.testing.assert_array_equal(y_t.detach().numpy(), np.asarray(y_j))
