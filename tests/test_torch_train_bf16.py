"""The port's bf16 training build on the CPU (the kernels' plain
versions; B2 off, B1 and B3/B4 on, encoder frozen), tiny widths.

- Every trainable tensor gets a gradient from one masked-MSE step, and
  no frozen one does (the repairs of cast_param, the shot token and the
  frozen encoder): at shot 3 all but the shot token, which is unused
  there; at shot 0 the shot token.
- The loss of one bf16 step against the JAX package's bf16
  ``make_finetune_step`` on the same weights, batch and mask, with the
  pred conv scaled by 1/4 so that the densities peak well below 1, as a
  trained model's do (ROADMAP section C: the two frameworks round bf16
  at other points by design). Bound: with every density pixel within
  delta = 2.2e-2 * max(1, peak) of JAX's (docs/PARITY.md:235, the
  forward's bound), the masked mean of squares differs by at most
  delta * (2 * sqrt(loss) + delta). Observed: |d loss| 2.3e-5, 0.006 of
  the bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from countr_tpu.engine import train as jtrain
from countr_tpu_torch.config import fast_mode_overrides
from countr_tpu_torch.engine import train as ttrain
from countr_tpu_torch.models import build_countr
from tests.test_torch_train import (
    B, HW, batch, jax_mask, jax_params, port_model, to_torch, train_cfgs,
)
from tests.torch_port_helpers import TINY


def _exact_zero_grad(name: str) -> bool:
    """The exemplar convs' biases (an affine-free InstanceNorm follows)
    and the cross-attention key biases (the softmax removes a constant
    row of logits) have an exact gradient of 0: only fp32/bf16 noise."""
    return name.startswith("decoder_proj") and name.endswith(".bias") or \
        name.endswith("attn.wk.bias")


def _grads(mode: str, shot: int):
    model = build_countr("mae_vit_base6_patch16", device="cpu", training=True,
                         **TINY, **fast_mode_overrides(mode, training=True))
    assert model.training and not model.cfg.fused_attn_block
    rng = np.random.default_rng(7)
    imgs = torch.from_numpy(rng.uniform(0, 1, (2, 384, 384, 3)).astype(np.float32))
    gt = torch.from_numpy((0.05 * rng.uniform(0, 1, (2, 384, 384))).astype(np.float32))
    boxes = torch.from_numpy(rng.uniform(0, 1, (2, 3, 64, 64, 3)).astype(np.float32))
    mask = ttrain.loss_mask(384, 0.8, torch.Generator().manual_seed(0))
    loss, _ = ttrain.finetune_loss(model, imgs, gt, boxes, shot, mask)
    loss.backward()
    labels = ttrain.frozen_labels(model)
    return model, labels, loss.item()


@pytest.mark.parametrize("mode", ["bf16", "fp32"])
def test_every_trainable_tensor_gets_a_gradient(mode):
    model, labels, loss = _grads(mode, 3)
    assert np.isfinite(loss)
    trained = 0
    for name, p in model.named_parameters():
        if labels[name] == "frozen":
            assert p.grad is None, name
        elif name == "shot_token":
            assert p.grad is None  # unused at shot 3
        else:
            assert p.grad is not None and p.grad.dtype == torch.float32, name
            assert bool(torch.isfinite(p.grad).all()), name
            assert _exact_zero_grad(name) or float(p.grad.abs().max()) > 0, name
            trained += 1
    assert trained == 74


@pytest.mark.parametrize("mode", ["bf16", "fp32"])
def test_shot_token_gets_a_gradient_at_zero_shots(mode):
    model, labels, _ = _grads(mode, 0)
    g = model.shot_token.grad
    assert g is not None and bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0
    # the exemplar CNN is unused at zero shots
    assert all(p.grad is None for n, p in model.named_parameters()
               if n.startswith("decoder_proj"))


def test_bf16_step_loss_matches_jax():
    jm, params = jax_params("bf16", seed=5)
    pred = params["params"]["density_head"]["pred"]
    pred["kernel"], pred["bias"] = pred["kernel"] * 0.25, pred["bias"] * 0.25
    tm = port_model(params, "bf16")
    jcfg, tcfg = train_cfgs(0)
    tx, _ = jtrain.make_optimizer(jcfg, steps_per_epoch=2, world_batch=B, freeze_encoder=True)
    jstate = jtrain.init_train_state(params["params"], tx)
    b = batch(5)
    key = jax.random.key(3)
    _, jm_metrics = jtrain.make_finetune_step(jm, jcfg)(
        jstate, {k: jnp.asarray(v) for k, v in b.items()}, key, 3)
    tb = to_torch(b)
    mask = torch.from_numpy(np.array(jax_mask(key)))
    loss, out = ttrain.finetune_loss(tm, tb["image"], tb["gt_density"], tb["boxes"], 3, mask)
    want = float(jm_metrics["loss"])
    delta = 2.2e-2 * max(1.0, float(out.detach().abs().max()))
    assert abs(loss.item() - want) <= delta * (2 * np.sqrt(want) + delta)
    assert out.shape == (B, HW, HW)
