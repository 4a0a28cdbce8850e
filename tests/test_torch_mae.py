"""The port's MAE pretraining path (countr_tpu_torch/models/mae.py,
``engine/train.py make_pretrain_step``, ``engine/checkpoint.py
mae_state_dict_from_flax``) against the JAX package's
(countr_tpu/models/mae.py, ``make_pretrain_step``,
``convert_mae_state_dict``), tiny widths at a 64x64 image (16 patches),
the same weights (through the bridge) and the same masking noise
(``jax.random.uniform(rng, (B, L))``, which is what JAX's
``random_masking`` draws) on both sides.

Tolerances, and the maxima observed on the CPU:
- ``patchify``, ``unpatchify``, ``random_masking`` and the bridge's round
  trip: exact.
- fp32 forward: pred and loss within 1e-5 (relative for the loss), the
  mask exact. Both sides run the same fp32 arithmetic (JAX at
  Precision.HIGHEST) and differ in the order of sums. Observed: pred
  8.0e-7, loss rel. 1.0e-7.
- bf16 forward, the pretrain CLI's build (B2 off) and the config's
  default (B2 on): pred within 2^-5 * max(1, max|ref|)
  (docs/PARITY.md:231's bound of a fused block) and the loss within
  2.2e-2 relative (the bound chip_smoke.py holds a kernel step's loss
  to). The two sides round at other points by design: the port's plain
  versions follow the kernels (exp2 softmax, P unnormalised in bf16,
  division after PV; tanh GELU in fp32 rounded once), JAX's CPU twins
  normalise P first and round the GELU after each op. Observed, both
  builds: pred 1.56e-2 at max|ref| 1.69 (one bf16 ulp in [1, 2); 0.30 of
  the limit), loss rel. 6.2e-5.
- One ``make_pretrain_step`` in fp32 and a 3-step trajectory: the
  tolerances of tests/test_torch_train.py — loss 1e-5 relative,
  gradients 1e-5 * max(1, max|g|), parameters 1e-5, except elements
  whose gradient is fp32 noise (every attention's key bias, which the
  softmax removes, or a gradient below 1e-7), held to Adam's step bound.
  Observed: gradients 5.6e-9, loss rel. 1.3e-7, parameters 3.2e-7 (the
  noise elements 1.5e-5, within the bound of 2e-3 a step).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from countr_tpu.config import CounTRConfig as JaxCounTRConfig
from countr_tpu.config import MAEConfig as JaxMAEConfig
from countr_tpu.config import TrainConfig as JaxTrainConfig
from countr_tpu.engine import train as jtrain
from countr_tpu.engine.checkpoint import convert_mae_state_dict
from countr_tpu.models import mae as jmae
from countr_tpu.models.countr import CounTR as JaxCounTR
from countr_tpu_torch.config import MAE_PRESETS, MAEConfig, TrainConfig, pretrain_overrides
from countr_tpu_torch.engine import train as ttrain
from countr_tpu_torch.engine.checkpoint import (
    load_torch_checkpoint, load_weights, mae_state_dict_from_flax, state_dict_from_flax,
)
from countr_tpu_torch.models import build_mae
from countr_tpu_torch.models import mae as tmae
from countr_tpu_torch.ops.fused_attn import fused_attention
from countr_tpu_torch.ops.fused_block import fused_attention_block
from countr_tpu_torch.ops.fused_ln import fused_layer_norm

HW = 64
B = 2
L = (HW // 16) ** 2
TINY_MAE = dict(img_size=HW, patch_size=16, embed_dim=64, depth=2, num_heads=4,
                decoder_embed_dim=64, decoder_depth=2, decoder_num_heads=4)
WEAK_GRAD = 1e-7


def jax_mae(mode="fp32", fused=False, seed=0, masked_loss=False, **kw):
    """(model, params) of a tiny JAX MAE in ``mode`` (bf16: the pretrain
    CLI's build with B2 ``fused`` or not); params randomised beyond the
    init."""
    if mode == "bf16":
        extra = dict(dtype=jnp.bfloat16, use_pallas_attention=True, approx_gelu=True,
                     fused_attn_block=fused)
    else:
        extra = dict(dtype=jnp.float32)
    model = jmae.MaskedAutoencoderViT(JaxMAEConfig(**TINY_MAE, **kw, **extra),
                                      masked_loss=masked_loss)
    params = jax.jit(model.init)(jax.random.key(seed), jnp.zeros((1, HW, HW, 3)),
                                 jax.random.key(1))
    rng = np.random.default_rng(seed + 100)
    leaves, tree = jax.tree.flatten(params)
    leaves = [np.asarray(l) + 0.02 * rng.standard_normal(np.shape(l)).astype(np.float32)
              for l in leaves]
    return model, jax.tree.unflatten(tree, [jnp.asarray(l) for l in leaves])


def bridge(params) -> dict:
    return mae_state_dict_from_flax(jax.tree.map(np.asarray, params), grid=HW // 16)


def port_mae(params, mode="fp32", fused=False, masked_loss=False, **kw):
    cfg = MAEConfig(**TINY_MAE, **kw, **pretrain_overrides(mode, fused))
    model = tmae.MaskedAutoencoderViT(cfg, masked_loss=masked_loss)
    load_weights(model, bridge(params))
    return model.train()


def images(seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (B, HW, HW, 3)).astype(np.float32)


def noise_of(key):
    """The noise JAX's random_masking draws from ``key``."""
    return np.array(jax.random.uniform(key, (B, L)))


def test_patchify_unpatchify_match_jax():
    imgs = images()
    want = np.asarray(jmae.patchify(jnp.asarray(imgs), 16))
    got = tmae.patchify(torch.from_numpy(imgs), 16)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tmae.unpatchify(got, 16).numpy(),
                                  np.asarray(jmae.unpatchify(jnp.asarray(want), 16)))
    np.testing.assert_array_equal(tmae.unpatchify(got, 16).numpy(), imgs)


@pytest.mark.parametrize("ratio", [0.5, 0.75])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_random_masking_matches_jax(ratio, dtype):
    jd, td = {"fp32": (jnp.float32, torch.float32),
              "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    x = np.random.default_rng(1).standard_normal((B, L, 8)).astype(np.float32)
    key = jax.random.key(7)
    want = jmae.random_masking(key, jnp.asarray(x, jd), ratio)
    got = tmae.random_masking(torch.from_numpy(x).to(td), ratio,
                              noise=torch.from_numpy(noise_of(key)))
    assert got[1].dtype == td
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.float().numpy(), np.asarray(w, np.float32))
    # noise from a generator: the same function of the drawn noise
    gen = torch.Generator().manual_seed(3)
    noise = torch.rand((B, L), generator=torch.Generator().manual_seed(3))
    a = tmae.random_masking(torch.from_numpy(x), ratio, generator=gen)
    b = tmae.random_masking(torch.from_numpy(x), ratio, noise=noise)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


@pytest.mark.parametrize("norm_pix,masked", [(False, False), (True, False), (False, True),
                                             (True, True)])
def test_forward_fp32_matches_jax(norm_pix, masked):
    jm, params = jax_mae(norm_pix_loss=norm_pix, masked_loss=masked)
    tm = port_mae(params, norm_pix_loss=norm_pix, masked_loss=masked)
    imgs, key = images(2), jax.random.key(5)
    jl, jp, jk = jm.apply(params, jnp.asarray(imgs), key)
    with torch.no_grad():
        tl, tp, tk = tm(torch.from_numpy(imgs), noise=torch.from_numpy(noise_of(key)))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    assert np.abs(tp.numpy() - np.asarray(jp)).max() <= 1e-5
    assert float(tl) == pytest.approx(float(jl), rel=1e-5)


@pytest.mark.parametrize("fused", [False, True], ids=["cli_build", "config_default"])
def test_forward_bf16_matches_jax(fused):
    jm, params = jax_mae("bf16", fused)
    tm = port_mae(params, "bf16", fused)
    imgs, key = images(3), jax.random.key(6)
    jl, jp, _ = jm.apply(params, jnp.asarray(imgs), key)
    counts = (fused_layer_norm.launches, fused_attention.launches,
              fused_attention_block.launches)
    with torch.no_grad():
        tl, tp, _ = tm(torch.from_numpy(imgs), noise=torch.from_numpy(noise_of(key)))
    assert counts == (fused_layer_norm.launches, fused_attention.launches,
                      fused_attention_block.launches)  # CPU: no kernel launched
    want = np.asarray(jp, np.float32)
    assert tp.dtype == torch.bfloat16
    assert np.abs(tp.float().numpy() - want).max() <= 2.0 ** -5 * max(1.0, np.abs(want).max())
    assert float(tl) == pytest.approx(float(jl), rel=2.2e-2)


def test_bridge_round_trip_is_exact(tmp_path):
    """mae_state_dict_from_flax, then the JAX package's converter, gives
    the flax tree back; the state_dict loads strictly, also from a
    reference-layout .pth."""
    _, params = jax_mae(seed=4)
    sd = bridge(params)
    back = convert_mae_state_dict(sd, depth=TINY_MAE["depth"],
                                  decoder_depth=TINY_MAE["decoder_depth"])
    want = jax.tree_util.tree_leaves_with_path(params)
    got = jax.tree_util.tree_leaves_with_path(back)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=str(k))
    path = tmp_path / "mae.pth"
    torch.save({"model": {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}}, path)
    model = tmae.MaskedAutoencoderViT(MAEConfig(**TINY_MAE))
    load_weights(model, load_torch_checkpoint(str(path)))
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)


def zero_grad_elements(name: str, shape) -> np.ndarray:
    """The key biases of every attention: their exact gradient is 0 (a
    constant added to a row of logits, which the softmax removes), so
    each side holds fp32 noise there."""
    mask = np.zeros(shape, bool)
    if name.endswith("attn.qkv.bias"):
        c = shape[0] // 3
        mask[c:2 * c] = True
    return mask


class Pair:
    """The same MAE and optimizer in both packages, stepped together."""

    def __init__(self, warmup_epochs=0, seed=0):
        self.jm, params = jax_mae(seed=seed)
        kw = dict(batch_size=B, epochs=4, warmup_epochs=warmup_epochs, lr=1e-3,
                  weight_decay=0.05)
        tx, _ = jtrain.make_optimizer(JaxTrainConfig(**kw), steps_per_epoch=2, world_batch=B)
        self.jstate = jtrain.init_train_state(params["params"], tx)
        self.jstep = jtrain.make_pretrain_step(self.jm)
        self.tm = port_mae(params)
        cfg = TrainConfig(**kw)
        self.tstate = ttrain.init_train_state(self.tm, cfg, steps_per_epoch=2, world_batch=B)
        self.tstep = ttrain.make_pretrain_step(self.tstate, cfg)
        self.weak = {}

    def step(self, i, imgs):
        key = jax.random.key(10 + i)
        self.jstate, jm = self.jstep(self.jstate, jnp.asarray(imgs), key)
        tm = self.tstep(torch.from_numpy(imgs), torch.from_numpy(noise_of(key)))
        for name, p in self.tm.named_parameters():
            g = p.grad.abs().numpy()
            weak = (g > 0) & (g < WEAK_GRAD) | zero_grad_elements(name, g.shape)
            self.weak[name] = self.weak.get(name, weak) | weak
        return float(jm["loss"]), float(tm["loss"])

    def assert_params_match(self, lr=1e-3):
        want = bridge(self.jstate.params)
        got = self.tm.state_dict()
        for k, w in want.items():
            d = np.abs(got[k].numpy() - w)
            weak = self.weak.get(k, np.zeros(d.shape, bool))
            assert d[~weak].max(initial=0.0) <= 1e-5, (k, d[~weak].max())
            assert d[weak].max(initial=0.0) <= 2 * lr * self.tstate.step, k


def test_one_pretrain_step_matches_jax():
    pair = Pair()
    jl, tl = pair.step(0, images(4))
    assert tl == pytest.approx(jl, rel=1e-5)
    # JAX's gradients from its first Adam moment (mu = (1 - b1) * g)
    want = bridge(jax.tree.map(lambda m: np.asarray(m, np.float64) / 0.1,
                               optax.tree_utils.tree_get(pair.jstate.opt_state, "mu")))
    names = [n for n, _ in pair.tm.named_parameters()]
    assert sorted(names) == sorted(k for k in want if "pos_embed" not in k)
    for name, p in pair.tm.named_parameters():
        g = p.grad.numpy()
        assert np.abs(g - want[name]).max() <= 1e-5 * max(1.0, np.abs(want[name]).max()), name
    # every parameter trains: an MAE has no frozen encoder
    assert all(pair.tstate.optimizer.state[p]["step"] == 1 for p in pair.tm.parameters())
    pair.assert_params_match()


@pytest.mark.parametrize("warmup_epochs", [0, 1], ids=["lr_from_step0", "warmup"])
def test_three_pretrain_steps_match_jax(warmup_epochs):
    pair = Pair(warmup_epochs=warmup_epochs, seed=1)
    imgs = images(5)
    for i in range(3):
        jl, tl = pair.step(i, imgs)
        assert tl == pytest.approx(jl, rel=1e-5), i
        pair.assert_params_match()
    assert pair.tstate.step == 3


def test_bf16_step_both_builds_agree():
    """One bf16 pretrain step of the CLI's build (B2 off) and of the
    config's default (B2 on, its backward through B3/B4's plain versions
    here), from the same weights and noise: every parameter gets an fp32
    gradient, the losses agree within the bf16 forward's bound, and every
    gradient's cosine is >= 0.99 (the chip's bound for kernels against
    plain versions)."""
    _, params = jax_mae(seed=6)
    imgs = torch.from_numpy(images(6))
    noise = torch.from_numpy(noise_of(jax.random.key(8)))
    out = []
    for fused in (False, True):
        tm = port_mae(params, "bf16", fused)
        loss, _, _ = tm(imgs, noise=noise)
        loss.backward()
        grads = {n: p.grad for n, p in tm.named_parameters()}
        assert all(g is not None and g.dtype == torch.float32 for g in grads.values())
        out.append((float(loss.detach()), grads))
    (l0, g0), (l1, g1) = out
    assert l1 == pytest.approx(l0, rel=2.2e-2)
    for n in g0:
        a, b = g0[n].double().flatten(), g1[n].double().flatten()
        if n.endswith("attn.qkv.bias"):  # drop the key biases' noise
            c = a.numel() // 3
            a, b = torch.cat([a[:c], a[2 * c:]]), torch.cat([b[:c], b[2 * c:]])
        assert float(a @ b / (a.norm() * b.norm())) >= 0.99, n


def test_build_mae_builds_the_cli_and_default_modes():
    tiny = dict(TINY_MAE)
    m = build_mae(device="cpu", **tiny)
    assert m.training and m.cfg.dtype == torch.bfloat16 and m.cfg.use_pallas_attention
    assert not m.cfg.fused_attn_block and m.cfg.approx_gelu
    assert m.blocks[0].use_kernels and not m.blocks[0].fused_block
    m2 = build_mae(device="cpu", fused_attn_block=True, seed=0, **tiny)
    assert m2.decoder_blocks[0].fused_block
    for (k, a), (_, b) in zip(m.state_dict().items(), m2.state_dict().items()):
        assert torch.equal(a, b), k  # the same seed, the same weights
    f = build_mae(device="cpu", dtype="fp32", **tiny)
    assert f.cfg.dtype == torch.float32 and not f.blocks[0].use_kernels
    assert sorted(MAE_PRESETS) == ["mae_vit_base_patch16", "mae_vit_huge_patch14",
                                   "mae_vit_large_patch16"]
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA"):
            build_mae(**tiny)


def test_transfer_encoder_from_an_mae_state():
    """The pretrained encoder of a real MAE state goes into a counting
    model as JAX's ``transfer_encoder`` puts it."""
    _, mae_params = jax_mae(seed=7)
    cm = JaxCounTR(JaxCounTRConfig(**TINY_MAE, head_width=32))
    dst = cm.init(jax.random.key(9), jnp.zeros((1, HW, HW, 3)), jnp.zeros((1, 3, 64, 64, 3)), 3)
    want = state_dict_from_flax(
        jax.tree.map(np.asarray, jtrain.transfer_encoder(mae_params, dst,
                                                         depth=TINY_MAE["depth"])),
        grid=HW // 16)
    got = ttrain.transfer_encoder(bridge(mae_params),
                                  state_dict_from_flax(jax.tree.map(np.asarray, dst),
                                                       grid=HW // 16),
                                  depth=TINY_MAE["depth"])
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(got["blocks.1.mlp.fc2.weight"],
                                  bridge(mae_params)["blocks.1.mlp.fc2.weight"])
