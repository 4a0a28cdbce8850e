"""MAE pretraining at ViT-H/14's geometry on the port, on the CPU: head
dim 80 and a crop of the model's own size instead of 384.

- The port's MAE (fp32, plain attention: ``attention_exp2`` forward,
  ``attention_bwd_plain`` backward, the functions kernels B3 and B4 compute
  on the card) at a tiny hd-80 shape (C 160, 2 heads, patch 14, 56 px,
  encoder depth 2) against the benchmark's plain float32 reference
  (``benchmark/reference/mae_sized.py``) from the same seeded weights,
  images and noise: the loss, every gradient, and one AdamW step of the
  port's training step.
- The same port at the same hd-80, patch-14 shape (2 samples of 56 px)
  against the JAX package's MAE through the bridge, as
  tests/test_torch_mae.py holds it at patch 16: the fp32 forward, and one
  ``make_pretrain_step`` (loss, every gradient, the parameters after it).
- ``materialize_pretrain_batch`` at 378 and 56 px against the reference
  crop resized to that size, and at 384 the same bits with and without
  the size given; the host loader (``PretrainDataset(img_size=...)``)
  against the reference crop at the same draw.
- ``cli.pretrain`` on a 56-px patch-14 preset runs its steps on both
  paths, and on a preset whose crop 14-px patches do not tile refuses
  before the store or the step is built, naming the size.
- B3 and B4 take head dim 80 (``fused_attn.HEAD_DIMS``); B2 does not.
"""

import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.drivers.pretrain import leaf_gaps, split_qkv  # noqa: E402
from benchmark.lib import models  # noqa: E402
from benchmark.reference import mae_sized as ref  # noqa: E402
from countr_tpu_torch import config as tcfg  # noqa: E402
from countr_tpu_torch.cli import pretrain as tpt  # noqa: E402
from countr_tpu_torch.data import fsc147 as tfsc  # noqa: E402
from countr_tpu_torch.engine import train_store as tts  # noqa: E402

# ViT-H/14's configuration file cut to a few channels: head dim 80 kept
HUGE = json.loads((ROOT / "benchmark" / "configs" / "mae_huge14.json").read_text())
TINY_HD80 = dict(HUGE, img_size=56, embed_dim=160, depth=2, num_heads=2, decoder_embed_dim=32,
                 decoder_depth=1, decoder_num_heads=2, gelu="erf")
PRESET, BAD_PRESET = "tiny56p14", "tiny60p14"
TINY_PRESET = dict(img_size=56, patch_size=14, embed_dim=32, depth=1, num_heads=2,
                   decoder_embed_dim=32, decoder_depth=1, decoder_num_heads=2)


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_head_dim_80_is_taken_by_b3_b4_only():
    from countr_tpu_torch.ops import fused_attn, fused_block

    assert 80 in fused_attn.HEAD_DIMS and 80 not in fused_block.HEAD_DIMS
    qkv = torch.zeros((2, 5, 3 * 160), dtype=torch.bfloat16)
    assert fused_attn._geometry(qkv, 2) == (2, 5, 160, 80)
    with pytest.raises(ValueError, match=r"\(16, 32, 64, 80\)"):
        fused_attn._geometry(torch.zeros((2, 5, 3 * 192), dtype=torch.bfloat16), 2)


def _mae_pair(seed: int):
    """The port's fp32 MAE and the reference, from the same seeded weights."""
    state = models.mae_weights(TINY_HD80, seed, "cpu")
    prog = models.program_mae(TINY_HD80, {"dtype": "fp32"}, state, "cpu")
    return state, prog, ref.build(TINY_HD80, state, "cpu")


def _batch(seed: int, b: int = 3):
    g = torch.Generator().manual_seed(seed)
    n = (TINY_HD80["img_size"] // TINY_HD80["patch_size"]) ** 2
    return (torch.rand((b, 3, 56, 56), generator=g), torch.rand((b, n), generator=g))


def test_mae_hd80_matches_reference():
    """Loss within rel 1e-5 (tests/test_torch_mae.py's bound for the port
    against the JAX package: fp32 on both sides, exp2 softmax against
    softmax, other summation orders); every gradient within 1e-4 of the
    largest entry of its leaf (the same rounding through two blocks'
    backward; k's bias, whose gradient is round-off alone, is held to
    the qkv bias's scale)."""
    state, prog, mine = _mae_pair(5)
    imgs, noise = _batch(6)
    loss_p, _, _ = prog(imgs.permute(0, 2, 3, 1), noise=noise)
    loss_p.backward()
    loss_r = mine(imgs, noise)
    loss_r.backward()
    assert float(loss_p.detach()) == pytest.approx(float(loss_r.detach()), rel=1e-5)
    gp = {n: p.grad for n, p in prog.named_parameters()}
    gr = {n: p.grad for n, p in mine.named_parameters()}
    assert set(gp) == set(gr) == set(state)
    for n in gr:
        scale = float(gr[n].abs().max())
        if n.endswith("qkv.bias"):
            scale = float(gr[n][: gr[n].shape[0] // 3].abs().max())
        assert float((gp[n] - gr[n]).abs().max()) <= 1e-4 * scale, n


def test_pretrain_step_hd80_matches_reference_adamw():
    """One step of the port's training step (its AdamW over flat fp32
    buffers, plain on the CPU) against the reference's gradient and
    AdamW: the loss within rel 1e-5; the parameters' change, leaf by
    leaf, within 1e-3 of the reference's by the drivers' leaf gap (a
    first Adam step moves each weight by about lr times the sign of its
    gradient, so entries whose gradient is round-off can flip; leaves
    whose gradient is under a thousandth of the median leaf's are left
    out, as the benchmark's check leaves them out)."""
    from countr_tpu_torch.config import TrainConfig
    from countr_tpu_torch.engine import train as engine

    state, prog, mine = _mae_pair(7)
    imgs, noise = _batch(8)
    opt = {"beta1": 0.9, "beta2": 0.95, "eps": 1e-8, "weight_decay": 0.05}
    cfg = TrainConfig(batch_size=3, epochs=10, warmup_epochs=0, blr=1.5e-4, weight_decay=0.05)
    ts = engine.init_train_state(prog, cfg, 4, 3)
    step = engine.make_pretrain_step(ts, cfg, graphed=False)
    loss_p = float(step(imgs.permute(0, 2, 3, 1), noise)["loss"])
    loss_r = mine(imgs, noise)
    loss_r.backward()
    assert loss_p == pytest.approx(float(loss_r.detach()), rel=1e-5)
    grads = {n: p.grad.detach() for n, p in mine.named_parameters()}
    params = {n: p.data for n, p in mine.named_parameters()}
    ref.adamw(params, grads, {}, 1, 1.5e-4 * 3 / 256, opt)
    delta_r = split_qkv({n: params[n] - state[n] for n in params})
    delta_p = split_qkv({n: p.detach() - state[n] for n, p in prog.named_parameters()})
    g1 = split_qkv(grads)
    med = float(np.median([float(v.norm()) for v in g1.values()]))
    skip = {n for n, v in g1.items() if float(v.norm()) < 1e-3 * med}
    gap, at = leaf_gaps(delta_p, delta_r, skip)
    assert gap <= 1e-3, (gap, at)


# The JAX package's MAE at the same tiny hd-80, patch-14 shape (its
# MAE_PRESETS["mae_vit_huge_patch14"] is ViT-H/14 at 378 px)
JAX_HD80 = dict(img_size=56, patch_size=14, embed_dim=160, depth=2, num_heads=2,
                decoder_embed_dim=32, decoder_depth=1, decoder_num_heads=2)
JAX_B, JAX_L = 2, (56 // 14) ** 2


def _jax_pair(seed: int):
    """(JAX model, its params randomised beyond the init, the port's fp32
    MAE with the same weights through the bridge), as
    tests/test_torch_mae.py pairs them at patch 16."""
    import jax
    import jax.numpy as jnp

    from countr_tpu.config import MAEConfig as JaxMAEConfig
    from countr_tpu.models import mae as jmae
    from countr_tpu_torch.engine.checkpoint import load_weights
    from countr_tpu_torch.models import mae as tmae

    jm = jmae.MaskedAutoencoderViT(JaxMAEConfig(**JAX_HD80, dtype=jnp.float32))
    params = jax.jit(jm.init)(jax.random.key(seed), jnp.zeros((1, 56, 56, 3)),
                              jax.random.key(1))
    rng = np.random.default_rng(seed + 100)
    leaves, tree = jax.tree.flatten(params)
    leaves = [np.asarray(l) + 0.02 * rng.standard_normal(np.shape(l)).astype(np.float32)
              for l in leaves]
    params = jax.tree.unflatten(tree, [jnp.asarray(l) for l in leaves])
    tm = tmae.MaskedAutoencoderViT(tcfg.MAEConfig(**JAX_HD80, **tcfg.pretrain_overrides("fp32")))
    load_weights(tm, _jax_bridge(params))
    return jm, params, tm.train()


def _jax_bridge(params) -> dict:
    import jax

    from countr_tpu_torch.engine.checkpoint import mae_state_dict_from_flax

    return mae_state_dict_from_flax(jax.tree.map(np.asarray, params), patch=14, grid=56 // 14)


def _jax_images(seed: int):
    return np.random.default_rng(seed).uniform(0, 1, (JAX_B, 56, 56, 3)).astype(np.float32)


def _jax_noise(key):
    """The noise JAX's random_masking draws from ``key``."""
    import jax

    return np.array(jax.random.uniform(key, (JAX_B, JAX_L)))


def test_forward_hd80_patch14_matches_jax():
    """fp32 forward against the JAX package's: the mask exact, pred within
    1e-5 and the loss within rel 1e-5 (tests/test_torch_mae.py's bounds:
    the same fp32 arithmetic, JAX at Precision.HIGHEST, sums in other
    orders)."""
    import jax
    import jax.numpy as jnp

    jm, params, tm = _jax_pair(0)
    imgs, key = _jax_images(2), jax.random.key(5)
    jl, jp, jk = jm.apply(params, jnp.asarray(imgs), key)
    with torch.no_grad():
        tl, tp, tk = tm(torch.from_numpy(imgs), noise=torch.from_numpy(_jax_noise(key)))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    assert np.abs(tp.numpy() - np.asarray(jp)).max() <= 1e-5
    assert float(tl) == pytest.approx(float(jl), rel=1e-5)


def test_one_pretrain_step_hd80_patch14_matches_jax():
    """One ``make_pretrain_step`` (fp32, AdamW) against the JAX package's
    on the same images and masking noise, with tests/test_torch_mae.py's
    bounds: the loss within rel 1e-5; every gradient within 1e-5 *
    max(1, max|g|) of JAX's (read from its first Adam moment, mu = 0.1 g);
    the parameters within 1e-5, except elements whose gradient is fp32
    noise (the key biases, which the softmax removes, or a gradient below
    1e-7), held to Adam's step bound of 2 lr."""
    import jax
    import jax.numpy as jnp
    import optax

    from countr_tpu.config import TrainConfig as JaxTrainConfig
    from countr_tpu.engine import train as jtrain
    from countr_tpu_torch.engine import train as ttrain
    from tests.test_torch_mae import WEAK_GRAD, zero_grad_elements

    jm, params, tm = _jax_pair(1)
    lr = 1e-3
    kw = dict(batch_size=JAX_B, epochs=4, warmup_epochs=0, lr=lr, weight_decay=0.05)
    tx, _ = jtrain.make_optimizer(JaxTrainConfig(**kw), steps_per_epoch=2, world_batch=JAX_B)
    jstate = jtrain.init_train_state(params["params"], tx)
    jstate, jmetrics = jtrain.make_pretrain_step(jm)(jstate, jnp.asarray(_jax_images(4)),
                                                     jax.random.key(10))
    cfg = tcfg.TrainConfig(**kw)
    tstate = ttrain.init_train_state(tm, cfg, steps_per_epoch=2, world_batch=JAX_B)
    tmetrics = ttrain.make_pretrain_step(tstate, cfg)(
        torch.from_numpy(_jax_images(4)), torch.from_numpy(_jax_noise(jax.random.key(10))))
    assert float(tmetrics["loss"]) == pytest.approx(float(jmetrics["loss"]), rel=1e-5)
    grads = _jax_bridge(jax.tree.map(lambda m: np.asarray(m, np.float64) / 0.1,
                                     optax.tree_utils.tree_get(jstate.opt_state, "mu")))
    want = _jax_bridge(jstate.params)
    got = tm.state_dict()
    names = [n for n, _ in tm.named_parameters()]
    assert sorted(names) == sorted(k for k in grads if "pos_embed" not in k)
    for name, p in tm.named_parameters():
        g = p.grad.numpy()
        assert np.abs(g - grads[name]).max() <= 1e-5 * max(1.0, np.abs(grads[name]).max()), name
        weak = (np.abs(g) > 0) & (np.abs(g) < WEAK_GRAD) | zero_grad_elements(name, g.shape)
        d = np.abs(got[name].numpy() - want[name])
        assert d[~weak].max(initial=0.0) <= 1e-5, (name, d[~weak].max())
        assert d[weak].max(initial=0.0) <= 2 * lr, name


def _pool(stored: np.ndarray):
    """The store's arrays for one stored image [384, w, 3]."""
    w = stored.shape[1]
    pool = np.concatenate([np.ascontiguousarray(stored.transpose(1, 0, 2)).reshape(-1, 3),
                           np.zeros((384 * w, 3), np.uint8)])
    return ({"pixels": torch.from_numpy(pool), "base": torch.zeros(1, dtype=torch.int64),
             "width": torch.full((1,), w, dtype=torch.int64)}, w)


def _crop_batch(top, left, h, w, tr, flip):
    return {k: torch.tensor([v], dtype=torch.int32 if k.startswith(("img", "crop"))
                            else torch.int8)
            for k, v in (("img_idx", 0), ("crop_top", top), ("crop_left", left), ("crop_h", h),
                         ("crop_w", w), ("transposed", tr), ("flip", flip))}


CROPS = [(0, 0, 384, 384, 0, 0), (30, 77, 201, 260, 0, 1), (5, 100, 300, 150, 1, 0)]


@pytest.mark.parametrize("size", [378, 56])
def test_store_crop_at_model_size_matches_reference(size):
    """Within 2e-4 of the reference crop (benchmark/tests/test_reference.py's
    bound at 384: both fp32, the band products against torch's antialiased
    bicubic sum their taps in other orders)."""
    rng = np.random.default_rng(3)
    stored = rng.integers(0, 256, (384, 520, 3), dtype=np.uint8)
    arrays, w = _pool(stored)
    for top, left, h, cw, tr, flip in CROPS:
        prog = tts.materialize_pretrain_batch(arrays, _crop_batch(top, left, h, cw, tr, flip),
                                              w, size)[0]
        assert tuple(prog.shape) == (size, size, 3)
        mine = ref.crop(stored, bool(tr), top, left, h, cw, bool(flip), "cpu", size)
        assert float((prog - mine.permute(1, 2, 0)).abs().max()) < 2e-4


def test_store_crop_at_384_is_unchanged():
    """At the default size the crop is 384 and the same bits as with the
    size given (the JAX parity tests of tests/test_torch_pretrain_data.py
    hold its values)."""
    rng = np.random.default_rng(4)
    stored = rng.integers(0, 256, (384, 450, 3), dtype=np.uint8)
    arrays, w = _pool(stored)
    for crop in CROPS[1:]:
        batch = _crop_batch(*crop)
        base = tts.materialize_pretrain_batch(arrays, batch, w)
        assert tuple(base.shape) == (1, 384, 384, 3)
        assert torch.equal(base, tts.materialize_pretrain_batch(arrays, batch, w, 384))


@pytest.fixture(scope="module")
def tree384(tmp_path_factory):
    """A train split of four images whose smaller side is 384 (landscapes
    and a portrait), so the stored layout is the decoded image itself;
    smooth, as photographs are (noise upsampled 16x): on white noise PIL's
    two passes clip the first pass's overshoot to uint8 between them,
    which a float32 resize does not, and the gap grows past the bound."""
    root = tmp_path_factory.mktemp("fsc384")
    imdir = root / "images_384_VarV2"
    imdir.mkdir()
    rng = np.random.default_rng(9)
    ids = []
    for i, (h, w) in enumerate([(384, 520), (600, 384), (384, 470), (384, 384)]):
        ids.append(f"img_{i}.jpg")
        small = Image.fromarray(rng.integers(0, 256, (h // 16, w // 16, 3), dtype=np.uint8))
        small.resize((w, h), Image.BILINEAR).save(imdir / ids[-1])
    anno = {i: {"points": [[10.0, 10.0]], "box_examples_coordinates": [
        [[1, 1], [1, 20], [20, 20], [20, 1]]] * 3} for i in ids}
    split = {"train": ids, "val": [], "test": []}
    (root / "annotation_FSC147_384.json").write_text(json.dumps(anno))
    (root / "Train_Test_Val_FSC_147.json").write_text(json.dumps(split))
    (root / "ImageClasses_FSC147.txt").write_text("\n".join(f"{i} widget" for i in ids))
    return str(root)


def test_host_loader_at_model_size_matches_reference(tree384):
    """The host path's samples at 378 px against the reference crop of
    the same draw: mean |d| < 4e-3 and max < 0.06, the bound of
    PIL's uint8 bicubic against a float32 resize that the port's
    materialisation is held to (tests/test_torch_pretrain_data.py,
    tests/test_train_store.py:466): PIL rounds the output to uint8 and its
    taps to fixed point."""
    meta = tfsc.FSC147Meta.load(tree384)
    ds = tfsc.PretrainDataset(meta, seed=11, img_size=378)
    for idx in range(len(ds)):
        got = ds[idx]["image"]
        assert got.shape == (378, 378, 3)
        img = meta.open_image(ds.ids[idx])
        rng = tfsc._sample_rng(11, 0, idx)
        top, left, ch, cw = ds.sample_crop(rng, img.size[1], img.size[0])
        flip = rng.random() < 0.5
        px, tr = ref.store_layout(img)
        if tr:  # the stored layout holds a portrait transposed
            top, left, ch, cw = left, top, cw, ch
        mine = ref.crop(px, tr, top, left, ch, cw, flip, "cpu", 378).permute(1, 2, 0).numpy()
        d = np.abs(got - mine)
        assert d.mean() < 4e-3 and d.max() < 0.06, (idx, d.mean(), d.max())


@pytest.fixture(scope="module")
def presets():
    tcfg.MAE_PRESETS[PRESET] = tcfg.MAEConfig(**TINY_PRESET)
    tcfg.MAE_PRESETS[BAD_PRESET] = tcfg.MAEConfig(**dict(TINY_PRESET, img_size=60))
    yield
    tcfg.MAE_PRESETS.pop(PRESET, None)
    tcfg.MAE_PRESETS.pop(BAD_PRESET, None)


def _argv(tree, preset, *extra):
    return ["--data_path", tree, "--model", preset, "--dtype", "fp32", "--device", "cpu",
            "--batch_size", "2", "--epochs", "1", "--warmup_epochs", "0", "--limit_steps", "2",
            "--num_workers", "2", "--log_every", "0", "--recon_every", "0", "--output_dir", "",
            *extra]


@pytest.mark.parametrize("resident", [False, True], ids=["host", "resident"])
def test_cli_pretrain_crops_the_model_size(tree384, presets, resident):
    extra = ("--resident_data",) * resident
    pt = tpt.Pretrain(tpt.get_args(_argv(tree384, PRESET, *extra)))
    assert pt.img_size == 56
    stats = pt.run()
    assert len(stats) == 1 and math.isfinite(stats[0]["train/loss"])


@pytest.mark.parametrize("resident", [False, True], ids=["host", "resident"])
def test_cli_pretrain_refuses_an_untiled_crop(tree384, presets, resident, monkeypatch):
    def no_store(*a, **kw):
        raise AssertionError("the store was built before the crop was checked")

    monkeypatch.setattr(tts, "build_pretrain_store", no_store)
    extra = ("--resident_data",) * resident
    with pytest.raises(ValueError, match=r"60 px, which 14-px patches do not tile"):
        tpt.Pretrain(tpt.get_args(_argv(tree384, BAD_PRESET, *extra)))
