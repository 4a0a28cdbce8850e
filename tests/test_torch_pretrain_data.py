"""The port's MAE pretraining data path (countr_tpu_torch/data/fsc147.py
``PretrainDataset``, engine/train_store.py ``PretrainStore``,
``materialize_pretrain_batch``, engine/train.py ``make_store_pretrain_step``)
against the JAX package's on the CPU, on the tree of
tests/test_data.py::fsc_dir (its train split holds two landscape and two
portrait images, so the store holds transposed images), fp32.

- ``sample_crop`` (the fallback branch too), the host samples, the store's
  crop samples over 2 epochs, and the store's pool, base and width arrays:
  bit for bit (the host draws are numpy in both packages; the resizes are
  the same PIL calls).
- ``materialize_pretrain_batch`` within 1e-5 of JAX's jitted one, flip on
  and off (in the training order the last image, 512 px wide, reads 88
  columns of the tail pad), and with the widest image stored last (its
  slab ends where the pad begins). The port rounds the band centre's multiply-add once and
  takes length / 384 as a product with the reciprocal, as XLA compiles the
  JAX code; the fp32 band products sum in another order.
- The same batch against PIL's crop and bicubic resize at the JAX
  package's tolerance (mean < 4e-3, max < 0.06 on the images it holds so,
  tests/test_train_store.py:466), and no farther from PIL than the JAX
  package's own batch (see the test).
- ``make_store_pretrain_step`` against JAX's, two steps fed JAX's own
  masking noise (``jax.random.uniform(key, (B, L))``): each loss within
  rel 1e-5 (tests/test_torch_mae.py's tolerance).
- The store step, eager on the CPU, equal to materialise-then-
  ``make_pretrain_step`` at the same generator state, to the bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from countr_tpu.config import MAEConfig as JaxMAEConfig
from countr_tpu.config import TrainConfig as JaxTrainConfig
from countr_tpu.data import fsc147 as jfsc
from countr_tpu.engine import train as jtrain
from countr_tpu.engine import train_store as jts
from countr_tpu.models import mae as jmae
from countr_tpu_torch.config import MAEConfig, TrainConfig
from countr_tpu_torch.data import fsc147 as tfsc
from countr_tpu_torch.data.loader import default_collate
from countr_tpu_torch.engine import train as ttrain
from countr_tpu_torch.engine import train_store as tts
from countr_tpu_torch.engine.checkpoint import load_weights, mae_state_dict_from_flax
from countr_tpu_torch.models.mae import MaskedAutoencoderViT
from tests.test_data import fsc_dir  # noqa: F401  (fixture)

TOL = 1e-5
KEYS = tts.PRETRAIN_KEYS
TINY_MAE = dict(img_size=384, patch_size=16, embed_dim=32, depth=1, num_heads=2,
                decoder_embed_dim=32, decoder_depth=1, decoder_num_heads=2)
B = 4
L = (384 // 16) ** 2


def _quiet(*_):
    pass


@pytest.fixture(scope="module")
def metas(fsc_dir):  # noqa: F811
    return jfsc.FSC147Meta.load(fsc_dir), tfsc.FSC147Meta.load(fsc_dir)


@pytest.fixture(scope="module")
def stores(metas):
    jmeta, tmeta = metas
    ids = tmeta.splits["train"]
    return (jts.build_pretrain_store(jmeta, ids, log=_quiet),
            tts.build_pretrain_store(tmeta, ids, "cpu", log=_quiet))


@pytest.fixture(scope="module")
def widest_last(metas):
    """Both stores with the widest image (img_1, 600 px) stored last."""
    jmeta, tmeta = metas
    ids = [i for i in tmeta.splits["train"] if i != "img_1.jpg"] + ["img_1.jpg"]
    return (jts.build_pretrain_store(jmeta, ids, log=_quiet),
            tts.build_pretrain_store(tmeta, ids, "cpu", log=_quiet))


@pytest.mark.parametrize("hw", [(384, 500), (500, 420), (384, 384), (37, 41), (10, 1000),
                                (1000, 10)])
def test_sample_crop_matches_jax(hw):
    """The same crops and the same generator state after the draw; (10,
    1000) and (1000, 10) fit no crop and take the ratio-clamped fallback."""
    for seed in range(50):
        jr, tr = np.random.default_rng(seed), np.random.default_rng(seed)
        want = jfsc.PretrainDataset.sample_crop(jr, *hw)
        got = tfsc.PretrainDataset.sample_crop(tr, *hw)
        assert got == want, (hw, seed)
        assert jr.bit_generator.state == tr.bit_generator.state
    assert tfsc.PretrainDataset.sample_crop(np.random.default_rng(0), 10, 1000) == \
        (0, (1000 - 13) // 2, 10, 13)
    assert tfsc.PretrainDataset.sample_crop(np.random.default_rng(0), 1000, 10) == \
        ((1000 - 13) // 2, 0, 13, 10)


def test_host_items_match_jax(metas):
    jmeta, tmeta = metas
    jds, tds = jfsc.PretrainDataset(jmeta, seed=3), tfsc.PretrainDataset(tmeta, seed=3)
    flips = set()
    for epoch in (0, 1):
        jds.set_epoch(epoch)
        tds.set_epoch(epoch)
        for i in range(len(tds)):
            want, got = jds[i], tds[i]
            assert got["name"] == want["name"]
            assert got["image"].dtype == np.float32 and got["image"].shape == (384, 384, 3)
            np.testing.assert_array_equal(got["image"], want["image"])
            rng = tfsc._sample_rng(3, epoch, i)
            tds.sample_crop(rng, *np.asarray(tmeta.open_image(got["name"])).shape[:2])
            flips.add(rng.random() < 0.5)
    assert flips == {False, True}


def test_store_arrays_match_jax(stores, widest_last):
    for js, ts in (stores, widest_last):
        np.testing.assert_array_equal(ts.pixels.numpy(), np.asarray(js.pixels))
        np.testing.assert_array_equal(ts.base.numpy(), np.asarray(js.base))
        np.testing.assert_array_equal(ts.width.numpy(), np.asarray(js.width))
        np.testing.assert_array_equal(ts.catalog.w_np, js.w_np)
        np.testing.assert_array_equal(ts.catalog.t_np, js.t_np)
        assert ts.max_w == js.max_w and ts.ids == js.ids and ts.catalog.index == js.index
        assert ts.pixels.shape[0] == int(ts.base[-1] + 384 * ts.width[-1]) + 384 * ts.max_w
    ts = stores[1]
    assert ts.catalog.t_np.tolist() == [0, 0, 1, 1] and ts.max_w == 600
    assert widest_last[1].width[-1] == 600


def _store_datasets(metas, stores, seed=0):
    (jmeta, tmeta), (js, ts) = metas, stores
    return (jfsc.PretrainDataset(jmeta, seed=seed, store=js),
            tfsc.PretrainDataset(tmeta, seed=seed, store=ts.catalog))


def test_store_items_match_jax(metas, stores):
    jds, tds = _store_datasets(metas, stores, seed=5)
    for epoch in (0, 1):
        jds.set_epoch(epoch)
        tds.set_epoch(epoch)
        for i in range(len(tds)):
            want, got = jds[i], tds[i]
            assert sorted(got) == sorted(want)
            for k in KEYS:
                assert got[k].dtype == want[k].dtype and got[k] == want[k], (epoch, i, k)
            assert got["name"] == want["name"]


def _batch(ds, epoch, flip=None):
    """A collated batch of every sample of ``ds`` at ``epoch`` (the flips
    forced to ``flip`` where given)."""
    ds.set_epoch(epoch)
    batch = default_collate([ds[i] for i in range(len(ds))])
    if flip is not None:
        batch["flip"] = np.full_like(batch["flip"], flip)
    return batch


def _jax_materialize(js, batch):
    mat = jax.jit(jts.materialize_pretrain_batch, static_argnums=(2,))
    return np.asarray(mat(js.arrays, {k: jnp.asarray(batch[k]) for k in KEYS}, js.max_w))


def _port_materialize(ts, batch):
    return tts.materialize_pretrain_batch(
        ts.arrays, {k: torch.from_numpy(batch[k]) for k in KEYS}, ts.max_w).numpy()


@pytest.mark.parametrize("layout,flip", [("train_order", 0), ("train_order", 1),
                                         ("widest_last", None)])
def test_materialize_matches_jax(metas, stores, widest_last, layout, flip):
    js, ts = stores if layout == "train_order" else widest_last
    _, tds = _store_datasets(metas, (js, ts), seed=1)
    for epoch in (0, 1):
        batch = _batch(tds, epoch, flip)
        assert set(batch["transposed"].tolist()) == {0, 1}
        got, want = _port_materialize(ts, batch), _jax_materialize(js, batch)
        assert got.shape == want.shape == (len(tds), 384, 384, 3)
        assert np.abs(got - want).max() <= TOL, (epoch, np.abs(got - want).max())


def test_materialize_matches_pil(metas, stores):
    """Each crop of a batch against PIL's crop + bicubic resize (+ flip) of
    the stored image in its original orientation: the mean within the JAX
    package's 4e-3 everywhere, the max within its 0.06 on the images it
    holds so (the resized img_0 and img_2), and the port's max distance to
    PIL that of the JAX package's own materialisation. img_1 is stored
    unresized (its height is 384), so its crops keep the JPEG noise's full
    band; there the bicubic overshoots [0, 255] in the first pass, which
    PIL rounds and clips to uint8 and the band products (the JAX package's
    and the port's) carry on: up to 0.076 in both packages alike (1/255
    with the intermediate rounded and clipped)."""
    from PIL import Image

    js, ts = stores
    _, tds = _store_datasets(metas, stores, seed=2)
    px = ts.pixels.numpy()
    for flip in (0, 1):
        batch = _batch(tds, 0, flip)
        got, jgot = _port_materialize(ts, batch), _jax_materialize(js, batch)
        for s in range(len(tds)):
            i = int(batch["img_idx"][s])
            w, base = int(ts.width[i]), int(ts.base[i])
            stored = px[base : base + 384 * w].reshape(w, 384, 3).transpose(1, 0, 2)
            t = bool(batch["transposed"][s])
            orig = stored.transpose(1, 0, 2) if t else stored
            top, left, ch, cw = (int(batch[k][s]) for k in ("crop_top", "crop_left", "crop_h",
                                                            "crop_w"))
            if t:
                top, left, ch, cw = left, top, cw, ch
            want = np.asarray(Image.fromarray(np.ascontiguousarray(orig)).crop(
                (left, top, left + cw, top + ch)).resize((384, 384), Image.BICUBIC),
                np.float32) / 255.0
            if flip:
                want = want[:, ::-1]
            d = np.abs(got[s] - want)
            assert d.mean() < 4e-3, (s, flip, d.mean())
            assert abs(d.max() - np.abs(jgot[s] - want).max()) <= TOL, (s, flip)
            if ts.ids[i] in ("img_0.jpg", "img_2.jpg"):
                assert d.max() < 0.06, (s, flip, d.max())


def _jax_mae(seed=0):
    model = jmae.MaskedAutoencoderViT(JaxMAEConfig(**TINY_MAE, dtype=jnp.float32))
    params = jax.jit(model.init)(jax.random.key(seed), jnp.zeros((1, 384, 384, 3)),
                                 jax.random.key(1))
    rng = np.random.default_rng(seed + 100)
    leaves, tree = jax.tree.flatten(params)
    leaves = [np.asarray(l) + 0.02 * rng.standard_normal(np.shape(l)).astype(np.float32)
              for l in leaves]
    return model, jax.tree.unflatten(tree, [jnp.asarray(l) for l in leaves])


def _port_state(params, kw):
    model = MaskedAutoencoderViT(MAEConfig(**TINY_MAE, dtype=torch.float32))
    load_weights(model, mae_state_dict_from_flax(jax.tree.map(np.asarray, params), grid=24))
    cfg = TrainConfig(**kw)
    return ttrain.init_train_state(model.train(), cfg, steps_per_epoch=2, world_batch=B), cfg


TRAIN_KW = dict(batch_size=B, epochs=4, warmup_epochs=0, lr=1e-3, weight_decay=0.05)


def test_store_step_matches_jax(metas, stores):
    js, ts = stores
    _, tds = _store_datasets(metas, stores, seed=4)
    jm, params = _jax_mae()
    tx, _ = jtrain.make_optimizer(JaxTrainConfig(**TRAIN_KW), steps_per_epoch=2, world_batch=B)
    jstate = jtrain.init_train_state(params["params"], tx)
    jstep = jtrain.make_store_pretrain_step(jm, js.max_w)
    tstate, cfg = _port_state(params, TRAIN_KW)
    tstep = ttrain.make_store_pretrain_step(tstate, cfg, ts.arrays, ts.max_w)
    for i in range(2):
        batch = _batch(tds, i)
        key = jax.random.key(20 + i)
        jstate, jmet = jstep(jstate, js.arrays, {k: jnp.asarray(batch[k]) for k in KEYS}, key)
        noise = torch.from_numpy(np.array(jax.random.uniform(key, (B, L))))
        tmet = tstep({k: torch.from_numpy(batch[k]) for k in KEYS}, noise)
        assert float(tmet["loss"]) == pytest.approx(float(jmet["loss"]), rel=TOL), i
    assert tstate.step == 2


def test_store_step_equals_materialize_then_pretrain_step(metas, stores):
    """The store step's graph-capturable body, eager on the CPU, against
    the pixels it materialises fed to ``make_pretrain_step``: the same
    losses, weights and Adam tensors, bit for bit, the noise drawn from the
    generator in both."""
    _, ts = stores
    _, tds = _store_datasets(metas, stores, seed=6)
    _, params = _jax_mae(seed=2)
    (a, cfg), (b, _) = _port_state(params, TRAIN_KW), _port_state(params, TRAIN_KW)
    ga, gb = torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)
    store_step = ttrain.make_store_pretrain_step(a, cfg, ts.arrays, ts.max_w, ga)
    plain_step = ttrain.make_pretrain_step(b, cfg, gb)
    for epoch in range(3):
        batch = {k: torch.from_numpy(v) for k, v in _batch(tds, epoch).items() if k in KEYS}
        la = store_step(batch)["loss"]
        lb = plain_step(tts.materialize_pretrain_batch(ts.arrays, batch, ts.max_w))["loss"]
        assert torch.equal(la, lb), epoch
    for p, q in zip(a.params, b.params):
        assert torch.equal(p, q)
        assert all(torch.equal(x, y) for x, y in zip(a.moments(p), b.moments(q)))
