"""The port's resident FSC147 store (countr_tpu_torch/engine/train_store.py,
the store steps of engine/train.py, TrainDataset's store mode) against the
JAX package's (countr_tpu/engine/train_store.py, countr_tpu/engine/train.py)
on the CPU, on the 6-image tree of tests/test_data.py::fsc_dir, fp32.

- The store: the same pixels (the JAX pool packs each pixel into a uint32
  lane, the port's is [P, 3] uint8), catalog and exemplars, bit for bit;
  the ValStore bit for bit.
- ``_affine_sample`` and ``_mosaic_sample`` on the same geometry within
  1e-5 (the port gathers each mosaic cell's two taps directly, where JAX
  multiplies by band matrices: the same two-term sums, in the same order).
- ``materialize_batch`` at n_mosaic None, 0, 2 and B: images within 1e-5,
  exemplars bit for bit; ``sort_mosaic_first`` and ``mosaic_bucket`` equal.
- ``_store_item`` samples and the loader's collated batches bit for bit
  (the host draws are numpy in both packages).
- The store eval step's sums against JAX's ``make_store_eval_step`` within
  rel 1e-5.
- The store step against JAX's ``make_store_finetune_step``: the loss and
  metrics within rel 1e-5, every trainable gradient within
  1e-5 * max(1, max|g|) (JAX's read from its first Adam moment, as in
  tests/test_torch_train.py), on an all-mosaic batch at ``loss_mask_p``
  1.0. The photometric factors and the loss mask are the two random draws
  the packages cannot share (``jax.random`` keys there, a torch generator
  here); mosaic samples skip the photometric chain and a 1.0 mask keeps
  every pixel, so this batch draws nothing that differs.
- The port's store step on a mixed batch, bit for bit against
  ``finetune_core`` fed the port's own ``materialize_train_batch`` at the
  same generator state; the pipelined step (prime, pipelined steps, the
  train phase) against the serial step over 3 batches, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from countr_tpu import config as jconfig
from countr_tpu.data import fsc147 as jfsc
from countr_tpu.data.loader import DataLoader as JaxLoader
from countr_tpu.engine import train as jtrain
from countr_tpu.engine import train_store as jts
from countr_tpu_torch import config as tconfig
from countr_tpu_torch.data import fsc147 as tfsc
from countr_tpu_torch.data import transforms as T
from countr_tpu_torch.data.loader import DataLoader
from countr_tpu_torch.engine import train as ttrain
from countr_tpu_torch.engine import train_store as tts
from countr_tpu_torch.engine.checkpoint import load_weights, state_dict_from_flax
from countr_tpu_torch.models.countr import CounTR
from tests.test_data import fsc_dir  # noqa: F401  (fixture)
from tests.torch_port_helpers import jax_model

TINY384 = dict(img_size=384, patch_size=16, embed_dim=32, depth=1, num_heads=2,
               decoder_embed_dim=32, decoder_depth=1, decoder_num_heads=2, head_width=32)
TOL = 1e-5
GEO_KEYS = ttrain.STORE_KEYS


@pytest.fixture(scope="module")
def stores(fsc_dir):  # noqa: F811
    jmeta, tmeta = jfsc.FSC147Meta.load(fsc_dir), tfsc.FSC147Meta.load(fsc_dir)
    ids = tmeta.splits["train"]
    return (jmeta, tmeta, jts.build_store(jmeta, ids, log=lambda *_: None),
            tts.build_store(tmeta, ids, "cpu", log=lambda *_: None))


def _datasets(stores, seed=0):
    jmeta, tmeta, js, ts = stores
    return (jfsc.TrainDataset(jmeta, seed=seed, store_index=js.index),
            tfsc.TrainDataset(tmeta, seed=seed, store_index=ts.index))


def _jax(batch, keys=GEO_KEYS):
    return {k: jnp.asarray(batch[k]) for k in keys}


def _torch(batch, keys=GEO_KEYS):
    return {k: torch.from_numpy(np.ascontiguousarray(batch[k])) for k in keys}


def _collate(items):
    from countr_tpu_torch.data.loader import default_collate

    return default_collate(items)


def _items(ds, want, n, start=0):
    """n store samples of ``ds`` (scanning epochs, then indices) for which
    ``want(sample)`` holds."""
    out = []
    for epoch in range(start, start + 200):
        ds.set_epoch(epoch)
        for i in range(len(ds)):
            s = ds[i]
            if want(s):
                out.append(s)
                if len(out) == n:
                    return out
    raise AssertionError("the tree never gave the samples asked for")


def test_store_matches_jax(stores):
    _, _, js, ts = stores
    packed = np.asarray(js.pixels)
    unpacked = np.stack([(packed >> 16) & 0xFF, (packed >> 8) & 0xFF, packed & 0xFF],
                        -1).astype(np.uint8)
    np.testing.assert_array_equal(ts.pixels.numpy(), unpacked)
    np.testing.assert_array_equal(ts.exemplars.numpy(), np.asarray(js.exemplars))
    for k in ("base", "width", "height"):
        np.testing.assert_array_equal(getattr(ts, k).numpy(), np.asarray(getattr(js, k)), k)
    assert ts.ids == js.ids and ts.index == js.index
    np.testing.assert_array_equal(ts.h_np, js.h_np)
    np.testing.assert_array_equal(ts.w_np, js.w_np)
    assert ts.pixels.shape[0] == int(ts.base[-1] + ts.height[-1] * ts.width[-1]) + 384


def test_affine_sample_matches_jax(stores):
    _, _, js, ts = stores
    rng = np.random.default_rng(5)
    idx, Cs, ds = [], [], []
    for i in range(len(ts.ids)):
        nh, nw = int(ts.h_np[i]), int(ts.w_np[i])
        for flip in (False, True):
            M = T.draw_affine_matrix(rng, nh, nw)
            left = int(rng.integers(0, nw - 384 + 1))
            top = int(rng.integers(0, nh - 384 + 1))
            C, d = tts.compose_affine(M, flip, left, top, nw)
            jC, jd = jts.compose_affine(M, flip, left, top, nw)
            np.testing.assert_array_equal(C, jC)
            np.testing.assert_array_equal(d, jd)
            idx.append(i)
            Cs.append(C)
            ds.append(d)
    idx = np.asarray(idx)
    jf = jax.jit(jax.vmap(jts._affine_sample, in_axes=(None, 0, 0, 0, 0, 0, 0)))
    b, w, h = (np.asarray(getattr(js, k))[idx] for k in ("base", "width", "height"))
    want = np.asarray(jf(js.pixels, b, w, h, w, jnp.asarray(np.stack(Cs)),
                         jnp.asarray(np.stack(ds))))
    t = torch.from_numpy(idx)
    got = tts._affine_sample(ts.pixels, ts.base[t], ts.width[t], ts.height[t], ts.width[t],
                             torch.from_numpy(np.stack(Cs)), torch.from_numpy(np.stack(ds)))
    assert got.shape == (len(idx), 384, 384, 3)
    assert np.abs(got.numpy() - want).max() <= TOL
    assert (want == 0).any() and want.max() > 0.9  # the border and the image both sampled


@pytest.mark.parametrize("bl", [10, 13, 20])
def test_mosaic_sample_matches_jax(stores, bl):
    _, _, js, ts = stores
    rng = np.random.default_rng(bl)
    k = 3
    cells = rng.integers(0, len(ts.ids), (k, 4))
    lens = np.zeros((k, 4), np.int64)
    tops, lefts = np.zeros_like(lens), np.zeros_like(lens)
    for s in range(k):
        for c in range(4):
            h, w = int(ts.h_np[cells[s, c]]), int(ts.w_np[cells[s, c]])
            lens[s, c] = rng.integers(150, min(385, min(h, w) + 1))
            tops[s, c] = rng.integers(0, h - lens[s, c] + 1)
            lefts[s, c] = rng.integers(0, w - lens[s, c] + 1)
    base, width = np.asarray(js.base), np.asarray(js.width)
    jf = jax.jit(jax.vmap(jts._mosaic_sample, in_axes=(None, 0, 0, 0, 0, 0, 0)))
    want = np.asarray(jf(js.pixels, base[cells], width[cells], tops.astype(np.int32),
                         lefts.astype(np.int32), lens.astype(np.int32),
                         np.full(k, bl, np.int32)))
    c = torch.from_numpy(cells)
    got = tts._mosaic_sample(ts.pixels, ts.base[c], ts.width[c], torch.from_numpy(tops),
                             torch.from_numpy(lefts), torch.from_numpy(lens),
                             torch.full((k,), bl))
    assert np.abs(got.numpy() - want).max() <= TOL


@pytest.mark.parametrize("n_mosaic", [None, 0, 2, 4])
def test_materialize_batch_matches_jax(stores, n_mosaic):
    """A batch of 4 from the port's loader, sorted mosaic-first, whose
    mosaic count buckets to ``n_mosaic`` (None: any batch with a mosaic)."""
    jds, tds = _datasets(stores, seed=3)
    _, _, js, ts = stores
    loader = DataLoader(tds, 4, shuffle=True, num_workers=0, drop_last=True, seed=3)
    for epoch in range(200):
        batch = next(iter(loader.epoch(epoch)))
        srt, k = tts.sort_mosaic_first(batch)
        jsrt, jk = jts.sort_mosaic_first(batch)
        assert k == jk
        for key in GEO_KEYS:
            np.testing.assert_array_equal(srt[key], jsrt[key])
        bucket = tts.mosaic_bucket(k, 4)
        assert bucket == jts.mosaic_bucket(k, 4)
        if (n_mosaic is None and 0 < k < 4) or (n_mosaic is not None and bucket == n_mosaic
                                                and (k > 0 or n_mosaic == 0)):
            break
    else:
        raise AssertionError(f"no batch buckets to {n_mosaic}")
    want_img, want_box = jax.jit(jts.materialize_batch, static_argnums=2)(
        js.arrays, _jax(srt), n_mosaic)
    got_img, got_box = tts.materialize_batch(ts.arrays, _torch(srt), n_mosaic)
    assert np.abs(got_img.numpy() - np.asarray(want_img)).max() <= TOL
    np.testing.assert_array_equal(got_box.numpy(), np.asarray(want_box))
    if n_mosaic is not None and n_mosaic < 4:
        full, _ = tts.materialize_batch(ts.arrays, _torch(srt), None)
        assert torch.equal(full, got_img)


def test_bucket_values():
    for b in (1, 3, 8):
        assert [tts.mosaic_bucket(k, b) for k in range(b + 1)] == \
            [jts.mosaic_bucket(k, b) for k in range(b + 1)]


def test_store_items_match_jax(stores):
    jds, tds = _datasets(stores)
    seen = set()
    for epoch in range(4):
        jds.set_epoch(epoch)
        tds.set_epoch(epoch)
        for i in range(len(tds)):
            got, want = tds[i], jds[i]
            assert set(got) == set(want)
            seen.add(float(got["is_mosaic"]))
            for k, v in want.items():
                if isinstance(v, np.ndarray) or np.isscalar(v):
                    np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v), err_msg=k)
                    assert np.asarray(got[k]).dtype == np.asarray(v).dtype, k
                else:
                    assert got[k] == v, k
    assert seen == {0.0, 1.0}
    jb = next(iter(JaxLoader(jds, 2, shuffle=True, num_workers=0, drop_last=True,
                             seed=0).epoch(1)))
    tb = next(iter(DataLoader(tds, 2, shuffle=True, num_workers=2, drop_last=True,
                              seed=0).epoch(1)))
    for k in (*GEO_KEYS, "m_flag"):
        np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
        assert tb[k].dtype == jb[k].dtype, k


def test_val_store_matches_jax(stores):
    jmeta, tmeta, _, _ = stores
    want = jts.build_val_store(jfsc.ValDataset(jmeta), log=lambda *_: None)
    got = tts.build_val_store(tfsc.ValDataset(tmeta), "cpu", log=lambda *_: None)
    assert got.n == want.n
    for k in ("images", "boxes", "gt_cnt"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)), k)


@pytest.fixture(scope="module")
def models():
    jm, params = jax_model(seed=4, jit=True, **TINY384)
    return jm, params, state_dict_from_flax(jax.tree.map(np.asarray, params))


def port_model(sd) -> CounTR:
    model = CounTR(tconfig.CounTRConfig(**TINY384))
    load_weights(model, sd)
    return model.train()


def test_store_eval_step_matches_jax(stores, models):
    jmeta, tmeta, _, _ = stores
    jm, params, sd = models
    jval = jts.build_val_store(jfsc.ValDataset(jmeta), log=lambda *_: None)
    tval = tts.build_val_store(tfsc.ValDataset(tmeta), "cpu", log=lambda *_: None)
    jeval = jtrain.make_store_eval_step(jm)
    teval = ttrain.make_store_eval_step(port_model(sd).eval(), tval.arrays)
    idxs, valid = np.asarray([0, 0], np.int32), np.asarray([1.0, 0.0], np.float32)
    for shot in (0, 3):
        want = jeval(params["params"], jval.arrays, jnp.asarray(idxs), jnp.asarray(valid), shot)
        got = teval({"idxs": torch.from_numpy(idxs.astype(np.int64)),
                     "valid": torch.from_numpy(valid)}, shot)
        assert float(got["n"]) == float(want["n"]) == 1.0
        for k in ("err_sum", "sq_sum", "nae_sum"):
            assert float(got[k]) == pytest.approx(float(want[k]), rel=TOL), (shot, k)


def test_store_step_matches_jax(stores, models):
    """One store step on an all-mosaic batch at loss_mask_p 1.0 (the
    module's docstring says why): loss, metrics and every trainable
    gradient against JAX's."""
    jds, tds = _datasets(stores)
    _, _, js, ts = stores
    jm, params, sd = models
    batch = _collate(_items(tds, lambda s: s["is_mosaic"] > 0, 2))
    kw = dict(batch_size=2, epochs=2, warmup_epochs=0, lr=1e-3, loss_mask_p=1.0)
    jcfg = jconfig.TrainConfig(**kw)
    tx, _ = jtrain.make_optimizer(jcfg, steps_per_epoch=2, world_batch=2, freeze_encoder=True)
    jstate = jtrain.init_train_state(params["params"], tx)
    jstate, jmet = jtrain.make_store_finetune_step(jm, jcfg)(
        jstate, js.arrays, _jax(batch), jax.random.key(1), 3)
    model = port_model(sd)
    cfg = tconfig.TrainConfig(**kw)
    state = ttrain.init_train_state(model, cfg, steps_per_epoch=2, world_batch=2)
    tmet = ttrain.make_store_finetune_step(state, cfg, ts.arrays)(_torch(batch), 3)
    for k in ("loss", "mae", "mse"):
        assert float(tmet[k]) == pytest.approx(float(jmet[k]), rel=TOL), k
    masked = lambda m: isinstance(m, optax.MaskedNode)  # noqa: E731
    want = state_dict_from_flax(jax.tree.map(
        lambda m, x: np.zeros(np.shape(x)) if masked(m) else np.asarray(m, np.float64) / 0.1,
        optax.tree_utils.tree_get(jstate.opt_state, "mu"), jstate.params, is_leaf=masked))
    checked = 0
    for name, p in model.named_parameters():
        if p.grad is None:
            continue
        g = p.grad.numpy()
        assert np.abs(g - want[name]).max() <= TOL * max(1.0, np.abs(want[name]).max()), name
        checked += 1
    assert checked == len(state.params) > 40


def _mixed_batch(tds, n=4):
    items = _items(tds, lambda s: s["is_mosaic"] > 0, 1) + \
        _items(tds, lambda s: s["is_mosaic"] == 0, n - 1)
    return _torch(_collate(items)), [s["m_flag"] for s in items]


def test_store_step_is_materialize_then_core(stores, models):
    """The store step on a mixed batch equals, bit for bit, finetune_core
    fed the port's own materialisation and augmentation at the same
    generator state (the default loss_mask_p)."""
    _, tds = _datasets(stores)
    _, _, _, ts = stores
    _, _, sd = models
    geo, _ = _mixed_batch(tds)
    cfg = tconfig.TrainConfig(batch_size=4, epochs=2, warmup_epochs=0, lr=1e-3)
    a, b = port_model(sd), port_model(sd)
    sa = ttrain.init_train_state(a, cfg, steps_per_epoch=2, world_batch=4)
    sb = ttrain.init_train_state(b, cfg, steps_per_epoch=2, world_batch=4)
    ga, gb = torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)
    ma = ttrain.make_store_finetune_step(sa, cfg, ts.arrays, ga)(geo, 2)
    c = ttrain.materialize_train_batch(ts.arrays, geo, gb, 384, cfg.loss_mask_p)
    assert not c["mask"].all()
    mb = ttrain.finetune_core(sb, c["imgs"], c["gt"], c["boxes"], 2, c["mask"])
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k
    for p, q in zip(a.parameters(), b.parameters()):
        assert torch.equal(p, q)
    assert torch.equal(ga.get_state(), gb.get_state())


def test_pipelined_matches_serial(stores, models):
    _, tds = _datasets(stores)
    _, _, _, ts = stores
    _, _, sd = models
    loader = DataLoader(tds, 2, shuffle=True, num_workers=0, drop_last=True, seed=0)
    batches = [_torch(next(iter(loader.epoch(e)))) for e in range(3)]
    shots = [3, 1, 2]
    cfg = tconfig.TrainConfig(batch_size=2, epochs=2, warmup_epochs=0, lr=1e-3)
    a, b = port_model(sd), port_model(sd)
    sa = ttrain.init_train_state(a, cfg, steps_per_epoch=3, world_batch=2)
    sb = ttrain.init_train_state(b, cfg, steps_per_epoch=3, world_batch=2)
    ga, gb = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    serial = ttrain.make_store_finetune_step(sa, cfg, ts.arrays, ga)
    want = [serial(bt, s) for bt, s in zip(batches, shots)]
    prime = ttrain.make_store_materialize(sb, cfg, ts.arrays, gb)
    pipe = ttrain.make_store_finetune_step_pipelined(sb, cfg, ts.arrays, gb)
    train_phase = ttrain.make_store_train_phase(sb, cfg)
    carry = prime(batches[0])
    got = []
    for bt, s in zip(batches[1:], shots):
        m, carry = pipe(carry, bt, s)
        got.append(m)
    got.append(train_phase(carry, shots[-1]))
    for w, g in zip(want, got):
        for k in w:
            assert torch.equal(w[k], g[k]), k
    assert len({float(w["loss"]) for w in want}) == 3
    for p, q in zip(a.parameters(), b.parameters()):
        assert torch.equal(p, q)
    assert sa.step == sb.step == 3
