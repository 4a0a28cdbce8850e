"""The port's resident CARPK store (countr_tpu_torch/engine/carpk_store.py,
``make_carpk_store_step``) and its train sample (data/carpk.py
``carpk_train_sample``) against the JAX package's on the CPU, on the CARPK
tree of tests/test_carpk.py::carpk_dir (720x1280 PNGs), fp32.

- The store's arrays and ``exemplar_geometry`` equal to JAX's, bit for bit.
- ``materialize_carpk_batch`` within 2e-6 of JAX's (the two lerps in the
  same order, in float32), and against the port's host sample
  ``carpk_train_sample`` at JAX's own tolerances
  (tests/test_carpk_store.py): the image and the exemplar 2e-6 (cv2 sums
  its separable resize in another order), the density 1e-5.
- ``carpk_train_sample`` equal to JAX's, bit for bit.
- ``make_carpk_store_step`` against JAX's: loss and metrics of two steps
  within rel 1e-5 (the second after the first update). No draw differs: the loss mask is the only one, and
  ``loss_mask_p`` is 1.0 in the CLI's program itself.
"""

import jax
import numpy as np
import pytest
import torch

from countr_tpu import config as jconfig
from countr_tpu.data import carpk as jcarpk
from countr_tpu.engine import carpk_store as jcs
from countr_tpu.engine import train as jtrain
from countr_tpu_torch import config as tconfig
from countr_tpu_torch.data import carpk as tcarpk
from countr_tpu_torch.engine import carpk_store as tcs
from countr_tpu_torch.engine import train as ttrain
from countr_tpu_torch.engine.checkpoint import load_weights, state_dict_from_flax
from countr_tpu_torch.models.countr import CounTR
from tests.test_carpk import carpk_dir  # noqa: F401  (fixture)
from tests.torch_port_helpers import jax_model

TINY384 = dict(img_size=384, patch_size=16, embed_dim=32, depth=1, num_heads=2,
               decoder_embed_dim=32, decoder_depth=1, decoder_num_heads=2, head_width=32)
IMG_TOL = 2e-6  # tests/test_carpk_store.py
DEN_TOL = 1e-5


@pytest.fixture(scope="module")
def stores(carpk_dir):  # noqa: F811
    jsrc, tsrc = jcarpk.CarpkLocal(carpk_dir, "train"), tcarpk.CarpkLocal(carpk_dir, "train")
    return (jsrc, tsrc, jcs.build_carpk_store(jsrc, log=lambda *_: None),
            tcs.build_carpk_store(tsrc, "cpu", log=lambda *_: None))


def _geometry(mod, store, idxs, seed):
    geo = mod.exemplar_geometry(np.random.default_rng(seed), store, np.asarray(idxs))
    geo["img_idx"] = np.asarray(idxs, np.int32)
    return geo


def _torch(geo):
    return {k: torch.from_numpy(v) for k, v in geo.items()}


def test_store_and_geometry_match_jax(stores):
    _, _, js, ts = stores
    assert set(ts.arrays) == set(js.arrays)
    for k, v in js.arrays.items():
        got = ts.arrays[k].numpy()
        np.testing.assert_array_equal(got, np.asarray(v), err_msg=k)
        assert got.dtype == np.asarray(v).dtype, k
    assert (ts.n_images, ts.src_h, ts.src_w) == (js.n_images, js.src_h, js.src_w)
    for a, b in zip(ts.boxes_xywh, js.boxes_xywh):
        np.testing.assert_array_equal(a, b)
    for seed in (0, 7):
        got, want = _geometry(tcs, ts, [0, 1, 1], seed), _geometry(jcs, js, [0, 1, 1], seed)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_materialize_matches_jax_and_host(stores):
    jsrc, tsrc, js, ts = stores
    idxs = [0, 1]
    geo = _geometry(tcs, ts, idxs, 7)
    want_img, want_box = jcs.materialize_carpk_batch(js.arrays, geo)
    got_img, got_box = tcs.materialize_carpk_batch(ts.arrays, _torch(geo))
    assert got_img.shape == (2, 384, 384, 3) and got_box.shape == (2, 3, 64, 64, 3)
    assert np.abs(got_img.numpy() - np.asarray(want_img)).max() <= IMG_TOL
    assert np.abs(got_box.numpy() - np.asarray(want_box)).max() <= IMG_TOL
    # against the host sample: the same box (the same rng stream picks it)
    rng = np.random.default_rng(7)
    for p, i in enumerate(idxs):
        box = ts.boxes_xywh[i][int(rng.integers(0, len(ts.boxes_xywh[i])))]
        host = tcarpk.carpk_train_sample(np.random.default_rng(0), tsrc[i])
        assert np.abs(got_img[p].numpy() - host["image"]).max() <= IMG_TOL
        ex = tcarpk._crop_resize64(tsrc[i]["image"].astype(np.float32) / 255.0, box)
        assert np.abs(got_box[p, 0].numpy() - ex).max() <= IMG_TOL
        assert torch.equal(got_box[p, 2], got_box[p, 0])
        den = ttrain.density_from_dots(ts.arrays["dots"][i : i + 1], ts.arrays["n_dots"][i : i + 1])
        assert np.abs(den[0].numpy() - host["gt_density"]).max() <= DEN_TOL
        assert host["gt_density"].sum() > 60  # the tree's boxes reach the left crop


def test_train_sample_matches_jax(stores):
    jsrc, tsrc, _, _ = stores
    for i in range(len(tsrc)):
        got = tcarpk.carpk_train_sample(np.random.default_rng(i + 3), tsrc[i])
        want = jcarpk.carpk_train_sample(np.random.default_rng(i + 3), jsrc[i])
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v), err_msg=k)


def test_store_step_matches_jax(stores):
    _, _, js, ts = stores
    jm, params = jax_model(seed=2, jit=True, **TINY384)
    kw = dict(batch_size=2, epochs=2, warmup_epochs=0, lr=1e-3, loss_mask_p=1.0)
    jcfg = jconfig.TrainConfig(**kw)
    tx, _ = jtrain.make_optimizer(jcfg, steps_per_epoch=2, world_batch=2, freeze_encoder=True)
    jstate = jtrain.init_train_state(params["params"], tx)
    jstep = jtrain.make_carpk_store_step(jm, jcfg)
    model = CounTR(tconfig.CounTRConfig(**TINY384))
    load_weights(model, state_dict_from_flax(jax.tree.map(np.asarray, params)))
    cfg = tconfig.TrainConfig(**kw)
    state = ttrain.init_train_state(model.train(), cfg, steps_per_epoch=2, world_batch=2)
    tstep = ttrain.make_carpk_store_step(state, cfg, ts.arrays)
    losses = []
    for seed in (1, 2):  # the second step after an update
        geo = _geometry(tcs, ts, [1, 0], seed)
        jstate, jm_ = jstep(jstate, js.arrays, geo, jax.random.key(seed))
        tm = tstep(_torch(geo))
        for k in ("loss", "mae", "mse"):
            assert float(tm[k]) == pytest.approx(float(jm_[k]), rel=1e-5), (seed, k)
        losses.append(float(tm["loss"]))
    assert losses[0] != losses[1]  # the second loss reads the first update


def test_store_raises_on_mixed_shapes(stores):
    _, tsrc, _, _ = stores
    samples = [tsrc[0], dict(tsrc[1], image=tsrc[1]["image"][:700])]
    with pytest.raises(ValueError, match="uniform image shapes"):
        tcs.build_carpk_store(samples, "cpu", log=lambda *_: None)
