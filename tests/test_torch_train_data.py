"""The port's training data path against the JAX package's, on the 6-image
tree of tests/test_data.py::fsc_dir: TrainDataset samples (every index,
epochs 0-2, augmentation on and off, the mosaic and the crop branches,
with the native host core and with the numpy paths), the device-aug
geometry samples (_device_item), the mosaic draws (_mosaic_params) and
ValDataset samples, all bit for bit; DataLoader batches, order,
drop_last and process slices equal to JAX's, threads and spawned
processes alike; device_prefetch's order and its producer's exception."""

import threading

import numpy as np
import pytest

from countr_tpu import native as jnative
from countr_tpu.data import fsc147 as jfsc
from countr_tpu.data import loader as jloader
from countr_tpu.data import transforms as jT
from countr_tpu_torch import native as tnative
from countr_tpu_torch.data import fsc147 as tfsc
from countr_tpu_torch.data import loader as tloader
from countr_tpu_torch.data import transforms as tT
from tests.test_data import fsc_dir  # noqa: F401  (fixture)


@pytest.fixture(scope="module")
def metas(fsc_dir):  # noqa: F811
    return jfsc.FSC147Meta.load(fsc_dir), tfsc.FSC147Meta.load(fsc_dir)


@pytest.fixture(params=["native", "numpy"])
def host_path(request, monkeypatch):
    """Both packages on their native host core, or both on the numpy
    paths (the JAX package's deterministic spec)."""
    if request.param == "numpy":
        monkeypatch.setattr(jnative, "lib", lambda: None)
        monkeypatch.setenv(tnative.ENV, "0")
    else:
        assert jnative.lib() is not None
        monkeypatch.delenv(tnative.ENV, raising=False)
    return request.param


def _same(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, np.ndarray) or np.isscalar(v) and not isinstance(v, str):
            assert np.asarray(got[k]).dtype == np.asarray(v).dtype, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            assert got[k] == v, k


def _branch(seed, epoch, idx) -> str:
    """The branch a sample with augmentation takes: its first draw."""
    return "mosaic" if jfsc._sample_rng(seed, epoch, idx).random() < 0.25 else "crop"


@pytest.mark.parametrize("split,do_aug", [("train", True), ("train", False), ("test", True)])
def test_train_dataset_bitwise(metas, host_path, split, do_aug):
    """Every index at epochs 0-2. The train split's images hold under 70
    dots (cross-image mosaics, m_flag 1); the test split's one image holds
    70 (four crops of itself)."""
    jmeta, tmeta = metas
    seed = 3
    jds = jfsc.TrainDataset(jmeta, split=split, do_aug=do_aug, seed=seed)
    tds = tfsc.TrainDataset(tmeta, split=split, do_aug=do_aug, seed=seed)
    branches = []
    for epoch in range(3):
        jds.set_epoch(epoch)
        tds.set_epoch(epoch)
        for i in range(len(jds)):
            got, want = tds[i], jds[i]
            _same(got, want)
            assert got["image"].shape == (384, 384, 3) and got["gt_density"].shape == (384, 384)
            branches.append((_branch(seed, epoch, i), got["m_flag"]))
    if do_aug:
        kinds = {b for b, _ in branches}
        assert kinds == {"mosaic", "crop"}, branches
        flags = {m for b, m in branches if b == "mosaic"}
        assert flags == ({1} if split == "train" else {0}), branches


def test_device_item_and_mosaic_params_bitwise(metas):
    jmeta, tmeta = metas
    for split in ("train", "test"):
        jds = jfsc.TrainDataset(jmeta, split=split, seed=5, device_aug=True)
        tds = tfsc.TrainDataset(tmeta, split=split, seed=5, device_aug=True)
        for epoch in range(3):
            jds.set_epoch(epoch)
            tds.set_epoch(epoch)
            for i in range(len(jds)):
                got = tds[i]
                _same(got, jds[i])
                assert got["image_u8"].dtype == np.uint8 and got["dots"].dtype == np.int16
                im_id = jds.ids[i]
                args = jds._load_resized_u8(im_id)[1:]
                rj, rt = (jfsc._sample_rng(9, epoch, i) for _ in range(2))
                want = jds._mosaic_params(rj, im_id, *args)
                have = tds._mosaic_params(rt, im_id, *args)
                assert len(have) == len(want) == 7 and have[0] == want[0]
                for a, b in zip(have[1:], want[1:]):
                    np.testing.assert_array_equal(a, b)


def test_val_dataset_bitwise(metas, host_path):
    jmeta, tmeta = metas
    jds, tds = jfsc.ValDataset(jmeta), tfsc.ValDataset(tmeta)
    for _ in range(2):  # the decode, then the cached sample
        for i in range(len(jds)):
            _same(tds[i], jds[i])


def test_train_transforms_bitwise(host_path):
    """The augmentation functions on their own, the same generator seeds."""
    img = np.random.default_rng(1).uniform(0, 1, (50, 70, 3)).astype(np.float32)
    kps = np.random.default_rng(2).uniform(0, 60, (9, 2))
    for name, args in (("gaussian_noise", (img,)), ("color_jitter", (img,)),
                       ("gaussian_blur", (img,)), ("random_affine", (img, kps)),
                       ("random_affine", ((img * 255).astype(np.uint8), kps)),
                       ("draw_affine_matrix", (50, 70))):
        got = getattr(tT, name)(np.random.default_rng(7), *args)
        want = getattr(jT, name)(np.random.default_rng(7), *args)
        for a, b in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
    dmap = np.zeros((40, 50), np.float32)
    dmap[[3, 20, 39], [0, 25, 49]] = [1.0, 0.5, 1.0]
    np.testing.assert_array_equal(tT.smooth_density(dmap), jT.smooth_density(dmap))
    for h, w in ((400, 500), (384, 600), (640, 480), (700, 900), (300, 200)):
        assert tT.flex_size(h, w) == jT.flex_size(h, w)
    rects = [[3, 4, 20, 30], [0, 0, 0, 0]]
    np.testing.assert_array_equal(tT.crop_exemplars_u8((img * 255).astype(np.uint8), rects),
                                  jT.crop_exemplars_u8((img * 255).astype(np.uint8), rects))


# ---------------------------------------------------------------------------
# The loader
# ---------------------------------------------------------------------------


class _Toy:
    """A dataset whose sample names its index and epoch."""

    def __init__(self, n):
        self.n, self.epoch = n, 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"image": np.full((2, 3), i * 10 + self.epoch, np.float32), "m_flag": i % 2,
                "name": f"s{i}", "rects": [[i]]}


def _epochs(loader, epochs=3):
    return [list(loader.epoch(e)) for e in range(epochs)]


@pytest.mark.parametrize("shuffle,drop_last,batch,procs", [
    (True, True, 4, 1), (True, False, 4, 1), (False, False, 3, 1), (True, True, 4, 2),
    (True, False, 6, 3)])
def test_loader_matches_jax(shuffle, drop_last, batch, procs):
    for p in range(procs):
        kw = dict(shuffle=shuffle, drop_last=drop_last, seed=11, num_workers=3,
                  process_index=p, process_count=procs)
        tl = tloader.DataLoader(_Toy(23), batch, **kw)
        jl = jloader.DataLoader(_Toy(23), batch, **kw)
        got, want = _epochs(tl), _epochs(jl)
        tl.close()
        jl.close()
        assert len(got) == len(want)
        for ge, we in zip(got, want):
            assert len(ge) == len(we) > 0
            for g, w in zip(ge, we):
                _same(g, w)
        if procs == 1:
            assert len(tl) == len(got[0])


def test_loader_processes_match_threads(metas):
    """Spawned worker processes give the threads' batches (each sample's
    randomness is its own)."""
    _, tmeta = metas
    ds = tfsc.TrainDataset(tmeta, seed=2)
    threads = tloader.DataLoader(ds, 2, shuffle=True, drop_last=True, seed=4, num_workers=2)
    procs = tloader.DataLoader(ds, 2, shuffle=True, drop_last=True, seed=4, num_workers=2,
                               use_processes=True)
    try:
        for e in (0, 1):
            for g, w in zip(procs.epoch(e), threads.epoch(e), strict=True):
                _same(g, w)
    finally:
        procs.close()
        threads.close()


def test_loader_rejects_bad_slicing():
    with pytest.raises(ValueError, match="divisible"):
        tloader.DataLoader(_Toy(4), 3, process_count=2)


# ---------------------------------------------------------------------------
# device_prefetch (on the CPU: the producer thread makes the tensors)
# ---------------------------------------------------------------------------


def _batches(n, fail_at=None):
    for i in range(n):
        if i == fail_at:
            raise KeyError(f"sample {i}")
        yield {"image": np.full((2, 4), i, np.float32), "m_flag": np.asarray([i % 2], np.int32),
               "name": [f"b{i}"]}


def _prefetch_threads():
    return [t for t in threading.enumerate() if t.name == "device_prefetch"]


def test_device_prefetch_keeps_order():
    import torch

    out = list(tloader.device_prefetch(_batches(9), "cpu", keys=("image",), depth=2))
    assert [b["name"] for b in out] == [[f"b{i}"] for i in range(9)]
    for i, b in enumerate(out):
        assert isinstance(b["image"], torch.Tensor) and float(b["image"][0, 0]) == i
        assert isinstance(b["m_flag"], np.ndarray)  # not in keys: passed through
    assert not _prefetch_threads()


def test_device_prefetch_reraises_producer_error():
    got = []
    with pytest.raises(KeyError, match="sample 3"):
        for b in tloader.device_prefetch(_batches(9, fail_at=3), "cpu", depth=2):
            got.append(b["name"][0])
    assert got == ["b0", "b1", "b2"]
    assert not _prefetch_threads()


def test_device_prefetch_stops_early():
    it = tloader.device_prefetch(_batches(50), "cpu", depth=2)
    assert next(it)["name"] == ["b0"]
    it.close()
    assert not _prefetch_threads()
