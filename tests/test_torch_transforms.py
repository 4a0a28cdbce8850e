"""The port's host-side data path and outputs against the JAX package's:
transforms (the same PIL and cv2 calls: bitwise), density_from_dots (both
take the native splat, or scipy's filter on request: within 1e-5), FSC147Meta and TestDataset items, plain, capped and
external (bitwise), and the metrics and visual outputs of the CLIs."""

import json
import os

import numpy as np
import pytest
from PIL import Image

from countr_tpu.data import fsc147 as jfsc
from countr_tpu.data import transforms as jT
from countr_tpu.utils import metrics as jmetrics
from countr_tpu.utils import viz as jviz
from countr_tpu_torch.data import fsc147 as tfsc
from countr_tpu_torch.data import transforms as tT
from countr_tpu_torch.utils import metrics as tmetrics
from countr_tpu_torch.utils import viz as tviz
from tests.test_data import fsc_dir  # fixture  # noqa: F401

SIZES = [(384, 384), (400, 500), (500, 420), (263, 777), (1000, 61)]


def _image(h, w, seed=0):
    rng = np.random.default_rng(seed + h * 7 + w)
    return Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))


@pytest.mark.parametrize("hw", SIZES)
def test_resizes_bitwise(hw):
    h0, w0 = hw
    img = _image(h0, w0)
    nh, nw = tT.test_size(h0, w0)
    assert (nh, nw) == jT.test_size(h0, w0)
    np.testing.assert_array_equal(tT.pil_resize(img, nh, nw), jT.pil_resize(img, nh, nw))
    np.testing.assert_array_equal(tT.pil_resize_u8(img, nh, nw), jT.pil_resize_u8(img, nh, nw))
    arr = np.asarray(img, np.float32) / 255.0
    for oh, ow in ((64, 64), (nh, max(nw, 16)), (h0 // 3 + 1, w0 // 3 + 1)):
        np.testing.assert_array_equal(tT.tensor_resize(arr, oh, ow), jT.tensor_resize(arr, oh, ow))


@pytest.mark.parametrize("hw", SIZES)
def test_crops_and_rects_bitwise(hw):
    h0, w0 = hw
    rng = np.random.default_rng(h0 + w0)
    img = np.asarray(_image(h0, w0), np.float32) / 255.0
    boxes = []
    for _ in range(5):
        x1, y1 = rng.uniform(0, w0 - 2), rng.uniform(0, h0 - 2)
        x2, y2 = min(w0 - 1, x1 + rng.uniform(1, 80)), min(h0 - 1, y1 + rng.uniform(1, 80))
        boxes.append([[x1, y1], [x1, y2], [x2, y2], [x2, y1]])
    sy, sx = rng.uniform(0.5, 1.5, 2)
    rects = tT.scale_rects(boxes, sy, sx)
    assert rects == jT.scale_rects(boxes, sy, sx)
    rects = tT.scale_rects(boxes, 1.0, 1.0) + [[h0 + 5, w0 + 5, h0 + 9, w0 + 9]]  # empty crop
    for k in (0, 3, 6):
        np.testing.assert_array_equal(tT.crop_exemplars(img, rects, max_boxes=k),
                                      jT.crop_exemplars(img, rects, max_boxes=k))


@pytest.mark.parametrize("sigma,radius", [(1.0, None), (4.0, 7)])
def test_density_from_dots(sigma, radius):
    rng = np.random.default_rng(3)
    h, w = 384, 512
    pts = np.stack([rng.uniform(0, w + 3, 60), rng.uniform(0, h + 3, 60)], 1)  # some clamped
    np.testing.assert_array_equal(tT.dot_map(pts, h, w), jT.dot_map(pts, h, w))
    got = tT.density_from_dots(pts, h, w, sigma=sigma, radius=radius)
    want = jT.density_from_dots(pts, h, w, sigma=sigma, radius=radius)
    assert got.shape == want.shape == (h, w)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def _same_sample(got, want):
    assert set(got) == set(want)
    for k in ("image", "dots", "boxes", "gt_map"):
        assert got[k].dtype == want[k].dtype, k
    np.testing.assert_array_equal(got["image"], want["image"])
    np.testing.assert_array_equal(got["dots"], want["dots"])
    np.testing.assert_array_equal(got["boxes"], want["boxes"])
    np.testing.assert_allclose(got["gt_map"], want["gt_map"], atol=1e-5, rtol=0)
    assert got["rects"] == want["rects"]
    assert got["name"] == want["name"]


@pytest.mark.parametrize("split,external,box_bound",
                         [("test", False, -1), ("train", False, -1), ("train", False, 2),
                          ("train", False, 0), ("train", True, -1), ("train", True, 5)])
def test_test_dataset_matches_jax(fsc_dir, split, external, box_bound):  # noqa: F811
    tmeta, jmeta = tfsc.FSC147Meta.load(fsc_dir), jfsc.FSC147Meta.load(fsc_dir)
    assert (tmeta.im_dir, tmeta.annotations, tmeta.splits, tmeta.classes) == \
        (jmeta.im_dir, jmeta.annotations, jmeta.splits, jmeta.classes)
    tds = tfsc.TestDataset(tmeta, split=split, external=external, box_bound=box_bound)
    jds = jfsc.TestDataset(jmeta, split=split, external=external, box_bound=box_bound)
    assert len(tds) == len(jds) > 0
    if external:
        np.testing.assert_array_equal(tds.external_boxes, jds.external_boxes)
    for i in range(len(tds)):
        _same_sample(tds[i], jds[i])


def test_metrics_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    tm, jm = tmetrics.CountingMetrics(), jmetrics.CountingMetrics()
    for pred, gt in zip(rng.uniform(0, 50, 9), [0.0, *rng.integers(1, 60, 8)]):
        tm.update(float(pred), float(gt))
        jm.update(float(pred), float(gt))
    assert tm.summary() == jm.summary()
    for mod, d in ((tmetrics, "t"), (jmetrics, "j")):
        logger = mod.JsonlLogger(str(tmp_path / d))
        logger.write({"MAE": 1.5})
        logger.write({"MAE": 2.5})
    assert (tmp_path / "t" / "log.txt").read_text() == (tmp_path / "j" / "log.txt").read_text()
    assert not tmetrics.JsonlLogger(None).enabled
    with tmetrics.measure_time() as t:
        pass
    assert t.duration >= 0.0


def test_viz_outputs_match_jax(tmp_path):
    rng = np.random.default_rng(1)
    image = rng.uniform(0, 1, (384, 448, 3)).astype(np.float32)
    density = rng.uniform(0, 2, (384, 448)).astype(np.float32)
    gt_map = rng.uniform(0, 2, (384, 448)).astype(np.float32)
    rects = [[10, 20, 60, 80], [100, 0, 383, 447], [-3, 5, 20, 30]]
    np.testing.assert_array_equal(tviz.box_map((384, 448), rects), jviz.box_map((384, 448), rects))
    dens9 = [rng.uniform(0, 1, (128, 149)).astype(np.float32) for _ in range(9)]
    np.testing.assert_array_equal(tviz.make_grid(dens9, 384, 448), jviz.make_grid(dens9, 384, 448))
    boxes = rng.uniform(0, 1, (3, 64, 64, 3)).astype(np.float32)
    names, preds, gts = ["a.jpg", "b,c.jpg"], [3.4, 10.6], [3.0, 12.0]
    for mod, d in ((tviz, "t"), (jviz, "j")):
        out = tmp_path / d
        mod.save_prediction_panel(str(out / "full.png"), image, density, gt_map, rects, 12.3, 11.0)
        mod.save_prediction_panel(str(out / "pred.png"), image, density, None, rects, 12.3)
        mod.save_exemplar_strip(str(out / "boxes.png"), boxes)
        mod.save_results(str(out), names, preds, gts)
    for f in ("full.png", "pred.png", "boxes.png"):
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "t" / f)),
                                      np.asarray(Image.open(tmp_path / "j" / f)))
    assert (tmp_path / "t" / "results.csv").read_text() == \
        (tmp_path / "j" / "results.csv").read_text()
    assert os.path.exists(tmp_path / "t" / "test_stat.png")


def test_meta_reads_classes(fsc_dir):  # noqa: F811
    meta = tfsc.FSC147Meta.load(fsc_dir)
    with open(os.path.join(fsc_dir, "annotation_FSC147_384.json")) as f:
        assert set(meta.annotations) == set(json.load(f))
    assert all(v == ["widget"] for v in meta.classes.values())
    assert meta.open_image(meta.splits["test"][0]).mode == "RGB"
