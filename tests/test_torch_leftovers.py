"""The port's last library surfaces against the JAX package's, on the CPU:
``cli.aggregate`` (logs.csv byte for byte, the plot where matplotlib
imports), the four ``utils/viz.py`` writers (JSON equal; the video's
return and decoded frames), ``interpolate_pos_embed`` (within 1e-6) and
``resize_bilinear`` (within 1e-5) at the shapes of tests/test_posembed.py
and tests/test_ops_vs_torch.py, ``PhaseTimers`` and ``annotate``,
``SmoothedValue`` / ``MetricLogger``, ``WandbWriter`` against a fake
``wandb`` module, ``TestConfig``, ``CarpkHub`` and ``load_carpk`` against
the mocked Deep Lake client of tests/test_carpk.py (imported from there),
the package's lazy names, ``entry(device="cpu")`` against the model's own
forward, and ``dryrun_multichip(2)`` on two gloo ranks."""

import dataclasses
import json
import os
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from countr_tpu import config as jcfg
from countr_tpu.cli import aggregate as jagg
from countr_tpu.data import carpk as jcarpk
from countr_tpu.ops import posembed as jpos
from countr_tpu.ops import upsample as jup
from countr_tpu.utils import metrics as jmetrics
from countr_tpu.utils import profiling as jprof
from countr_tpu.utils import viz as jviz
from countr_tpu_torch import config as tcfg
from countr_tpu_torch.cli import aggregate as tagg
from countr_tpu_torch.data import carpk as tcarpk
from countr_tpu_torch.ops import posembed as tpos
from countr_tpu_torch.ops import upsample as tup
from countr_tpu_torch.utils import metrics as tmetrics
from countr_tpu_torch.utils import profiling as tprof
from countr_tpu_torch.utils import viz as tviz
from tests.test_carpk import _FakeHubDataset, _FakeHubItem
from tests import torch_port_helpers  # noqa: F401  (one intra-op thread)


def suite(root, runs):
    """A suite directory: one run directory per (name, lines) with a
    JSON-lines log.txt, plus a directory without one."""
    for name, lines in runs:
        d = root / name
        d.mkdir(parents=True)
        with open(d / "log.txt", "w") as f:
            for rec in lines:
                f.write(json.dumps(rec) + "\n")
            f.write("\nnot json\n")
    (root / "not_a_run").mkdir(parents=True)
    return str(root)


RUNS = [("run_b", [{"MAE": 5.0, "RMSE": 8.0, "NAE": 0.25, "note": "text"},
                   {"MAE": 7.5, "RMSE": 9.0, "NAE": 0.5, "flag": True, "n": 3}]),
        ("run_a", [{"MAE": 10.0, "RMSE": 20.0, "NAE": 0.1, "extra": 1},
                   {"MAE": 12.0, "RMSE": 22.0, "NAE": 0.3}]),
        ("run_c", [{"epoch": 0, "train/loss": 0.5}])]


def test_aggregate_csv_matches_jax(tmp_path):
    j, t = suite(tmp_path / "j", RUNS), suite(tmp_path / "t", RUNS)
    assert tagg.log_test_results(t) == jagg.log_test_results(j)
    with open(os.path.join(t, "logs.csv"), "rb") as a, open(os.path.join(j, "logs.csv"), "rb") as b:
        assert a.read() == b.read()


def test_aggregate_plot_and_main(tmp_path, capsys):
    t = suite(tmp_path / "t", RUNS)
    j = suite(tmp_path / "j", RUNS)
    got, want = tagg.plot_test_results(t), jagg.plot_test_results(j)
    assert (got is None) == (want is None)
    if got is not None:  # matplotlib imports
        assert os.path.basename(got) == os.path.basename(want) == "plot.jpeg"
        assert np.asarray(Image.open(got)).shape == np.asarray(Image.open(want)).shape
    capsys.readouterr()
    tagg.main(tagg.get_args([t, "--no_plot"]))
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("aggregated 3 runs")
    assert lines[1:] == ["  run_a: MAE 11.00 RMSE 21.00", "  run_b: MAE 6.25 RMSE 8.50",
                         "  run_c: MAE - RMSE -"]
    assert not hasattr(tagg.get_args([t]), "device")


def test_frames_to_video_matches_jax(tmp_path):
    import cv2

    rng = np.random.default_rng(0)
    fdir = tmp_path / "frames"
    fdir.mkdir()
    for i, (h, w) in enumerate([(64, 80), (64, 80), (48, 40)]):  # the last is resized
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(fdir / f"f{i}.png")
    (fdir / "notes.txt").write_text("skipped")

    def frames(path):
        cap, out = cv2.VideoCapture(path), []
        ok, f = cap.read()
        while ok:
            out.append(f)
            ok, f = cap.read()
        cap.release()
        return out

    a, b = str(tmp_path / "t.mp4"), str(tmp_path / "j.mp4")
    assert tviz.frames_to_video(str(fdir), a, fps=10) == jviz.frames_to_video(str(fdir), b,
                                                                              fps=10) is True
    fa, fb = frames(a), frames(b)
    assert len(fa) == len(fb) == 3
    for x, y in zip(fa, fb):
        np.testing.assert_array_equal(x, y)
    empty = tmp_path / "empty"
    empty.mkdir()
    assert tviz.frames_to_video(str(empty), a) is jviz.frames_to_video(str(empty), b) is False


def test_zeroshot_annotations_match_jax(tmp_path):
    for side in ("t", "j"):
        (tmp_path / side / "images").mkdir(parents=True)
        for n in ("b.jpg", "a.png"):
            (tmp_path / side / "images" / n).write_bytes(b"x")
    tviz.write_zeroshot_annotations(str(tmp_path / "t"), h=96, w=128)
    jviz.write_zeroshot_annotations(str(tmp_path / "j"), h=96, w=128)
    for f in ("annotations.json", "split.json"):
        assert (tmp_path / "t" / f).read_bytes() == (tmp_path / "j" / f).read_bytes()
    assert json.loads((tmp_path / "t" / "split.json").read_text()) == {"test": ["a.png", "b.jpg"]}


def test_annotations_gt_match_jax(tmp_path):
    old = tmp_path / "old.json"
    old.write_text(json.dumps({n: {"H": 96, "W": 128, "box_examples_coordinates": [],
                                   "points": []} for n in ("a.jpg", "b.jpg")}))
    csv_path = tmp_path / "gt.csv"
    csv_path.write_text(
        "filename,region_shape_attributes\n"
        'a.jpg,"{""name"": ""point"", ""cx"": 10, ""cy"": 20}"\n'
        'b.jpg,"{""name"": ""rect"", ""x"": 1}"\n'
        'a.jpg,"{""name"": ""point"", ""cx"": 30.5, ""cy"": 40}"\n')
    tviz.write_annotations_gt(str(old), str(tmp_path / "t.json"), str(csv_path))
    jviz.write_annotations_gt(str(old), str(tmp_path / "j.json"), str(csv_path))
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    assert json.loads((tmp_path / "t.json").read_text())["a.jpg"]["points"] == [[10, 20],
                                                                                  [30.5, 40]]


@pytest.mark.parametrize("threshold", [0.1, 2.0])
def test_predicted_points_match_jax(tmp_path, threshold):
    rng = np.random.default_rng(1)
    density = np.zeros((120, 90), np.float32)
    for y, x in rng.integers(5, 85, (12, 2)):
        density[y, x] += rng.uniform(0.5, 6.0)
    density += rng.uniform(0, 0.05, density.shape).astype(np.float32)
    a, b = tmp_path / "t" / "p.json", tmp_path / "j" / "p.json"
    tviz.write_predicted_points(str(a), "img.jpg", density, threshold=threshold)
    jviz.write_predicted_points(str(b), "img.jpg", density, threshold=threshold)
    assert json.loads(a.read_text()) == json.loads(b.read_text())
    assert a.read_bytes() == b.read_bytes()


@pytest.mark.parametrize("extra,orig,new", [(1, 14, 24), (0, 24, 16), (0, 12, 12)])
def test_interpolate_pos_embed_matches_jax(extra, orig, new):
    rng = np.random.default_rng(0)
    pos = rng.normal(size=(1, extra + orig * orig, 32)).astype(np.float32)
    got = tpos.interpolate_pos_embed(pos, new, num_extra_tokens=extra)
    want = jpos.interpolate_pos_embed(pos, new, num_extra_tokens=extra)
    assert got.shape == want.shape == (1, extra + new * new, 32) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(tpos.interpolate_pos_embed(pos[0], new, extra), got[0], atol=1e-7)
    with pytest.raises(ValueError, match="not square"):
        tpos.interpolate_pos_embed(pos[:, :-1], new, extra)


@pytest.mark.parametrize("src,dst", [((128, 96), (384, 512)), ((64, 64), (384, 384)),
                                     ((384, 512), (96, 200))])
def test_resize_bilinear_matches_jax(src, dst):
    x = np.random.default_rng(2).standard_normal((2, *src, 3)).astype(np.float32)
    want = np.asarray(jup.resize_bilinear(jnp.asarray(x), *dst))
    got = tup.resize_bilinear(torch.from_numpy(x), *dst)
    assert got.shape == (2, *dst, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    assert tup.resize_bilinear(torch.from_numpy(x).bfloat16(), *dst).dtype == torch.bfloat16


def test_phase_timers_and_annotate():
    t, j = tprof.PhaseTimers(), jprof.PhaseTimers()
    for timers in (t, j):
        for name, n in (("load", 3), ("infer", 2)):
            for _ in range(n):
                with timers.phase(name):
                    pass
        with pytest.raises(KeyError), timers.phase("fail"):
            raise KeyError("a phase that raises still counts")
    assert t.counts == j.counts == {"load": 3, "infer": 2, "fail": 1}
    assert list(t.means()) == list(j.means()) == ["Mean load time", "Mean infer time",
                                                  "Mean fail time"]
    for k, v in t.means().items():
        assert v == pytest.approx(t.totals[k.split()[1]] / t.counts[k.split()[1]])
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tprof.annotate("countr_span"):
            torch.ones(4).sum()
    assert "countr_span" in {e.name for e in prof.events()}


def test_smoothed_value_and_metric_logger(capsys):
    vals = [3.0, 1.0, 4.0, 1.0, 5.0, 9.0, 2.0]
    t, j = tmetrics.SmoothedValue(window=4), jmetrics.SmoothedValue(window=4)
    for k, v in enumerate(vals):
        t.update(v, n=k % 2 + 1)
        j.update(v, n=k % 2 + 1)
    assert (t.avg, t.global_avg, list(t.deque)) == (j.avg, j.global_avg, list(j.deque))
    outs = []
    for logger in (tmetrics.MetricLogger(), jmetrics.MetricLogger()):
        logger.update(loss=0.5, mae=np.float32(2.0))
        logger.update(loss=1.5)
        assert list(logger.log_every(range(5), 2, header="ep")) == list(range(5))
        outs.append((str(logger), [ln.split("iter_time")[0]
                                   for ln in capsys.readouterr().out.splitlines()]))
    assert outs[0] == outs[1]
    assert outs[0][0] == "loss: 1.0000 (1.0000)  mae: 2.0000 (2.0000)"


def fake_wandb(calls):
    """A ``wandb`` module that records what a run receives."""
    mod = types.ModuleType("wandb")

    class Run:
        def log(self, record, step=None):
            calls.append(("log", dict(record), step))

        def log_artifact(self, art):
            calls.append(("artifact", art.name, art.type, art.items))

        def finish(self):
            calls.append(("finish",))

    class Artifact:
        def __init__(self, name, type):
            self.name, self.type, self.items = name, type, []

        def add_dir(self, p):
            self.items.append(("dir", os.path.basename(p)))

        def add_file(self, p):
            self.items.append(("file", os.path.basename(p)))

    def init(**kw):
        calls.append(("init", kw))
        return Run()

    mod.init, mod.Artifact = init, Artifact
    mod.Image = lambda img: ("Image", np.asarray(img).shape)
    return mod


def test_wandb_writer_matches_jax(tmp_path, monkeypatch):
    f = tmp_path / "ckpt.pth"
    f.write_bytes(b"x")
    got = {}
    for name, cls in (("t", tmetrics.WandbWriter), ("j", jmetrics.WandbWriter)):
        calls = got[name] = []
        monkeypatch.setitem(sys.modules, "wandb", fake_wandb(calls))
        w = cls("proj", run_name="title", config={"a": 1}, team="team", run_id="abc")
        w.log({"x": 1.0}, step=3)
        w.image("val/p", np.zeros((4, 6, 3)), step=3)
        w.log_artifact(str(tmp_path), "dir_art")
        w.log_artifact(str(f), "file_art", kind="data")
        w.finish()
    assert got["t"] == got["j"]
    assert got["t"][0] == ("init", dict(project="proj", name="title", config={"a": 1},
                                        entity="team", id="abc", resume="allow"))
    monkeypatch.delitem(sys.modules, "wandb")
    for args in ((None,), ("proj",)):  # no project; no client (import fails)
        monkeypatch.setitem(sys.modules, "wandb", None)
        w = tmetrics.WandbWriter(*args)
        assert not w.enabled
        w.log({"x": 1}), w.image("t", np.zeros((2, 2, 3))), w.log_artifact("p", "n"), w.finish()


def test_tb_writer_without_log_dir_is_a_no_op():
    w = tmetrics.TBWriter(None)
    assert not w.enabled
    w.scalar("a", 1.0, 0), w.image("b", np.zeros((2, 2, 3)), 0), w.flush()


def test_test_config_matches_jax():
    t = [(f.name, f.default) for f in dataclasses.fields(tcfg.TestConfig)]
    j = [(f.name, f.default) for f in dataclasses.fields(jcfg.TestConfig)]
    assert t == j


def test_carpk_hub_matches_jax(monkeypatch):
    rng = np.random.default_rng(3)
    items = [_FakeHubItem(rng, 10), _FakeHubItem(rng, 7)]
    urls = []
    fake_hub = types.ModuleType("hub")

    def load(url):
        urls.append(url)
        return _FakeHubDataset(items)

    fake_hub.load = load
    monkeypatch.setitem(sys.modules, "hub", fake_hub)
    t, j = tcarpk.CarpkHub("train"), jcarpk.CarpkHub("train")
    assert urls == ["hub://activeloop/carpk-train"] * 2
    assert len(t) == len(j) == 2
    for i in range(2):
        a, b = t[i], j[i]
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert type(a[k]) is type(b[k]) and np.asarray(a[k]).dtype == np.asarray(b[k]).dtype
    via = tcarpk.load_carpk("test")
    assert urls[-1] == "hub://activeloop/carpk-test" and isinstance(via, tcarpk.CarpkHub)
    sample = tcarpk.carpk_train_sample(np.random.default_rng(1), t[0])
    want = jcarpk.carpk_train_sample(np.random.default_rng(1), j[0])
    for k in ("image", "gt_density", "boxes"):
        np.testing.assert_array_equal(sample[k], want[k], err_msg=k)


def test_load_carpk_without_hub_exits(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "hub", None)  # import hub raises ImportError
    with pytest.raises(SystemExit, match="carpk_root"):
        tcarpk.load_carpk("train")
    with pytest.raises(SystemExit, match="carpk_root"):
        jcarpk.load_carpk("train")
    (tmp_path / "Images").mkdir()
    assert isinstance(tcarpk.load_carpk("train", str(tmp_path)), tcarpk.CarpkLocal)


def test_lazy_package_names():
    import countr_tpu_torch
    from countr_tpu_torch.engine.inference import CountingEngine, count_image
    from countr_tpu_torch.models import build_countr, build_mae

    assert countr_tpu_torch.CountingEngine is CountingEngine
    assert countr_tpu_torch.count_image is count_image
    assert countr_tpu_torch.build_countr is build_countr
    assert countr_tpu_torch.build_mae is build_mae
    with pytest.raises(AttributeError, match="no attribute"):
        countr_tpu_torch.not_a_name  # noqa: B018


def test_entry_on_cpu_equals_the_models_forward():
    from countr_tpu_torch.entry import ENTRY_MODEL, entry
    from countr_tpu_torch.ops.launches import launch_counts

    fn, args = entry(device="cpu")
    assert [tuple(a.shape) for a in args] == [(1, 384, 384, 3), (1, 3, 64, 64, 3)]
    model = fn.model
    assert model.cfg == tcfg.COUNTR_PRESETS[ENTRY_MODEL].__class__(
        **{**dataclasses.asdict(tcfg.COUNTR_PRESETS[ENTRY_MODEL]),
           **tcfg.fast_mode_overrides("bf16")})
    assert next(model.parameters()).device.type == "cpu"
    before = launch_counts()
    out = fn(*args)
    assert launch_counts() == before  # on the CPU the wrappers take their plain versions
    assert out.shape == (1, 384, 384) and bool(torch.isfinite(out).all())
    with torch.inference_mode():
        want = model(*args, 3)
    assert torch.equal(out, want)


def test_dryrun_multichip_two_ranks():
    from countr_tpu_torch.entry import dryrun_multichip

    out = dryrun_multichip(2)
    assert out["world"] == 2 and out["updates"] == 2 and np.isfinite(out["loss"])
