"""The port's inference CLIs (device="cpu") against the JAX package's on
the same synthetic FSC147 tree and the same weights: a ``.pth`` that the
JAX package writes (``export_countr_state_dict`` +
``save_torch_checkpoint``) and both CLIs load through ``--resume``, the
tiny ``tiny384`` preset registered in both preset tables, fp32.

- ``cli.test`` few-shot (one image in 3x3 grid mode), zero-shot
  (``--box_bound 0``) and ``--external``: each image's count within 1e-4
  relative (the tolerance of tests/test_torch_count_batch.py:72), MAE and
  RMSE likewise; the acceptance gate's exit code;
- the demo and ``count_image`` against JAX's ``count_image``;
- the ``mixed``, ``mixed_fast`` and ``mixed_bal`` builds against JAX's
  on one window: the density within tests/test_torch_model_bf16.py's
  bound, 2.2e-2·max(1, peak); their config and head-stage dtypes equal
  to JAX's ``parse_head_stage_dtypes``, through ``fast_mode_overrides``.
"""

import json
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from countr_tpu import config as jcfg
from countr_tpu.cli import common as jcommon
from countr_tpu.cli import test as jtest
from countr_tpu.engine import checkpoint as jckpt
from countr_tpu.engine import inference as jinf
from countr_tpu_torch import config as tcfg
from countr_tpu_torch.cli import common as tcommon
from countr_tpu_torch.config import fast_mode_overrides
from countr_tpu_torch.cli import demo as tdemo
from countr_tpu_torch.cli import test as ttest
from countr_tpu_torch.engine import inference as tinf
from tests.torch_port_helpers import jax_model

TINY384 = dict(img_size=384, patch_size=16, embed_dim=32, depth=1, num_heads=2,
               decoder_embed_dim=32, decoder_depth=1, decoder_num_heads=2, head_width=32)
BF16_REL = 2.2e-2  # docs/PARITY.md:235, times max(1, peak)


@pytest.fixture(scope="module", autouse=True)
def tiny_preset():
    jcfg.COUNTR_PRESETS["tiny384"] = jcfg.CounTRConfig(**TINY384)
    tcfg.COUNTR_PRESETS["tiny384"] = tcfg.CounTRConfig(**TINY384)
    yield
    jcfg.COUNTR_PRESETS.pop("tiny384", None)
    tcfg.COUNTR_PRESETS.pop("tiny384", None)


@pytest.fixture(scope="module")
def pth(tmp_path_factory):
    """The JAX package's params of tiny384 (randomised beyond the init) as
    a reference-format .pth, written by the JAX package."""
    _, params = jax_model(seed=7, jit=True, **TINY384)
    path = str(tmp_path_factory.mktemp("weights") / "tiny384.pth")
    jckpt.save_torch_checkpoint(path, jckpt.export_countr_state_dict(params))
    return path


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A synthetic FSC147 tree: four test images of other sizes (one with
    exemplars under 10 px after the resize: 3x3 grid mode)."""
    root = tmp_path_factory.mktemp("fsc_cli")
    imdir = root / "images_384_VarV2"
    imdir.mkdir()
    rng = np.random.default_rng(5)
    anno, ids = {}, []
    for i, ((h, w), side) in enumerate([((384, 512), 40), ((400, 700), 30), ((300, 300), 50),
                                         ((384, 448), 6)]):
        im_id = f"t_{i}.jpg"
        ids.append(im_id)
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(imdir / im_id)
        boxes = []
        for _ in range(3):
            x1, y1 = rng.uniform(0, w - side - 1), rng.uniform(0, h - side - 1)
            boxes.append([[x1, y1], [x1, y1 + side], [x1 + side, y1 + side], [x1 + side, y1]])
        anno[im_id] = {"points": np.stack([rng.uniform(0, w, 9 + i), rng.uniform(0, h, 9 + i)],
                                          1).tolist(),
                       "box_examples_coordinates": boxes}
    (root / "annotation_FSC147_384.json").write_text(json.dumps(anno))
    (root / "Train_Test_Val_FSC_147.json").write_text(
        json.dumps({"train": [], "val": [], "test": ids}))
    return str(root)


def record(monkeypatch, cls) -> list:
    """Every CountResult that ``cls.count_batch`` returns, in call order."""
    got = []
    orig = cls.count_batch

    def spy(self, images, boxes_list, rects_list, shot_num, return_density=True):
        res = orig(self, images, boxes_list, rects_list, shot_num=shot_num,
                   return_density=return_density)
        got.extend(res)
        return res

    monkeypatch.setattr(cls, "count_batch", spy)
    return got


def cli_argv(tree, pth, out, *extra):
    return ["--data_path", tree, "--model", "tiny384", "--resume", pth, "--dtype", "fp32",
            "--batch_windows", "4", "--batch_images", "3", "--output_dir", out, *extra]


MODES = {"few_shot": [], "zero_shot": ["--box_bound", "0"], "external": ["--external"]}


@pytest.mark.parametrize("mode", list(MODES))
def test_cli_test_matches_jax(monkeypatch, tree, pth, tmp_path, mode):
    argv = cli_argv(tree, pth, str(tmp_path / "j"), *MODES[mode])
    want = record(monkeypatch, jinf.CountingEngine)
    monkeypatch.setattr(sys, "argv", ["test", *argv, "--n_devices", "1"])
    jstats = jtest.main(jtest.get_args())
    got = record(monkeypatch, tinf.CountingEngine)
    out = str(tmp_path / "t")
    tstats = ttest.main(ttest.get_args(cli_argv(tree, pth, out, *MODES[mode], "--device", "cpu",
                                                "--save_viz")))
    assert len(got) == len(want) == 4
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.grid_mode == w.grid_mode and g.n_windows == w.n_windows, i
        for field in ("count", "raw_count", "e_cnt"):
            assert getattr(g, field) == pytest.approx(getattr(w, field), rel=1e-4, abs=1e-4), \
                (i, field)
    assert [g.grid_mode for g in got] == ([False, False, False, True] if mode == "few_shot"
                                          else [False] * 4)
    for key in ("MAE", "RMSE", "NAE"):
        assert tstats[key] == pytest.approx(jstats[key], rel=1e-4, abs=1e-4), key
    with open(f"{out}/results.csv") as f:
        assert f.readline().strip() == "time,name,prediction"
        assert len(f.readlines()) == 4
    assert json.loads(open(f"{out}/log.txt").read().splitlines()[-1])["MAE"] == tstats["MAE"]


def test_cli_test_gate(tree, pth, tmp_path, capsys):
    argv = cli_argv(tree, pth, str(tmp_path), "--device", "cpu", "--limit", "2")
    args = ttest.get_args(argv + ["--expect_mae", "0"])
    engine = tcommon.build_engine(args, normalization=True)
    with pytest.raises(SystemExit) as e:
        ttest.main(args, engine=engine)
    assert e.value.code == 1
    assert "ACCEPTANCE FAILURE: MAE" in capsys.readouterr().out
    stats = ttest.main(ttest.get_args(argv + ["--expect_mae", "1e9", "--expect_rmse", "1e9"]),
                       engine=engine)
    assert np.isfinite(stats["MAE"])
    assert "acceptance gate: PASS" in capsys.readouterr().out
    with pytest.raises(ValueError, match="not a multiple of the 3 devices"):
        tcommon.build_engine(ttest.get_args(argv + ["--n_devices", "3"]), normalization=True)


def _jax_engine(pth):
    import argparse

    args = argparse.Namespace(model="tiny384", resume=pth, dtype="fp32", seed=0)
    model, params = jcommon.build_counting_model(args)
    return jinf.CountingEngine(model, params, batch_windows=4)


def test_demo_and_count_image_match_jax(tree, pth, tmp_path):
    src = tmp_path / "imgs"
    src.mkdir()
    rng = np.random.default_rng(9)
    for name, (h, w) in (("a.png", (300, 500)), ("b.jpg", (600, 900))):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(src / name)
    jengine = _jax_engine(pth)
    boxes = "20,30,80,90;100,40,170,120;200,150,260,220"
    for spec in ("", boxes):
        out = tmp_path / f"out{len(spec)}"
        argv = ["--input_path", str(src), "--output_path", str(out), "--model", "tiny384",
                "--resume", pth, "--dtype", "fp32", "--batch_windows", "4", "--device", "cpu"]
        res = tdemo.main(tdemo.get_args(argv + (["--boxes", spec] if spec else [])))
        assert [n for n, _ in res] == ["a.png", "b.jpg"]
        xyxy = tdemo.parse_boxes(spec)
        for name, r in res:
            want = jinf.count_image(jengine, str(src / name), xyxy)
            assert r.count == pytest.approx(want.count, rel=1e-4, abs=1e-4), (spec, name)
            assert r.n_windows == want.n_windows
            stem = name.rsplit(".", 1)[0]
            assert (out / f"{stem}__{round(r.count)}.png").exists()
    tengine = tcommon.build_engine(ttest.get_args(cli_argv(tree, pth, "", "--device", "cpu")),
                                 normalization=True)
    img = rng.integers(0, 256, (420, 650, 3), dtype=np.uint8)
    for arg, xyxy in ((img, []), (img.astype(np.float32) / 255.0, [[30, 40, 90, 100]] * 2),
                      (Image.fromarray(img).convert("L"), [[5, 5, 11, 12]] * 3)):
        got, want = tinf.count_image(tengine, arg, xyxy), jinf.count_image(jengine, arg, xyxy)
        assert got.grid_mode == want.grid_mode and got.n_windows == want.n_windows
        for field in ("count", "raw_count", "e_cnt"):
            assert getattr(got, field) == pytest.approx(getattr(want, field), rel=1e-4, abs=1e-4)


def _name(d):
    return None if d is None else str(jnp.dtype(d)) if not isinstance(d, torch.dtype) \
        else str(d).removeprefix("torch.")


@pytest.mark.parametrize("mode", ["mixed", "mixed_fast", "mixed_bal"])
def test_mixed_builds_match_jax(pth, mode):
    import argparse

    over = fast_mode_overrides(mode)
    assert [_name(d) for d in over.get("head_stage_dtypes") or ()] == \
        [_name(d) for d in jcommon.parse_head_stage_dtypes(mode) or ()]
    assert _name(over.get("head_dtype")) == _name(jcommon.parse_head_dtype(mode))
    assert _name(over["dtype"]) == _name(jcommon.parse_dtype(mode))
    jmodel, params = jcommon.build_counting_model(
        argparse.Namespace(model="tiny384", resume=pth, dtype=mode, seed=0))
    tmodel = tcommon.build_counting_model(tcommon_args(pth, mode))
    jc, tc = jmodel.cfg, tmodel.cfg
    for f in ("use_pallas_attention", "fused_attn_block", "approx_gelu", "subpixel_head"):
        assert getattr(tc, f) == getattr(jc, f), f
    assert [_name(d) for d in tc.head_stage_dtypes or ()] == \
        [_name(d) for d in jc.head_stage_dtypes or ()]
    assert _name(tc.head_dtype) == _name(jc.head_dtype)
    want_head = ["bfloat16"] * 3 + ["float32"] * 2 if mode == "mixed_bal" else ["float32"] * 5
    assert [_name(d) for d in tc.head_dtypes] == want_head

    rng = np.random.default_rng(2)
    imgs = rng.uniform(0, 1, (1, 384, 384, 3)).astype(np.float32)
    boxes = rng.uniform(0, 1, (1, 3, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jmodel.apply(params, jnp.asarray(imgs), jnp.asarray(boxes), 3))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(imgs), torch.from_numpy(boxes), 3).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape == (1, 384, 384)
    lim = BF16_REL * max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= lim


def tcommon_args(pth, mode):
    return ttest.get_args(["--model", "tiny384", "--resume", pth, "--dtype", mode,
                           "--device", "cpu"])


def test_resume_from_port_checkpoint_dir(pth, tmp_path):
    """--resume of a directory restores the latest of the port's own
    checkpoints; an empty --resume gives the seed's random weights."""
    from countr_tpu_torch.engine.checkpoint import save_checkpoint

    model = tcommon.build_counting_model(tcommon_args(pth, "fp32"))
    save_checkpoint(str(tmp_path), 5, model)
    args = tcommon_args(pth, "fp32")
    args.resume = str(tmp_path)
    restored = tcommon.build_counting_model(args)
    for (k, a), b in zip(model.state_dict().items(), restored.state_dict().values()):
        assert torch.equal(a, b), k
    args.resume = ""
    fresh = tcommon.build_counting_model(args)
    assert not torch.equal(fresh.state_dict()["decoder_embed.weight"],
                           model.state_dict()["decoder_embed.weight"])
