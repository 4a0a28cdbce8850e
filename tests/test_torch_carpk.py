"""The port's CARPK path against the JAX package's: the local dataset,
``carpk_test_sample`` and ``carpk_postprocess`` bitwise (the same cv2 and
numpy calls), and ``cli.test_carpk`` (device="cpu") against JAX's CLI on
the same synthetic local CARPK tree and the same ``.pth`` (the JAX
package writes it; tiny ``tiny384`` preset, fp32): the per-image
densities' postprocessed counts and the MAE within 1e-4."""

import sys

import numpy as np
import pytest
from PIL import Image

from countr_tpu import config as jcfg
from countr_tpu.cli import test_carpk as jcli
from countr_tpu.data import carpk as jcarpk
from countr_tpu.engine import checkpoint as jckpt
from countr_tpu.engine import inference as jinf
from countr_tpu_torch import config as tcfg
from countr_tpu_torch.cli import test_carpk as tcli
from countr_tpu_torch.data import carpk as tcarpk
from countr_tpu_torch.engine import inference as tinf
from tests.test_torch_cli import TINY384, record
from tests.torch_port_helpers import jax_model


@pytest.fixture(scope="module", autouse=True)
def tiny_preset():
    jcfg.COUNTR_PRESETS["tiny384"] = jcfg.CounTRConfig(**TINY384)
    tcfg.COUNTR_PRESETS["tiny384"] = tcfg.CounTRConfig(**TINY384)
    yield
    jcfg.COUNTR_PRESETS.pop("tiny384", None)
    tcfg.COUNTR_PRESETS.pop("tiny384", None)


def write_carpk_tree(root, sizes, seed=0, n_boxes=(5, 40)):
    """A local CARPK tree: PNGs under Images/, "x1 y1 x2 y2 1" lines under
    Annotations/, car-sized boxes."""
    rng = np.random.default_rng(seed)
    (root / "Images").mkdir(parents=True)
    (root / "Annotations").mkdir()
    for i, (h, w) in enumerate(sizes):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            root / "Images" / f"c_{i}.png")
        lines = []
        for _ in range(int(rng.integers(*n_boxes))):
            x1, y1 = rng.integers(0, w - 50), rng.integers(0, h - 50)
            bw, bh = rng.integers(20, 45, 2)
            lines.append(f"{x1} {y1} {x1 + bw} {y1 + bh} 1")
        (root / "Annotations" / f"c_{i}.txt").write_text("\n".join(lines) + "\n")
    return str(root)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_carpk_tree(tmp_path_factory.mktemp("carpk"), [(720, 1280), (360, 640)])


@pytest.fixture(scope="module")
def pth(tmp_path_factory):
    _, params = jax_model(seed=11, jit=True, **TINY384)
    path = str(tmp_path_factory.mktemp("w") / "tiny384.pth")
    jckpt.save_torch_checkpoint(path, jckpt.export_countr_state_dict(params))
    return path


def test_dataset_and_sample_bitwise(tree):
    tds, jds = tcarpk.load_carpk("test", tree), jcarpk.load_carpk("test", tree)
    assert tds.ids == jds.ids and len(tds) == 2
    for i in range(len(tds)):
        t, j = tds[i], jds[i]
        np.testing.assert_array_equal(t["image"], j["image"])
        np.testing.assert_array_equal(t["boxes_xywh"], j["boxes_xywh"])
        assert t["count"] == j["count"] and t["name"] == j["name"]
        ts, js = tcarpk.carpk_test_sample(t), jcarpk.carpk_test_sample(j)
        assert ts["image"].shape == (384, 683, 3)
        for k in ("image", "boxes", "pos"):
            np.testing.assert_array_equal(ts[k], js[k])
        assert ts["count"] == js["count"]
    with pytest.raises(SystemExit, match="carpk_root"):
        tcarpk.load_carpk("test", "")


@pytest.mark.parametrize("scale", [0.01, 0.2, 3.0])
def test_postprocess_bitwise(scale):
    """Low densities take the +2 correction, high ones the per-cell
    decrement."""
    rng = np.random.default_rng(int(scale * 100))
    density = (rng.uniform(0, 1, (384, 683)) * scale).astype(np.float32)
    pos = np.asarray([[10, 20, 30, 40], [100, 200, 25, 35]], np.float32)
    got = tcarpk.carpk_postprocess(density, pos)
    assert got == jcarpk.carpk_postprocess(density, pos)
    assert np.isfinite(got)


def test_cli_test_carpk_matches_jax(monkeypatch, tree, pth, tmp_path):
    argv = ["--carpk_root", tree, "--model", "tiny384", "--resume", pth, "--dtype", "fp32",
            "--batch_windows", "4", "--batch_images", "2"]
    want = record(monkeypatch, jinf.CountingEngine)
    monkeypatch.setattr(sys, "argv", ["test_carpk", *argv, "--output_dir", str(tmp_path / "j")])
    jstats = jcli.main(jcli.get_args())
    got = record(monkeypatch, tinf.CountingEngine)
    tstats = tcli.main(tcli.get_args(argv + ["--output_dir", str(tmp_path / "t"),
                                             "--device", "cpu"]))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.n_windows == w.n_windows == 4
        assert g.e_cnt == w.e_cnt == 0.0  # no TTN on CARPK
        np.testing.assert_allclose(g.density, w.density, atol=1e-4, rtol=1e-3)
    for key in ("MAE", "RMSE"):
        assert np.isfinite(tstats[key])
        assert tstats[key] == pytest.approx(jstats[key], rel=1e-4, abs=1e-4), key
    with pytest.raises(SystemExit) as e:
        tcli.main(tcli.get_args(argv + ["--output_dir", "", "--device", "cpu", "--limit", "1",
                                        "--expect_mae", "0"]))
    assert e.value.code == 3
