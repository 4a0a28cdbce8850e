"""Boundaries of the port package countr_tpu_torch: it imports neither
JAX nor the JAX package (its data-parallel modules ``parallel.dist`` and
``parallel.mesh``, and the host-only ``cli.aggregate``, ``utils.viz`` and
``entry`` included), its entry points (the CLIs' --device and their
``--n_devices`` ranks, and ``entry.entry``, too) default to the CUDA card
and raise without one, its stitch geometry equals the JAX package's, and
no file of it calls a library attention kernel or torch.compile."""

import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import countr_tpu_torch
from countr_tpu.engine import stitch as jstitch
from countr_tpu_torch.engine import stitch as tstitch

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "countr_tpu_torch"


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages([str(PKG)], "countr_tpu_torch."))


def test_imports_no_jax():
    mods = _modules()
    for m in ("engine.inference", "native", "data.imcache", "data.loader", "data.fsc147",
              "ops.augment", "cli.finetune", "engine.train_store", "engine.carpk_store",
              "cli.finetune_carpk", "cli.pretrain", "parallel.dist", "parallel.mesh",
              "cli.aggregate", "entry", "utils.metrics", "utils.viz", "utils.profiling",
              "ops.posembed", "ops.upsample", "data.carpk", "config"):
        assert f"countr_tpu_torch.{m}" in mods, m
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'countr_tpu', 'flax'))\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, check=True, timeout=120)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is valid here")
    from countr_tpu_torch.engine.inference import CountingEngine
    from countr_tpu_torch.models import build_countr

    with pytest.raises(RuntimeError, match="CUDA"):
        build_countr("mae_vit_base6_patch16", embed_dim=32, depth=1, num_heads=2,
                     decoder_embed_dim=32, decoder_depth=1, decoder_num_heads=2,
                     head_width=8)
    model = build_countr("mae_vit_base6_patch16", device="cpu", embed_dim=32, depth=1,
                         num_heads=2, decoder_embed_dim=32, decoder_depth=1,
                         decoder_num_heads=2, head_width=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        CountingEngine(model)
    from countr_tpu_torch.cli import (
        common, demo, finetune, finetune_carpk, pretrain, serve, test, test_carpk,
    )

    for args in (test.get_args([]), serve.get_args([]), test_carpk.get_args([]),
                 demo.get_args(["--input_path", "x.jpg"]), finetune.get_args([]),
                 finetune_carpk.get_args([])):
        assert args.device == "cuda"
        with pytest.raises(RuntimeError, match="CUDA"):
            common.build_counting_model(args)
    with pytest.raises(RuntimeError, match="CUDA"):
        common.build_counting_model(finetune.get_args([]), training=True)
    args = pretrain.get_args([])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        pretrain.build_mae_model(args)
    # data-parallel ranks default to the cards too: none visible, none started
    from countr_tpu_torch.parallel.mesh import get_mesh

    for cli in (finetune, finetune_carpk, pretrain):
        with pytest.raises(ValueError, match="0 CUDA device"):
            cli.main(cli.get_args(["--n_devices", "2", "--batch_size", "2"]))
    with pytest.raises(ValueError, match="0 CUDA device"):
        get_mesh(2)


def test_entry_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is valid here")
    import inspect

    from countr_tpu_torch.entry import entry

    assert inspect.signature(entry).parameters["device"].default is None
    with pytest.raises(RuntimeError, match="CUDA"):
        entry()


def test_engine_rejects_bad_input():
    from countr_tpu_torch.engine.inference import CountingEngine
    from countr_tpu_torch.models import build_countr

    model = build_countr("mae_vit_base6_patch16", device="cpu", embed_dim=32, depth=1,
                         num_heads=2, decoder_embed_dim=32, decoder_depth=1,
                         decoder_num_heads=2, head_width=8)
    with pytest.raises(ValueError, match="narrow_policy"):
        CountingEngine(model, narrow_policy="crop", device="cpu")
    engine = CountingEngine(model, device="cpu")
    with pytest.raises(ValueError, match="H=384"):
        engine.count(np.zeros((200, 400, 3), np.uint8))
    with pytest.raises(ValueError, match="exemplar crops"):
        engine.count(np.zeros((384, 400, 3), np.uint8), np.zeros((2, 64, 64, 3)), shot_num=3)


@pytest.mark.parametrize("word", ["scaled_dot_product_attention", "torch.compile"])
def test_no_library_attention_or_compile(word):
    files = [p for p in PKG.rglob("*") if p.suffix in (".py", ".cu", ".cuh")]
    assert files
    hits = [str(p) for p in files if word in p.read_text()]
    assert not hits, hits


@pytest.mark.parametrize("w", [384, 400, 600, 1000, 1392])
def test_stitch_geometry_matches_jax(w):
    assert tstitch.window_starts(w) == jstitch.window_starts(w)
    ts, tw = tstitch.stitch_weights(w)
    js, jw = jstitch.stitch_weights(w)
    assert ts == js
    np.testing.assert_array_equal(tw, jw)
    for src in (w // 3, 128):
        for a, b in zip(tstitch.resample_maps(src, w, 7), jstitch.resample_maps(src, w, 7)):
            np.testing.assert_array_equal(a, b)
    assert tstitch.grid_crop_boxes(384, w) == jstitch.grid_crop_boxes(384, w)


def test_config_constants_match_jax():
    from countr_tpu import config as jcfg
    from countr_tpu_torch import config as tcfg

    for name in ("DENSITY_SCALE", "IMG_SIZE", "PATCH_SIZE", "WINDOW", "STRIDE",
                 "TTN_THRESHOLD"):
        assert getattr(tcfg, name) == getattr(jcfg, name), name
    assert sorted(tcfg.COUNTR_PRESETS) == sorted(jcfg.COUNTR_PRESETS)
    for k, c in tcfg.COUNTR_PRESETS.items():
        j = jcfg.COUNTR_PRESETS[k]
        for f in ("embed_dim", "depth", "num_heads", "decoder_embed_dim",
                  "decoder_depth", "decoder_num_heads", "patch_size", "img_size"):
            assert getattr(c, f) == getattr(j, f), (k, f)
    assert countr_tpu_torch.resolve_device("cpu").type == "cpu"


def test_packaging_names_the_ports_files():
    """Every console script of the port resolves, the pretrain CLI has one,
    and the package data covers every CUDA source and header the kernels
    build from."""
    import fnmatch
    import importlib
    import tomllib

    conf = tomllib.loads((ROOT / "pyproject.toml").read_text())
    scripts = {k: v for k, v in conf["project"]["scripts"].items() if "countr_tpu_torch" in v}
    assert "countr-torch-pretrain" in scripts
    for name, target in scripts.items():
        mod, fn = target.split(":")
        assert callable(getattr(importlib.import_module(mod), fn)), name
    globs = conf["tool"]["setuptools"]["package-data"]["countr_tpu_torch"]
    sources = sorted(p.relative_to(PKG).as_posix() for p in (PKG / "csrc").iterdir())
    assert any(s.endswith(".cuh") for s in sources)
    for s in sources:
        assert any(fnmatch.fnmatch(s, g) for g in globs), s
