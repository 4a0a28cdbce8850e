"""The port's CARPK finetune CLI (countr_tpu_torch/cli/finetune_carpk.py,
device cpu) against the JAX package's (countr_tpu/cli/finetune_carpk.py)
on the CARPK tree of tests/test_carpk.py::carpk_dir (2 train PNGs at
720x1280): the tiny ``tiny384`` preset registered in both preset tables,
fp32, both sides from one reference-format ``.pth`` that the JAX package
writes from its parameters.

The host path and ``--resident_data``, 2 epochs of ``--limit_steps 2`` at
batch 1: the per-epoch train/loss and train/MAE within rel 1e-5 (the
samples, their order and the exemplar draws are equal bit for bit, and no
random draw of the step differs: CARPK's loss is unmasked, loss_mask_p 1.0
in the program itself), and ``ckpt_last`` written. ``--n_devices 2`` at
the default batch 1 raises: the global batch must split over the ranks.
"""

import argparse
import json
import os

import pytest

from countr_tpu import config as jcfg
from countr_tpu.cli import finetune_carpk as jcli
from countr_tpu.engine import checkpoint as jckpt
from countr_tpu_torch import config as tcfg
from countr_tpu_torch.cli import finetune_carpk as tcli
from tests.test_carpk import carpk_dir  # noqa: F401  (fixture)
from tests.torch_port_helpers import jax_model

TINY384 = dict(img_size=384, patch_size=16, embed_dim=32, depth=1, num_heads=2,
               decoder_embed_dim=32, decoder_depth=1, decoder_num_heads=2, head_width=32)
REL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def tiny_preset():
    jcfg.COUNTR_PRESETS["tiny384"] = jcfg.CounTRConfig(**TINY384)
    tcfg.COUNTR_PRESETS["tiny384"] = tcfg.CounTRConfig(**TINY384)
    yield
    jcfg.COUNTR_PRESETS.pop("tiny384", None)
    tcfg.COUNTR_PRESETS.pop("tiny384", None)


@pytest.fixture(scope="module")
def pth(tmp_path_factory):
    _, params = jax_model(seed=11, jit=True, **TINY384)
    path = str(tmp_path_factory.mktemp("weights") / "tiny384.pth")
    jckpt.save_torch_checkpoint(path, jckpt.export_countr_state_dict(params))
    return path


def port_argv(root, pth, out, *extra):
    return ["--carpk_root", root, "--model", "tiny384", "--resume", pth, "--dtype", "fp32",
            "--device", "cpu", "--batch_size", "1", "--epochs", "2", "--warmup_epochs", "0",
            "--limit_steps", "2", "--num_workers", "2", "--output_dir", out, *extra]


def read_log(out):
    with open(os.path.join(out, "log.txt")) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("resident", [False, True], ids=["host", "resident"])
def test_cli_matches_jax(carpk_dir, pth, tmp_path, resident):  # noqa: F811
    jout, tout = str(tmp_path / "j"), str(tmp_path / "t")
    jcli.main(argparse.Namespace(
        model="tiny384", resume=pth, dtype="fp32", seed=0, carpk_root=carpk_dir,
        output_dir=jout, batch_size=1, epochs=2, warmup_epochs=0, blr=2e-4, lr=None,
        weight_decay=0.05, accum_iter=1, num_workers=2, limit_steps=2, n_devices=1,
        resident_data=resident))
    want = read_log(jout)
    got = tcli.main(tcli.get_args(port_argv(carpk_dir, pth, tout,
                                            *(["--resident_data"] * resident))))
    assert got == read_log(tout)
    assert [s["epoch"] for s in got] == [s["epoch"] for s in want] == [0, 1]
    for g, w in zip(got, want):
        for k in ("train/loss", "train/MAE"):
            assert g[k] == pytest.approx(w[k], rel=REL), (g["epoch"], k, g[k], w[k])
    assert got[1]["train/loss"] != got[0]["train/loss"]
    assert os.listdir(os.path.join(tout, "ckpt_last"))


def test_unported_devices_raise(carpk_dir, pth, tmp_path):  # noqa: F811
    with pytest.raises(ValueError, match="divisible"):
        tcli.main(tcli.get_args(port_argv(carpk_dir, pth, str(tmp_path / "o"),
                                          "--n_devices", "2")))
