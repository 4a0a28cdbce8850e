"""The logging surfaces of the port's training CLIs (countr_tpu_torch/cli/
finetune.py and pretrain.py, device cpu) against the JAX package's, on the
tree of tests/test_data.py::fsc_dir with tiny presets registered in both
preset tables, fp32, both sides starting from one reference-format
``.pth`` the JAX package writes.

As tests/test_torch_cli_finetune.py arranges, the finetune comparisons set
``loss_mask_p`` to 1.0 on both sides, in this file only, through the CLIs'
TrainConfig (the loss mask is the one draw the packages cannot share).

- The finetune CLI at ``--log_every 1 --panel_every 1`` with recording
  TensorBoard and W&B sinks on both sides (``TBWriter`` and
  ``common.make_wandb`` replaced): the same (tag, step) sequence in each
  sink, scalars within rel 1e-5, the ``val/density_<name>`` panels (made by
  the JAX CLI's own ``_log_val_panels``) within 1e-5, the
  ``finetuning_minMAE`` artifacts.
- The port's real TensorBoard files, read back (``read_tb_events``): every
  scalar of the W&B record at its step, each panel once per sample and
  epoch, equal to the recorded one after TensorBoard's uint8 rounding.
- The pretrain CLI's W&B calls and artifact names against the JAX CLI's.
- ``--init_from_mae_model``: accepted for a matching checkpoint directory,
  refused for a preset of another width.
- ``--debug_nans`` on a batch holding one NaN pixel: FloatingPointError on
  both sides (JAX's ``jax_debug_nans`` restored after), naming the step on
  the port's finetune and pretrain CLIs; the counting engine's eager
  density check.
"""

import argparse
import functools
import os

import jax
import numpy as np
import pytest
import torch

from countr_tpu import config as jcfg
from countr_tpu.cli import common as jcommon
from countr_tpu.cli import finetune as jft
from countr_tpu.cli import pretrain as jpt
from countr_tpu.engine import checkpoint as jckpt
from countr_tpu_torch import config as tcfg
from countr_tpu_torch.cli import common as tcommon
from countr_tpu_torch.cli import finetune as tft
from countr_tpu_torch.cli import pretrain as tpt
from countr_tpu_torch.engine.checkpoint import mae_state_dict_from_flax
from tests.test_data import fsc_dir  # noqa: F401  (fixture)
from tests.torch_port_helpers import jax_model

TINY384 = dict(img_size=384, patch_size=16, embed_dim=32, depth=1, num_heads=2,
               decoder_embed_dim=32, decoder_depth=1, decoder_num_heads=2, head_width=32)
TINY_MAE = {k: v for k, v in TINY384.items() if k != "head_width"}
MAE_PRESET = "tiny384log"
REL = 1e-5  # tests/test_torch_cli_finetune.py: loss and metrics, relative
PANEL_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def tiny_presets():
    jcfg.COUNTR_PRESETS["tiny384"] = jcfg.CounTRConfig(**TINY384)
    tcfg.COUNTR_PRESETS["tiny384"] = tcfg.CounTRConfig(**TINY384)
    jcfg.MAE_PRESETS[MAE_PRESET] = jcfg.MAEConfig(**TINY_MAE)
    tcfg.MAE_PRESETS[MAE_PRESET] = tcfg.MAEConfig(**TINY_MAE)
    yield
    jcfg.COUNTR_PRESETS.pop("tiny384", None)
    tcfg.COUNTR_PRESETS.pop("tiny384", None)
    jcfg.MAE_PRESETS.pop(MAE_PRESET, None)
    tcfg.MAE_PRESETS.pop(MAE_PRESET, None)


@pytest.fixture(scope="module")
def pth(tmp_path_factory):
    _, params = jax_model(seed=7, jit=True, **TINY384)
    path = str(tmp_path_factory.mktemp("weights") / "tiny384.pth")
    jckpt.save_torch_checkpoint(path, jckpt.export_countr_state_dict(params))
    return path


@pytest.fixture(scope="module")
def mae_pth(tmp_path_factory):
    from countr_tpu.models.mae import MaskedAutoencoderViT

    model = MaskedAutoencoderViT(jcfg.MAEConfig(**TINY_MAE))
    params = jax.jit(model.init)(jax.random.key(5), jax.numpy.zeros((1, 384, 384, 3)),
                                 jax.random.key(1))
    sd = mae_state_dict_from_flax(jax.tree.map(np.asarray, params), grid=24)
    path = str(tmp_path_factory.mktemp("mae") / "tiny_mae.pth")
    torch.save({"model": {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}}, path)
    return path


@pytest.fixture
def full_mask(monkeypatch):
    """loss_mask_p 1.0 in both CLIs' TrainConfig (this file only)."""
    monkeypatch.setattr(jft, "TrainConfig", functools.partial(jcfg.TrainConfig, loss_mask_p=1.0))
    monkeypatch.setattr(tft, "TrainConfig", functools.partial(tcfg.TrainConfig, loss_mask_p=1.0))


def port_argv(tree, pth, out, *extra):
    return ["--data_path", tree, "--model", "tiny384", "--resume", pth, "--dtype", "fp32",
            "--device", "cpu", "--batch_size", "2", "--epochs", "2", "--warmup_epochs", "0",
            "--limit_steps", "2", "--num_workers", "2", "--ckpt_every", "1",
            "--log_every", "1", "--panel_every", "1", "--output_dir", out, *extra]


def jax_args(tree, pth, out, **over):
    args = dict(
        data_path=tree, anno_file="annotation_FSC147_384.json",
        data_split_file="Train_Test_Val_FSC_147.json", im_dir="images_384_VarV2",
        class_file="ImageClasses_FSC147.txt", output_dir=out, model="tiny384", resume=pth,
        dtype="fp32", seed=0, batch_size=2, epochs=2, warmup_epochs=0, blr=2e-4, lr=None,
        min_lr=0.0, weight_decay=0.05, accum_iter=1, no_aug=False, num_workers=2,
        ckpt_every=1, do_resume=False, init_from_mae="", limit_steps=2, n_devices=1,
        panel_every=1, log_every=1)
    args.update(over)
    return argparse.Namespace(**args)


class Sinks:
    """Recording TensorBoard and W&B sinks: ``tb`` holds (tag, step,
    value), ``wandb`` the W&B calls in order."""

    def __init__(self):
        self.tb, self.wandb = [], []
        sinks = self

        class TB:
            def __init__(self, log_dir):
                self.enabled = bool(log_dir)

            def scalar(self, tag, value, step):
                sinks.tb.append((tag, step, float(value)))

            def image(self, tag, img, step):
                sinks.tb.append((tag, step, np.array(img, np.float32)))

            def flush(self):
                pass

        class Wandb:
            def log(self, record, step=None):
                sinks.wandb.append(("log", step, dict(record)))

            def image(self, tag, img, step=None):
                sinks.wandb.append(("image", step, tag, np.array(img, np.float32)))

            def log_artifact(self, path, name, kind="model"):
                sinks.wandb.append(("artifact", name, os.path.basename(path)))

        self.TB, self.Wandb = TB, Wandb

    def install(self, monkeypatch, cli, common):
        monkeypatch.setattr(cli, "TBWriter", self.TB)
        monkeypatch.setattr(common, "make_wandb", lambda *a, **k: self.Wandb())
        return self


def close(a, b, what) -> None:
    if isinstance(a, np.ndarray):
        assert a.shape == b.shape, what
        assert np.abs(a - b).max() <= PANEL_TOL, what
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), what
        for k in a:
            if k != "epoch_time_s":
                close(a[k], b[k], (what, k))
    else:
        assert a == pytest.approx(b, rel=REL, abs=1e-12), (what, a, b)


def test_finetune_sinks_match_jax(fsc_dir, pth, tmp_path, full_mask, monkeypatch):  # noqa: F811
    want = Sinks().install(monkeypatch, jft, jcommon)
    jft.main(jax_args(fsc_dir, pth, str(tmp_path / "j")))
    got = Sinks().install(monkeypatch, tft, tcommon)
    tft.main(tft.get_args(port_argv(fsc_dir, pth, str(tmp_path / "t"))))

    assert [(t, s) for t, s, _ in got.tb] == [(t, s) for t, s, _ in want.tb]
    tags = [t for t, _, _ in got.tb]
    assert tags.count("train/loss_step") == 4 and tags.count("val/density_img_4.jpg") == 2
    for (tag, step, g), (_, _, w) in zip(got.tb, want.tb):
        if tag != "epoch_time_s":
            close(g, w, (tag, step))
    assert [c[:2] for c in got.wandb] == [c[:2] for c in want.wandb]
    for g, w in zip(got.wandb, want.wandb):
        if g[0] == "artifact":
            assert g == w
        else:
            assert g[2:-1] == w[2:-1]
            close(g[-1], w[-1], g[:2])
    kinds = [c[0] for c in got.wandb]
    assert kinds.count("artifact") >= 1 and kinds.count("image") == 2
    panel = next(v for t, _, v in got.tb if t.startswith("val/density_"))
    assert panel.shape == (384, 3 * 384, 3) and 0.0 <= panel.min() and panel.max() <= 1.0


def test_tensorboard_files_hold_every_record(fsc_dir, pth, tmp_path, monkeypatch):  # noqa: F811
    from countr_tpu_torch.utils.metrics import read_tb_events

    sinks = Sinks()
    monkeypatch.setattr(tcommon, "make_wandb", lambda *a, **k: sinks.Wandb())
    out = str(tmp_path / "t")
    tft.main(tft.get_args(port_argv(fsc_dir, pth, out)))
    events = read_tb_events(os.path.join(out, "tb"))
    scalars = {(t, s): v for t, s, v in events if isinstance(v, float)}
    images = [(t, s, v) for t, s, v in events if not isinstance(v, float)]
    steps = {}
    for call in sinks.wandb:
        if call[0] == "log":
            steps.setdefault(call[1], {}).update(call[2])
    for step, rec in steps.items():
        for k, v in rec.items():
            if k.endswith("_step"):  # at the global step
                assert scalars[(k, step)] == pytest.approx(v, rel=1e-6), (k, step)
            elif k != "epoch":  # at the epoch
                assert scalars[(k, rec["epoch"])] == pytest.approx(v, rel=1e-6), k
    assert len(scalars) == 2 * 4 + 8 * 2
    recorded = [c for c in sinks.wandb if c[0] == "image"]
    assert [(t, s) for t, s, _ in images] == [("val/density_img_4.jpg", 0),
                                              ("val/density_img_4.jpg", 1)]
    for (_, _, img), (_, _, _, want) in zip(images, recorded):
        assert img.shape == want.shape
        assert np.abs(img.astype(np.float32) / 255.0 - want).max() <= 1.0 / 255.0 + 1e-6


def test_pretrain_wandb_matches_jax(fsc_dir, mae_pth, tmp_path, monkeypatch):  # noqa: F811
    want = Sinks().install(monkeypatch, jpt, jcommon)
    jpt.main(argparse.Namespace(
        data_path=fsc_dir, anno_file="annotation_FSC147_384.json",
        data_split_file="Train_Test_Val_FSC_147.json", im_dir="images_384_VarV2",
        class_file="ImageClasses_FSC147.txt", output_dir=str(tmp_path / "j"),
        model=MAE_PRESET, resume=mae_pth, dtype="fp32", seed=0, mask_ratio=0.5,
        norm_pix_loss=False, masked_loss=False, batch_size=2, epochs=2, warmup_epochs=0,
        blr=1.5e-4, lr=None, min_lr=0.0, weight_decay=0.05, accum_iter=1, num_workers=2,
        resident_data=False, ckpt_every=1, ckpt_last_every=1, do_resume=False, log_every=1,
        recon_every=0, limit_steps=2, n_devices=1))
    got = Sinks().install(monkeypatch, tpt, tcommon)
    tpt.main(tpt.get_args([
        "--data_path", fsc_dir, "--model", MAE_PRESET, "--resume", mae_pth, "--dtype", "fp32",
        "--device", "cpu", "--batch_size", "2", "--epochs", "2", "--warmup_epochs", "0",
        "--limit_steps", "2", "--num_workers", "2", "--ckpt_every", "1", "--log_every", "1",
        "--recon_every", "0", "--output_dir", str(tmp_path / "t")]))

    def shape(calls):  # the masking noise differs: compare the calls, not the losses
        return [c if c[0] == "artifact" else (c[0], c[1], sorted(c[2])) for c in calls]

    assert shape(got.wandb) == shape(want.wandb)
    names = [c[1] for c in got.wandb if c[0] == "artifact"]
    assert names == ["pretrain_periodic", "pretrain_params"] * 2
    for g, w in zip(got.wandb, want.wandb):
        if g[0] == "log":
            for k in ("train/lr_step", "lr", "epoch"):
                if k in g[2]:
                    assert g[2][k] == pytest.approx(w[2][k], rel=1e-6), k


def test_init_from_mae_model(fsc_dir, pth, tmp_path):  # noqa: F811
    from countr_tpu_torch.engine.checkpoint import save_checkpoint
    from countr_tpu_torch.models import build_mae

    mae = build_mae("mae_vit_base_patch16", dtype="fp32", device="cpu", seed=3, **TINY_MAE)
    ckpt = str(tmp_path / "mae_ckpt")
    save_checkpoint(ckpt, 0, mae)
    ft = tft.Finetune(tft.get_args(port_argv(fsc_dir, pth, "", "--init_from_mae", ckpt,
                                             "--init_from_mae_model", MAE_PRESET)))
    ft.close()
    assert torch.equal(ft.model.blocks[0].attn.qkv.weight, mae.blocks[0].attn.qkv.weight)
    with pytest.raises(ValueError, match="init_from_mae_model mae_vit_base_patch16"):
        tft.Finetune(tft.get_args(port_argv(fsc_dir, pth, "", "--init_from_mae", ckpt)))


def nan_pixel(monkeypatch, dataset_cls):
    """Every sample of ``dataset_cls`` gets one NaN pixel."""
    get = dataset_cls.__getitem__

    def bad(self, i):
        s = dict(get(self, i))
        s["image"] = np.array(s["image"], np.float32)
        s["image"][0, 0, 0] = np.nan
        return s

    monkeypatch.setattr(dataset_cls, "__getitem__", bad)


@pytest.mark.parametrize("side", ["jax", "port_finetune", "port_pretrain"])
def test_debug_nans_raises(fsc_dir, pth, mae_pth, tmp_path, monkeypatch, side):  # noqa: F811
    if side == "jax":
        from countr_tpu.data import fsc147 as jdata

        nan_pixel(monkeypatch, jdata.TrainDataset)
        before = jax.config.jax_debug_nans
        try:
            with pytest.raises(FloatingPointError):
                jft.main(jax_args(fsc_dir, pth, "", no_aug=True, debug_nans=True,
                                  panel_every=0, log_every=0))
        finally:
            jax.config.update("jax_debug_nans", before)
        return
    from countr_tpu_torch.data import fsc147 as tdata

    if side == "port_finetune":
        nan_pixel(monkeypatch, tdata.TrainDataset)

        def run(*x):
            return tft.main(tft.get_args(port_argv(fsc_dir, pth, "", "--no_aug", *x)))
    else:
        nan_pixel(monkeypatch, tdata.PretrainDataset)

        def run(*x):
            return tpt.main(tpt.get_args([
                "--data_path", fsc_dir, "--model", MAE_PRESET, "--resume", mae_pth, "--dtype",
                "fp32", "--device", "cpu", "--batch_size", "2", "--epochs", "1",
                "--limit_steps", "1", "--num_workers", "2", "--output_dir", "", *x]))
    with pytest.raises(FloatingPointError, match="epoch 0 step 1"):
        run("--debug_nans")
    with pytest.raises(SystemExit, match="not finite"):  # without it: the epoch's check
        run()


def test_counting_debug_nans():
    from countr_tpu_torch.engine.inference import CountingEngine
    from countr_tpu_torch.models import build_countr

    model = build_countr("tiny384", device="cpu", dtype=torch.float32)
    img = np.random.default_rng(0).uniform(0, 1, (384, 400, 3)).astype(np.float32)
    clean = CountingEngine(model, device="cpu", batch_windows=2, debug_nans=True)
    assert np.isfinite(clean.count(img).count)
    img[5, 390, 1] = np.nan  # in the second window only
    with pytest.raises(FloatingPointError, match="window batch 2"):  # the engine's second
        clean.count(img)
    with pytest.raises(FloatingPointError, match="window batch 1"):  # the pipeline's first
        clean.count_batch([img], [None], [[]], 0)
    quiet = CountingEngine(model, device="cpu", batch_windows=2)
    assert not np.isfinite(quiet.count(img).count)
