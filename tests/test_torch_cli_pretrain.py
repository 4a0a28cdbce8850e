"""The port's pretrain CLI (countr_tpu_torch/cli/pretrain.py, device cpu)
against the JAX package's (countr_tpu/cli/pretrain.py) on the tree of
tests/test_data.py::fsc_dir: a tiny MAE preset registered in both preset
tables, fp32, both sides starting from one reference-layout ``.pth`` made
from the JAX package's parameters through the weight bridge.

The masking noise is the one random draw the two packages cannot share: the
JAX CLI draws it from ``fold_in(key(seed), global_step)``, the port inside
its step from a generator reseeded per epoch. ``jax_noise`` therefore
feeds the port's step JAX's own noise for each global step, by replacing
the run's step with a wrapper, in this file only; the program keeps its
generator.

- Host path and ``--resident_data``, 2 epochs of ``--limit_steps 2``: the
  per-epoch train/loss within rel 1e-5 (tests/test_torch_mae.py's
  tolerance) and the lr within rel 1e-6; the retention directories.
- ``--do_resume`` from epoch 2 equals the uninterrupted 3 epochs, bit for
  bit, port against port, at the program's own noise, on both paths.
- ``ckpt_params`` loaded through ``cli.finetune --init_from_mae`` gives
  the counting model the pretrained encoder, bit for bit.
- The reconstruction panel within 1e-5 of JAX's on the same weights,
  image and noise.
- ``load_mae_weights`` ignores a released checkpoint's cls token and
  position embedding and refuses a checkpoint without a learned tensor.
- ``--n_devices 3`` at batch 2 raises: the global batch must split over
  the ranks (tests/test_torch_cli_parallel.py runs the ranks).
"""

import argparse
import itertools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from countr_tpu import config as jcfg
from countr_tpu.cli import pretrain as jpt
from countr_tpu.models import mae as jmae
from countr_tpu_torch import config as tcfg
from countr_tpu_torch.cli import finetune as tft
from countr_tpu_torch.cli import pretrain as tpt
from countr_tpu_torch.engine.checkpoint import mae_state_dict_from_flax
from tests.test_data import fsc_dir  # noqa: F401  (fixture)

TINY_MAE = dict(img_size=384, patch_size=16, embed_dim=32, depth=1, num_heads=2,
                decoder_embed_dim=32, decoder_depth=1, decoder_num_heads=2)
TINY_COUNTR = dict(TINY_MAE, head_width=32)
PRESET = "tiny384pt"
B = 2
L = (384 // 16) ** 2
REL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def tiny_presets():
    jcfg.MAE_PRESETS[PRESET] = jcfg.MAEConfig(**TINY_MAE)
    tcfg.MAE_PRESETS[PRESET] = tcfg.MAEConfig(**TINY_MAE)
    tcfg.COUNTR_PRESETS[PRESET] = tcfg.CounTRConfig(**TINY_COUNTR)
    yield
    jcfg.MAE_PRESETS.pop(PRESET, None)
    tcfg.MAE_PRESETS.pop(PRESET, None)
    tcfg.COUNTR_PRESETS.pop(PRESET, None)


def _jax_params(seed=7):
    model = jmae.MaskedAutoencoderViT(jcfg.MAEConfig(**TINY_MAE))
    params = jax.jit(model.init)(jax.random.key(seed), jnp.zeros((1, 384, 384, 3)),
                                 jax.random.key(1))
    rng = np.random.default_rng(seed)
    leaves, tree = jax.tree.flatten(params)
    leaves = [np.asarray(l) + 0.02 * rng.standard_normal(np.shape(l)).astype(np.float32)
              for l in leaves]
    return model, jax.tree.unflatten(tree, [jnp.asarray(l) for l in leaves])


@pytest.fixture(scope="module")
def pth(tmp_path_factory):
    _, params = _jax_params()
    sd = mae_state_dict_from_flax(jax.tree.map(np.asarray, params), grid=24)
    path = str(tmp_path_factory.mktemp("weights") / "tiny_mae.pth")
    torch.save({"model": {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}}, path)
    return path


def port_argv(tree, pth, out, *extra):
    return ["--data_path", tree, "--model", PRESET, "--resume", pth, "--dtype", "fp32",
            "--device", "cpu", "--batch_size", str(B), "--epochs", "2", "--warmup_epochs", "0",
            "--limit_steps", "2", "--num_workers", "2", "--ckpt_every", "1",
            "--log_every", "1", "--output_dir", out, *extra]


def jax_args(tree, pth, out, resident):
    return argparse.Namespace(
        data_path=tree, anno_file="annotation_FSC147_384.json",
        data_split_file="Train_Test_Val_FSC_147.json", im_dir="images_384_VarV2",
        class_file="ImageClasses_FSC147.txt", output_dir=out, model=PRESET, resume=pth,
        dtype="fp32", seed=0, mask_ratio=0.5, norm_pix_loss=False, masked_loss=False,
        batch_size=B, epochs=2, warmup_epochs=0, blr=1.5e-4, lr=None, min_lr=0.0,
        weight_decay=0.05, accum_iter=1, num_workers=2, resident_data=resident,
        ckpt_every=1, ckpt_last_every=1, do_resume=False, log_every=0, recon_every=0,
        limit_steps=2, n_devices=1)


def jax_noise(run):
    """Feed ``run``'s step, for its global step g, the noise the JAX CLI
    draws there: ``jax.random.uniform(fold_in(key(seed), g), (B, L))``."""
    step, seed = run.train_step, run.args.seed
    calls = itertools.count(run.start_epoch * run.steps_per_epoch)

    def fed(x):
        key = jax.random.fold_in(jax.random.key(seed), next(calls))
        return step(x, torch.from_numpy(np.array(jax.random.uniform(key, (B, L)))))

    run.train_step = fed
    return run


def read_log(out):
    with open(os.path.join(out, "log.txt")) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("resident", [False, True], ids=["host", "resident"])
def test_cli_matches_jax(fsc_dir, pth, tmp_path, resident):  # noqa: F811
    jout, tout = str(tmp_path / "j"), str(tmp_path / "t")
    jpt.main(jax_args(fsc_dir, pth, jout, resident))
    want = read_log(jout)
    extra = ("--resident_data",) * resident
    got = jax_noise(tpt.Pretrain(tpt.get_args(port_argv(fsc_dir, pth, tout, *extra)))).run()
    assert got == read_log(tout)
    assert [s["epoch"] for s in got] == [s["epoch"] for s in want] == [0, 1]
    for g, w in zip(got, want):
        assert g["train/loss"] == pytest.approx(w["train/loss"], rel=REL), (g, w)
        assert g["lr"] == pytest.approx(w["lr"], rel=1e-6)
    assert got[1]["train/loss"] != got[0]["train/loss"]
    kept = {d: sorted(os.listdir(os.path.join(tout, d)))
            for d in ("ckpt_periodic", "ckpt_last", "ckpt_params")}
    assert kept == {"ckpt_periodic": ["checkpoint-0.pth", "checkpoint-1.pth"],
                    "ckpt_last": ["checkpoint-1.pth"], "ckpt_params": ["checkpoint-1.pth"]}
    params_only = torch.load(os.path.join(tout, "ckpt_params", "checkpoint-1.pth"),
                             weights_only=False)
    assert sorted(params_only) == ["epoch", "model"]


def _stats(stats):
    return [{k: v for k, v in s.items() if k != "epoch_time_s"} for s in stats]


@pytest.mark.parametrize("resident", [False, True], ids=["host", "resident"])
def test_resume_equals_uninterrupted(fsc_dir, pth, tmp_path, resident):  # noqa: F811
    """Epochs 0-1, then a --do_resume run for epoch 2, against the same 3
    epochs in one run: the same stats and weights, bit for bit (the step's
    generator is reseeded per epoch, the samples are seeded per epoch)."""
    def argv(out, *more):
        return tpt.get_args(port_argv(fsc_dir, pth, str(tmp_path / out), "--epochs", "3",
                                      *(("--resident_data",) * resident), *more))

    whole = tpt.Pretrain(argv("whole"))
    want = _stats(whole.run())
    first = tpt.Pretrain(argv("split"))
    try:
        head = [first.run_epoch(e) for e in (0, 1)]
    finally:
        first.close()
    resumed = tpt.Pretrain(argv("split", "--do_resume"))
    assert resumed.start_epoch == 2
    tail = resumed.run()
    assert _stats(head + tail) == want
    for (k, a), (_, b) in zip(whole.model.state_dict().items(),
                              resumed.model.state_dict().items()):
        assert torch.equal(a, b), k


def test_ckpt_params_initialise_finetune(fsc_dir, pth, tmp_path):  # noqa: F811
    out = str(tmp_path / "pt")
    run = tpt.Pretrain(tpt.get_args(port_argv(fsc_dir, pth, out, "--epochs", "1")))
    run.run()
    ft = tft.Finetune(tft.get_args([
        "--data_path", fsc_dir, "--model", PRESET, "--device", "cpu", "--dtype", "fp32",
        "--batch_size", str(B), "--epochs", "1", "--num_workers", "1", "--output_dir", "",
        "--init_from_mae", os.path.join(out, "ckpt_params"), "--init_from_mae_model", PRESET]))
    ft.close()
    mae, cnt = run.model.state_dict(), ft.model.state_dict()
    enc = [k for k in cnt if k.startswith(("patch_embed.", "blocks.", "norm."))]
    assert len(enc) == 16  # patch_embed 2, one block 12, norm 2
    for k in enc:
        assert torch.equal(cnt[k], mae[k]), k
    assert not torch.equal(run.model.blocks[0].mlp.fc1.weight,
                           tpt.build_mae_model(tpt.get_args(port_argv(fsc_dir, pth, out)))
                           .blocks[0].mlp.fc1.weight)  # the run trained the encoder


def test_reconstruction_panel_matches_jax(pth):
    class Recorder:
        def image(self, tag, img, step):
            self.panel = np.asarray(img)

    jm, params = _jax_params()
    state = argparse.Namespace(params=params["params"])
    imgs = np.random.default_rng(3).uniform(0, 1, (2, 384, 384, 3)).astype(np.float32)
    rng = jax.random.key(11)
    tb = Recorder()
    jpt._log_reconstruction(tb, jm, state, jnp.asarray(imgs), rng, 0)
    args = tpt.get_args(["--model", PRESET, "--resume", pth, "--dtype", "fp32", "--device",
                         "cpu"])
    got = tpt.reconstruction_panel(tpt.build_mae_model(args), torch.from_numpy(imgs),
                                   noise=torch.from_numpy(np.array(
                                       jax.random.uniform(rng, (1, L)))))
    assert got.shape == tb.panel.shape == (384, 3 * 384, 3)
    assert np.abs(got - tb.panel).max() <= REL
    np.testing.assert_array_equal(got[:, 768:], np.clip(imgs[0], 0, 1))


def test_load_mae_weights_takes_the_learned_tensors(pth):
    args = tpt.get_args(["--model", PRESET, "--dtype", "fp32", "--device", "cpu"])
    model = tpt.build_mae_model(args)
    sd = torch.load(pth, weights_only=False)["model"]
    released = {k: v for k, v in sd.items() if "pos_embed" not in k}
    released["cls_token"] = torch.zeros(1, 1, 32)
    released["pos_embed"] = torch.zeros(1, L + 1, 32)  # with the cls token's slot
    fixed = model.pos_embed.clone()
    tpt.load_mae_weights(model, released)
    assert torch.equal(model.pos_embed, fixed)
    assert torch.equal(model.decoder_pred.weight, sd["decoder_pred.weight"])
    del released["mask_token"]
    with pytest.raises(KeyError, match="mask_token"):
        tpt.load_mae_weights(model, released)


def test_n_devices_refused(fsc_dir, pth, tmp_path):  # noqa: F811
    with pytest.raises(ValueError, match="divisible"):
        tpt.Pretrain(tpt.get_args(port_argv(fsc_dir, pth, str(tmp_path / "o"),
                                            "--n_devices", "3")))
