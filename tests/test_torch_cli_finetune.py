"""The port's finetune CLI (countr_tpu_torch/cli/finetune.py, device cpu)
against the JAX package's (countr_tpu/cli/finetune.py) on the 6-image tree
of tests/test_data.py::fsc_dir: the tiny ``tiny384`` preset registered in
both preset tables, fp32, both sides starting from one reference-format
``.pth`` that the JAX package writes from its parameters through the
weight bridge.

The loss mask is the one random draw the two packages cannot share (a
``jax.random`` key there, a torch generator here), so these comparisons
set ``loss_mask_p`` to 1.0 on both sides, in this file only, through the
CLIs' TrainConfig; the program keeps the reference's 0.8.

- With augmentation on and off, 2 epochs of ``--limit_steps 2`` at the
  CLI's own learning rate (blr 2e-4 scaled by the batch): the
  per-epoch train/loss, train/MAE, val/MAE and val/RMSE within rel 1e-5,
  the tolerance tests/test_torch_train.py holds the 3-step trajectory to
  (the samples, the order and the shot draws are equal bit for bit).
- The retention directories (periodic, last, minMAE).
- ``--do_resume`` from epoch 2 equals the uninterrupted run bit for bit,
  port against port, at the program's own loss_mask_p.
- ``--init_from_mae`` from a ``.pth`` gives JAX's encoder.
- ``--resident_data``: 2 epochs whose geometry batches, train shots,
  validation indices and validation shots equal the JAX resident CLI's bit
  for bit (the JAX side's steps replaced by recorders: its photometric
  factors and loss masks are ``jax.random`` draws, so its losses are not
  the port's); the resident validation's sums equal the host validation's
  on the same weights within rel 1e-5; ``--do_resume`` (also with
  ``--resident_pipeline``) equals the uninterrupted run bit for bit, and
  ``--resident_pipeline`` the serial run.
- ``--n_devices`` refusals: a batch of 2 over 3 ranks, and 2 ranks on
  CUDA with fewer cards visible (tests/test_torch_cli_parallel.py runs
  the ranks).
"""

import argparse
import functools
import os

import jax
import numpy as np
import pytest
import torch

from countr_tpu import config as jcfg
from countr_tpu.cli import finetune as jft
from countr_tpu.engine import checkpoint as jckpt
from countr_tpu.engine import train as jtrain
from countr_tpu_torch import config as tcfg
from countr_tpu_torch.cli import finetune as tft
from countr_tpu_torch.engine.checkpoint import mae_state_dict_from_flax, state_dict_from_flax
from tests.test_data import fsc_dir  # noqa: F401  (fixture)
from tests.torch_port_helpers import jax_model

TINY384 = dict(img_size=384, patch_size=16, embed_dim=32, depth=1, num_heads=2,
               decoder_embed_dim=32, decoder_depth=1, decoder_num_heads=2, head_width=32)
REL = 1e-5  # tests/test_torch_train.py: loss and metrics, relative
COMPARED = ("train/loss", "train/MAE", "val/MAE", "val/RMSE")


@pytest.fixture(scope="module", autouse=True)
def tiny_preset():
    jcfg.COUNTR_PRESETS["tiny384"] = jcfg.CounTRConfig(**TINY384)
    tcfg.COUNTR_PRESETS["tiny384"] = tcfg.CounTRConfig(**TINY384)
    yield
    jcfg.COUNTR_PRESETS.pop("tiny384", None)
    tcfg.COUNTR_PRESETS.pop("tiny384", None)


@pytest.fixture(scope="module")
def pth(tmp_path_factory):
    _, params = jax_model(seed=7, jit=True, **TINY384)
    path = str(tmp_path_factory.mktemp("weights") / "tiny384.pth")
    jckpt.save_torch_checkpoint(path, jckpt.export_countr_state_dict(params))
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
            "--log_every", "1", "--output_dir", out, *extra]


def jax_args(tree, pth, out, no_aug):
    return argparse.Namespace(
        data_path=tree, anno_file="annotation_FSC147_384.json",
        data_split_file="Train_Test_Val_FSC_147.json", im_dir="images_384_VarV2",
        class_file="ImageClasses_FSC147.txt", output_dir=out, model="tiny384", resume=pth,
        dtype="fp32", seed=0, batch_size=2, epochs=2, warmup_epochs=0, blr=2e-4, lr=None,
        min_lr=0.0, weight_decay=0.05, accum_iter=1, no_aug=no_aug, num_workers=2,
        ckpt_every=0, do_resume=False, init_from_mae="", limit_steps=2, n_devices=1,
        panel_every=0, log_every=0)


def read_log(out):
    import json

    with open(os.path.join(out, "log.txt")) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("no_aug", [False, True], ids=["aug", "no_aug"])
def test_cli_matches_jax(fsc_dir, pth, tmp_path, full_mask, no_aug):  # noqa: F811
    jout, tout = str(tmp_path / "j"), str(tmp_path / "t")
    jft.main(jax_args(fsc_dir, pth, jout, no_aug))
    want = read_log(jout)
    got = tft.main(tft.get_args(port_argv(fsc_dir, pth, tout, *(["--no_aug"] * no_aug))))
    assert got == read_log(tout)
    assert [s["epoch"] for s in got] == [s["epoch"] for s in want] == [0, 1]
    for g, w in zip(got, want):
        for k in COMPARED:
            assert g[k] == pytest.approx(w[k], rel=REL), (g["epoch"], k, g[k], w[k])
        assert g["lr"] == pytest.approx(w["lr"], rel=1e-6)
    assert got[1]["train/loss"] != got[0]["train/loss"]
    for d in ("ckpt_periodic", "ckpt_last", "ckpt_minMAE"):
        assert os.listdir(os.path.join(tout, d)), d
    assert os.listdir(os.path.join(tout, "ckpt_periodic")) == ["checkpoint-1.pth"]


def _stats(stats):
    return [{k: v for k, v in s.items() if k != "epoch_time_s"} for s in stats]


@pytest.mark.parametrize("extra", [(), ("--device_aug",), ("--resident_data",),
                                   ("--resident_data", "--resident_pipeline")],
                         ids=["host_aug", "device_aug", "resident", "resident_pipeline"])
def test_resume_equals_uninterrupted(fsc_dir, pth, tmp_path, extra):  # noqa: F811
    """Epochs 0-1, then a --do_resume run for epoch 2, against the same 3
    epochs in one run: the same stats and weights, bit for bit (the step's
    generator is seeded per epoch, the shot stream per epoch)."""
    def argv(out, *more):
        return tft.get_args(port_argv(fsc_dir, pth, str(tmp_path / out), "--epochs", "3",
                                      *extra, *more))

    whole = tft.Finetune(argv("whole"))
    want = _stats(whole.run())
    first = tft.Finetune(argv("split"))
    try:
        head = [first.run_epoch(e) for e in (0, 1)]
    finally:
        first.close()
    resumed = tft.Finetune(argv("split", "--do_resume"))
    assert resumed.start_epoch == 2
    tail = resumed.run()
    assert _stats(head + tail) == want
    for p, q in zip(resumed.model.parameters(), whole.model.parameters()):
        assert torch.equal(p, q)


@pytest.mark.parametrize("source", ["pth", "port_dir"])
def test_init_from_mae_gives_jax_encoder(fsc_dir, pth, tmp_path, source):  # noqa: F811
    """A reference MAE ``.pth`` (JAX's route: convert_mae_state_dict and
    transfer_encoder), and the same weights saved as the port's own
    checkpoint directory."""
    import jax.numpy as jnp

    from countr_tpu.config import MAEConfig
    from countr_tpu.models.mae import MaskedAutoencoderViT
    from countr_tpu_torch.engine.checkpoint import load_weights, save_checkpoint
    from countr_tpu_torch.models import build_mae

    tiny_mae = dict(img_size=384, patch_size=16, embed_dim=32, depth=1, num_heads=2,
                    decoder_embed_dim=32, decoder_depth=1, decoder_num_heads=2)
    mae = MaskedAutoencoderViT(MAEConfig(**tiny_mae))
    mae_params = mae.init(jax.random.key(3), jnp.zeros((1, 384, 384, 3)), jax.random.key(4))
    mae_sd = mae_state_dict_from_flax(jax.tree.map(np.asarray, mae_params))
    mae_pth = str(tmp_path / "mae.pth")
    torch.save({"model": {k: torch.from_numpy(v) for k, v in mae_sd.items()}}, mae_pth)
    init_from, preset = mae_pth, ()
    if source == "port_dir":
        port_mae = build_mae("mae_vit_base_patch16", dtype="fp32", device="cpu", **tiny_mae)
        load_weights(port_mae, mae_sd)
        init_from = str(tmp_path / "mae_ckpt")
        save_checkpoint(init_from, 0, port_mae)
        # a checkpoint directory names its MAE preset, as the JAX CLI's orbax one does
        tcfg.MAE_PRESETS["tiny384mae"] = tcfg.MAEConfig(**tiny_mae)
        preset = ("--init_from_mae_model", "tiny384mae")

    # JAX's path: the .pth through convert_mae_state_dict and transfer_encoder
    countr = jckpt.convert_countr_state_dict(jckpt.load_torch_checkpoint(pth), depth=1,
                                             decoder_depth=1)
    mae_flax = jckpt.convert_mae_state_dict(jckpt.load_torch_checkpoint(mae_pth), depth=1,
                                            decoder_depth=1)
    want = state_dict_from_flax(jax.tree.map(np.asarray,
                                             jtrain.transfer_encoder(mae_flax, countr, depth=1)))
    try:
        ft = tft.Finetune(tft.get_args(port_argv(fsc_dir, pth, str(tmp_path / "o"),
                                                 "--init_from_mae", init_from, *preset)))
    finally:
        tcfg.MAE_PRESETS.pop("tiny384mae", None)
    ft.close()
    got = ft.model.state_dict()
    assert set(got) == set(want)
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
    assert not np.array_equal(got["blocks.0.attn.qkv.weight"].numpy(),
                              state_dict_from_flax(jax.tree.map(np.asarray, countr))[
                                  "blocks.0.attn.qkv.weight"])


@pytest.mark.parametrize("flag,item", [(("--n_devices", "3"), "divisible"),
                                       (("--device", "cuda", "--n_devices", "2"), "CUDA device")])
def test_unported_flags_raise(fsc_dir, pth, tmp_path, flag, item):  # noqa: F811
    with pytest.raises(ValueError, match=item):
        tft.main(tft.get_args(port_argv(fsc_dir, pth, str(tmp_path / "o"), *flag)))


def _np(batch, keys):
    return {k: np.asarray(batch[k]) for k in keys}


def test_resident_streams_match_jax(fsc_dir, pth, monkeypatch):  # noqa: F811
    """The geometry and shot streams of 2 resident epochs, and the
    validation's indices and shots, against the JAX resident CLI's."""
    import jax.numpy as jnp

    from countr_tpu_torch.engine.train import STORE_KEYS

    want = {"train": [], "val": []}

    def jax_store_step(model, cfg):
        def step(state, arrays, batch, rng, shot_num):
            want["train"].append((_np(batch, STORE_KEYS), shot_num))
            return state, {k: jnp.zeros(()) for k in ("loss", "mae", "mse")}
        return step

    def jax_store_eval(model):
        def eval_fn(params, arrays, idxs, valid, shot_num):
            want["val"].append((np.asarray(idxs), np.asarray(valid), shot_num))
            return {k: jnp.zeros(()) for k in ("err_sum", "sq_sum", "nae_sum", "n")}
        return eval_fn

    monkeypatch.setattr(jtrain, "make_store_finetune_step", jax_store_step)
    monkeypatch.setattr(jtrain, "make_store_eval_step", jax_store_eval)
    jargs = jax_args(fsc_dir, pth, "", no_aug=False)
    jargs.resident_data = True
    jft.main(jargs)

    got = {"train": [], "val": []}
    ft = tft.Finetune(tft.get_args(port_argv(fsc_dir, pth, "", "--resident_data")))
    step, ev = ft.train_step, ft.eval_step

    def spy_step(batch, shot_num):
        got["train"].append((_np(batch, STORE_KEYS), shot_num))
        return step(batch, shot_num)

    def spy_eval(batch, shot_num):
        got["val"].append((batch["idxs"].numpy(), batch["valid"].numpy(), shot_num))
        return ev(batch, shot_num)

    ft.train_step, ft.eval_step = spy_step, spy_eval
    stats = ft.run()
    assert len(got["train"]) == len(want["train"]) == 4
    assert len(got["val"]) == len(want["val"]) == 2
    for (g, gs), (w, ws) in zip(got["train"], want["train"]):
        assert gs == ws
        for k in STORE_KEYS:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            assert g[k].dtype == w[k].dtype, k
    for (gi, gv, gs), (wi, wv, ws) in zip(got["val"], want["val"]):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gv, wv)
        assert gs == ws
    assert {float(b["is_mosaic"].max()) for b, _ in got["train"]} <= {0.0, 1.0}
    assert all(np.isfinite([v for r in stats for v in r.values()]))


def test_resident_validation_equals_host(fsc_dir, pth):  # noqa: F811
    """The resident ValStore's sums against the host loader's validation
    on the same weights, at the same shots."""
    import random

    res = tft.Finetune(tft.get_args(port_argv(fsc_dir, pth, "", "--resident_data")))
    host = tft.Finetune(tft.get_args(port_argv(fsc_dir, pth, "")))
    try:
        for seed in (0, 1):
            a = res.validate(random.Random(seed))
            b = host.validate(random.Random(seed))
            assert a["n"] == b["n"] == 1.0
            for k in ("err_sum", "sq_sum", "nae_sum"):
                assert a[k] == pytest.approx(b[k], rel=REL), (seed, k)
    finally:
        res.close()
        host.close()


def test_resident_pipeline_equals_serial(fsc_dir, pth, tmp_path):  # noqa: F811
    def run(*extra):
        ft = tft.Finetune(tft.get_args(port_argv(fsc_dir, pth, "", "--resident_data", *extra)))
        return _stats(ft.run()), [p.detach().clone() for p in ft.model.parameters()]

    serial, ws = run()
    piped, wp = run("--resident_pipeline")
    assert piped == serial
    assert serial[0]["train/loss"] != serial[1]["train/loss"]
    for p, q in zip(wp, ws):
        assert torch.equal(p, q)
