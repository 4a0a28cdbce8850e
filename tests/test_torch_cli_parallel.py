"""The port's training CLIs as data-parallel gloo ranks on the CPU
(``--device cpu --n_devices 2``), tiny presets, fp32, on the trees of
tests/test_data.py::fsc_dir and tests/test_carpk.py::carpk_dir.

- The finetune CLI run as two ranks under torchrun's environment
  (tests/torch_dist_worker.py), host augmentation, against the JAX
  package's ``countr_tpu.cli.finetune.main`` at ``--n_devices 2`` (a
  2-device mesh of the virtual CPU devices) and against the port's own
  one process: per-epoch train/loss, train/MAE, val/MAE and val/RMSE
  within rel 1e-5. The loss mask is the one draw the packages cannot
  share, so this case sets ``loss_mask_p`` 1.0 on every side, as
  tests/test_torch_cli_finetune.py:10 states. Rank 0 alone writes: 2
  JSONL lines, one file in each checkpoint directory.
- The ranks the CLIs start themselves (``parallel.dist.launch``), at the
  program's own draws, against one process: the finetune CLI on
  ``--resident_data``, ``--resident_pipeline`` and ``--device_aug`` (the
  photometric factors drawn at the global batch's shape), the pretrain
  CLI on both paths (the masking noise likewise), the CARPK CLI at batch
  2: per-epoch stats within rel 1e-5.
- The refusals: ``--batch_size`` not divisible by ``--n_devices`` (the
  CARPK CLI's default batch 1 at N 2), and N above the visible CUDA
  devices.
- Marked slow, as the JAX package's rehearsal (tests/test_multiprocess.py
  :223) is: two ranks killed once epoch 0's checkpoint is written and
  resumed with ``--do_resume`` equal an uninterrupted two-rank run.
"""

import functools
import os

import pytest

from countr_tpu import config as jcfg
from countr_tpu.cli import finetune as jft
from countr_tpu_torch import config as tcfg
from countr_tpu_torch.cli import finetune as tft
from countr_tpu_torch.cli import finetune_carpk as tcarpk
from countr_tpu_torch.cli import pretrain as tpt
from tests import test_torch_cli_pretrain as cli_pt
from tests.test_carpk import carpk_dir  # noqa: F401  (fixture)
from tests.test_data import fsc_dir  # noqa: F401  (fixture)
from tests.test_torch_cli_finetune import TINY384, jax_args, port_argv, pth, read_log  # noqa: F401
from tests.torch_dist_worker import run_ranks

REL = 1e-5
COMPARED = ("train/loss", "train/MAE", "val/MAE", "val/RMSE")
PRESETS = {"tiny384": ("countr", TINY384)}


@pytest.fixture(scope="module", autouse=True)
def tiny_presets():
    jcfg.COUNTR_PRESETS["tiny384"] = jcfg.CounTRConfig(**TINY384)
    tcfg.COUNTR_PRESETS["tiny384"] = tcfg.CounTRConfig(**TINY384)
    jcfg.MAE_PRESETS[cli_pt.PRESET] = jcfg.MAEConfig(**cli_pt.TINY_MAE)
    tcfg.MAE_PRESETS[cli_pt.PRESET] = tcfg.MAEConfig(**cli_pt.TINY_MAE)
    tcfg.COUNTR_PRESETS[cli_pt.PRESET] = tcfg.CounTRConfig(**cli_pt.TINY_COUNTR)
    yield
    for table, name in ((jcfg.COUNTR_PRESETS, "tiny384"), (tcfg.COUNTR_PRESETS, "tiny384"),
                        (jcfg.MAE_PRESETS, cli_pt.PRESET), (tcfg.MAE_PRESETS, cli_pt.PRESET),
                        (tcfg.COUNTR_PRESETS, cli_pt.PRESET)):
        table.pop(name, None)


@pytest.fixture(scope="module")
def mae_pth(tmp_path_factory):
    """tests/test_torch_cli_pretrain.py's weights."""
    import jax
    import numpy as np
    import torch

    from countr_tpu_torch.engine.checkpoint import mae_state_dict_from_flax

    _, params = cli_pt._jax_params()
    sd = mae_state_dict_from_flax(jax.tree.map(np.asarray, params), grid=24)
    path = str(tmp_path_factory.mktemp("weights") / "tiny_mae.pth")
    torch.save({"model": {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}}, path)
    return path


def _close(got, want, keys):
    assert [s["epoch"] for s in got] == [s["epoch"] for s in want] == [0, 1]
    for g, w in zip(got, want):
        for k in keys:
            assert g[k] == pytest.approx(w[k], rel=REL), (g["epoch"], k, g[k], w[k])
    assert got[1]["train/loss"] != got[0]["train/loss"]


def test_finetune_ranks_match_jax_and_one_process(fsc_dir, pth, tmp_path,  # noqa: F811
                                                  monkeypatch):
    jout, one, two = (str(tmp_path / d) for d in ("j", "one", "two"))
    jargs = jax_args(fsc_dir, pth, jout, no_aug=False)
    jargs.n_devices = 2
    monkeypatch.setattr(jft, "TrainConfig", functools.partial(jcfg.TrainConfig, loss_mask_p=1.0))
    jft.main(jargs)
    monkeypatch.setattr(tft, "TrainConfig", functools.partial(tcfg.TrainConfig, loss_mask_p=1.0))
    single = tft.main(tft.get_args(port_argv(fsc_dir, pth, one)))
    ranks = run_ranks({"kind": "cli", "cli": "finetune", "presets": PRESETS, "loss_mask_p": 1.0,
                       "argv": port_argv(fsc_dir, pth, two, "--n_devices", "2")}, 2, tmp_path)
    _close(ranks, read_log(jout), COMPARED)
    _close(ranks, single, COMPARED)
    assert read_log(two) == ranks  # rank 0's two lines, not four
    for d in ("ckpt_periodic", "ckpt_last", "ckpt_minMAE"):
        assert len(os.listdir(os.path.join(two, d))) == 1, d


def _stats(stats):
    return [{k: v for k, v in s.items() if k != "epoch_time_s"} for s in stats]


@pytest.mark.parametrize("extra", [("--resident_data",), ("--resident_data",
                                                          "--resident_pipeline"),
                                   ("--device_aug",)],
                         ids=["resident", "resident_pipeline", "device_aug"])
def test_finetune_launched_ranks_match_one_process(fsc_dir, pth, tmp_path, extra):  # noqa: F811
    one, two = str(tmp_path / "one"), str(tmp_path / "two")
    single = tft.main(tft.get_args(port_argv(fsc_dir, pth, one, *extra)))
    ranks = tft.main(tft.get_args(port_argv(fsc_dir, pth, two, *extra, "--n_devices", "2")))
    _close(ranks, single, COMPARED + ("val/NAE",))
    assert _stats(read_log(two)) == _stats(ranks)
    assert len(os.listdir(os.path.join(two, "ckpt_last"))) == 1


@pytest.mark.parametrize("extra", [(), ("--resident_data", "--output_dir", "")],
                         ids=["host", "resident"])
def test_pretrain_ranks_match_one_process(fsc_dir, mae_pth, tmp_path, extra):  # noqa: F811
    """Rank 0's files on the host path; the resident path writes none (the
    TensorBoard writer's import alone takes ~12 s in each new process)."""
    one, two = str(tmp_path / "one"), str(tmp_path / "two")
    single = tpt.main(tpt.get_args(cli_pt.port_argv(fsc_dir, mae_pth, one, *extra)))
    ranks = tpt.main(tpt.get_args(cli_pt.port_argv(fsc_dir, mae_pth, two, *extra,
                                                   "--n_devices", "2")))
    _close(ranks, single, ("train/loss", "lr"))
    if not extra:
        assert _stats(cli_pt.read_log(two)) == _stats(ranks)
        assert len(os.listdir(os.path.join(two, "ckpt_params"))) == 1


def test_carpk_ranks_match_one_process(carpk_dir, pth, tmp_path):  # noqa: F811
    def argv(out, *extra):
        return ["--carpk_root", carpk_dir, "--model", "tiny384", "--resume", pth,
                "--dtype", "fp32", "--device", "cpu", "--batch_size", "2", "--epochs", "2",
                "--warmup_epochs", "0", "--num_workers", "2", "--output_dir", out, *extra]

    single = tcarpk.main(tcarpk.get_args(argv(str(tmp_path / "one"))))
    ranks = tcarpk.main(tcarpk.get_args(argv(str(tmp_path / "two"), "--n_devices", "2")))
    _close(ranks, single, ("train/loss", "train/MAE"))


@pytest.mark.parametrize("cli,argv", [
    (tft, ["--batch_size", "3", "--n_devices", "2"]),
    (tpt, ["--batch_size", "5", "--n_devices", "2"]),
    (tcarpk, ["--n_devices", "2"]),
    (tft, ["--device", "cuda", "--batch_size", "64", "--n_devices", "64"]),
], ids=["finetune", "pretrain", "carpk_default_batch", "cuda_devices"])
def test_n_devices_refusals(cli, argv):
    match = "CUDA device" if "cuda" in argv else "divisible"
    with pytest.raises(ValueError, match=match):
        cli.main(cli.get_args(["--device", "cpu", *argv]))


@pytest.mark.slow
def test_two_ranks_kill_and_resume(fsc_dir, pth, tmp_path):  # noqa: F811
    """Two ranks SIGKILLed once epoch 0's ckpt_last is written, then
    resumed with --do_resume for epochs 1-2, against three uninterrupted
    epochs of two ranks: the same per-epoch stats."""
    def spec(out, *extra):
        return {"kind": "cli", "cli": "finetune", "presets": PRESETS,
                "argv": port_argv(fsc_dir, pth, out, "--epochs", "3", "--n_devices", "2",
                                  *extra)}

    whole = run_ranks(spec(str(tmp_path / "whole")), 2, tmp_path / "w")
    out = str(tmp_path / "killed")
    first = os.path.join(out, "ckpt_last", "checkpoint-0.pth")
    assert run_ranks(spec(out), 2, tmp_path / "k", kill_when=lambda: os.path.exists(first)) \
        is None
    resumed = run_ranks(spec(out, "--do_resume"), 2, tmp_path / "r")
    assert [s["epoch"] for s in resumed][-1] == 2
    assert _stats(resumed) == _stats(whole[-len(resumed):])

