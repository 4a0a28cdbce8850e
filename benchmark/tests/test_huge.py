"""The pretrain-huge-resident cell's driver (``drivers/pretrain_huge.py``)
on the CPU at a tiny hd-80 cut of ``mae_huge14`` (C 160, 2 heads of 80,
patch 14, 56 px; the program's plain float32 build): the run's check
against the sized reference in micro-batches of 2 of a batch of 4 comes
out as close as the 384-px cell's does (test_reference.py's bounds), the
launch plan counts the hd-80 launches under B3h80 and B4h80, and the base
driver is left as it was."""

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark.lib import common  # noqa: E402
from benchmark.tests import tiny  # noqa: E402

SEED = 2**33 + 29


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def huge_config() -> dict:
    cfg = common.load_json(common.BENCH / "configs" / "mae_huge14.json")
    cfg.update(img_size=56, embed_dim=160, depth=2, num_heads=2, decoder_embed_dim=32,
               decoder_depth=2, decoder_num_heads=4, gelu="erf")
    cfg["builds"] = {"pretrain": {"dtype": "fp32"}}
    return cfg


def huge_traffic() -> dict:
    """The cell's traffic cut as tiny.py cuts pretrain_resident's: 24
    images (the same tree), batch 4, 2 loader threads, micro-batches of 2;
    the huge preset's name stays (the driver hands the CLI its own model)."""
    t = common.load_json(common.BENCH / "traffic" / "pretrain_huge_resident.json")
    t["tree"] = dict(t["tree"], n_train=24)
    t["cli_args"] = ["4" if a == "32" else "2" if a == "8" else a for a in t["cli_args"]]
    t["reference_micro_batch"] = 2
    return t


def test_plan_counts_the_hd80_launches():
    from benchmark.drivers import pretrain, pretrain_huge

    cfg = common.load_json(common.BENCH / "configs" / "mae_huge14.json")
    plan = pretrain_huge.train_launches(cfg, 3, 32)
    assert plan["B3h80"] == plan["B4h80"] == {(32, 364, 1280): 96}
    assert plan["B3"] == {(32, 364, 1280): 96, (32, 729, 512): 24}
    assert plan["B1"] == {(11648, 1280): 3 * 65, (23328, 512): 3 * 17}
    with pretrain_huge.sized(huge_traffic()) as base:
        assert base is pretrain and base.train_launches is pretrain_huge.train_launches
        assert base.reference_steps is not pretrain_huge.reference_steps  # micro-batched
    assert pretrain.train_launches is pretrain_huge._PLAN
    assert "B3h80" not in pretrain.train_launches(cfg, 1, 32)


def test_huge_driver_matches_the_pretrain_step():
    drv = common.load_module(common.BENCH / "drivers" / "pretrain_huge.py", "ref_pretrain_huge")
    t = huge_traffic()
    out = drv.run(tiny.context("pretrain-huge-resident", huge_config(), t, SEED, 0.5))
    got = {c.name: c.value for c in out.checks}
    assert set(got) == set(t["limits"])
    assert got["loss_gap"] < 1e-6 and got["grad_gap"] < 1e-5 and got["change_gap"] < 1e-4, got
    assert got["geometry_faults"] == 0
    assert out.attempted > 0 and out.e2e["train_images_per_s"] > 0
