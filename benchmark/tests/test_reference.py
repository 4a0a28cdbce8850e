"""The plain references against the port's plain path (float32, the CPU,
tiny configurations): the counting reference against ``count_batch``,
the MAE reference's steps against the pretrain CLI's, its crop against
``materialize_pretrain_batch``, its AdamW against ``torch.optim.AdamW``.
The tests import the port; the references import nothing of it."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark.lib import common  # noqa: E402
from benchmark.tests import tiny  # noqa: E402

SEED = 2**33 + 17


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def test_countr_reference_matches_count_batch():
    drv = common.load_module(common.BENCH / "drivers" / "count.py", "ref_count")
    t = dict(tiny.traffic("fsc147_fewshot"), check_images=8)
    out = drv.run(tiny.context("count-fewshot", tiny.countr_config(), t, SEED, 0.5))
    assert {c.name for c in out.checks} == set(t["limits"]) == {"ttn_gap", "raw_dev"}
    assert all(c.value < 2e-5 for c in out.checks), [(c.name, c.value) for c in out.checks]
    shown = out.extra["not_compared"]
    assert set(shown) == {"raw_gap", "count_gap"} and max(shown.values()) < 2e-5, shown


def test_mae_reference_matches_the_pretrain_step():
    drv = common.load_module(common.BENCH / "drivers" / "pretrain.py", "ref_pretrain")
    t = tiny.traffic("pretrain_resident")
    out = drv.run(tiny.context("pretrain-resident", tiny.mae_config(), t, SEED, 0.5))
    got = {c.name: c.value for c in out.checks}
    assert got["loss_gap"] < 1e-6 and got["grad_gap"] < 1e-5 and got["change_gap"] < 1e-4, got


def test_crop_matches_materialize_pretrain_batch():
    from benchmark.reference import mae as ref
    from countr_tpu_torch.engine.train_store import materialize_pretrain_batch

    rng = np.random.default_rng(3)
    w = 520
    stored = rng.integers(0, 256, (384, w, 3), dtype=np.uint8)
    pool = np.concatenate([np.ascontiguousarray(stored.transpose(1, 0, 2)).reshape(-1, 3),
                           np.zeros((384 * w, 3), np.uint8)])
    arrays = {"pixels": torch.from_numpy(pool), "base": torch.zeros(1, dtype=torch.int64),
              "width": torch.full((1,), w, dtype=torch.int64)}
    for top, left, h, cw, tr, flip in ((0, 0, 384, 384, 0, 0), (30, 77, 201, 260, 0, 1),
                                       (5, 100, 300, 150, 1, 0)):
        batch = {k: torch.tensor([v], dtype=torch.int32 if k.startswith(("img", "crop"))
                                 else torch.int8)
                 for k, v in (("img_idx", 0), ("crop_top", top), ("crop_left", left),
                              ("crop_h", h), ("crop_w", cw), ("transposed", tr), ("flip", flip))}
        prog = materialize_pretrain_batch(arrays, batch, w)[0]  # [384, 384, 3]
        mine = ref.crop(stored, bool(tr), top, left, h, cw, bool(flip), "cpu").permute(1, 2, 0)
        assert float((prog - mine).abs().max()) < 2e-4


def test_adamw_matches_torch():
    from benchmark.reference import mae as ref

    g = torch.Generator().manual_seed(0)
    params = {"a.weight": torch.randn(4, 3, generator=g), "a.bias": torch.randn(3, generator=g)}
    opt_cfg = {"beta1": 0.9, "beta2": 0.95, "eps": 1e-8, "weight_decay": 0.05}
    theirs = {k: torch.nn.Parameter(v.clone()) for k, v in params.items()}
    opt = torch.optim.AdamW([{"params": [theirs["a.weight"]], "weight_decay": 0.05},
                             {"params": [theirs["a.bias"]], "weight_decay": 0.0}],
                            lr=1e-2, betas=(0.9, 0.95), eps=1e-8)
    moments = {}
    for step in range(1, 4):
        grads = {k: torch.randn(v.shape, generator=g) for k, v in params.items()}
        for k, p in theirs.items():
            p.grad = grads[k].clone()
        opt.step()
        ref.adamw(params, grads, moments, step, 1e-2, opt_cfg)
    for k in params:
        assert torch.allclose(params[k], theirs[k].detach(), rtol=0, atol=1e-7)
