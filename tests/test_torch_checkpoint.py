"""Save and resume of the training state (countr_tpu_torch/engine/
checkpoint.py ``save_checkpoint``, ``restore_checkpoint``,
``restore_params``, ``latest_step``), on the CPU, a tiny fp32 CounTR at a
64x64 window.

- A run saved after some mini-steps and restored into a fresh state (a
  model built from another seed) goes on exactly as the run that was not
  interrupted: the same bits in every loss, parameter, Adam tensor and
  accumulator, and the same counts. Without accumulation (saved after 2
  of 4) and at ``accum_iter`` 2 in the middle of a cycle (after 3 of 6,
  the accumulator holding one gradient).
- A restore writes into the live tensors: no parameter, gradient, Adam
  tensor, accumulator or buffer changes its address.
- Keep-N retention, ``latest_step``, the atomic write (no temporary file
  left), ``restore_params`` from a full and from a params-only file, and
  the refusals (a params-only file, another ``accum_iter``).
- ``graphed=True`` on a CPU model raises: CUDA graphs need the card, and
  nothing falls back to eager.

The loss mask of mini-step i is drawn after ``manual_seed(100 + i)``, as a
training loop seeds its generator from the step.
"""

import os

import numpy as np
import pytest
import torch

from countr_tpu_torch.config import TrainConfig
from countr_tpu_torch.engine import checkpoint as ckpt
from countr_tpu_torch.engine import train as ttrain
from countr_tpu_torch.models import build_countr, build_mae

TINY = dict(img_size=64, embed_dim=32, depth=1, num_heads=2, decoder_embed_dim=32,
            decoder_depth=1, decoder_num_heads=2, head_width=32)
B = 2
SHOTS = [3, 0, 2, 1, 3, 2]


def batch(i: int) -> dict:
    rng = np.random.default_rng(40 + i)
    return {
        "image": torch.from_numpy(rng.uniform(0, 1, (B, 64, 64, 3)).astype(np.float32)),
        "gt_density": torch.from_numpy((0.05 * rng.uniform(0, 1, (B, 64, 64)))
                                       .astype(np.float32)),
        "boxes": torch.from_numpy(rng.uniform(0, 1, (B, 3, 64, 64, 3)).astype(np.float32)),
    }


def trainer(seed: int, accum: int):
    """(state, step, generator) of a tiny model built from ``seed``."""
    model = build_countr(device="cpu", seed=seed, training=True, **TINY)
    cfg = TrainConfig(batch_size=B, epochs=4, warmup_epochs=1, lr=1e-3, weight_decay=0.05,
                      accum_iter=accum)
    state = ttrain.init_train_state(model, cfg, steps_per_epoch=2, world_batch=B)
    gen = torch.Generator().manual_seed(0)
    return state, ttrain.make_finetune_step(state, cfg, gen), gen


def run(state, step, gen, steps) -> list:
    losses = []
    for i in steps:
        gen.manual_seed(100 + i)
        losses.append(step(batch(i), SHOTS[i])["loss"])
    return losses


def tensors(state) -> dict:
    """Every tensor of the training state by name."""
    out = dict(state.model.state_dict())
    for i, p in enumerate(state.params):
        out.update({f"grad{i}": state.grads[i]})
        out.update({f"{k}{i}": t for k, t in zip(("step", "m", "v"), state.moments(p))})
    out.update({f"acc{i}": a for i, a in enumerate(state.acc)})
    return out


@pytest.mark.parametrize("accum, total, saved_at", [(1, 4, 2), (2, 6, 3)],
                         ids=["accum1", "accum2_mid_cycle"])
def test_resume_equals_the_uninterrupted_run(tmp_path, accum, total, saved_at):
    ref = trainer(0, accum)
    want = run(*ref, range(total))

    first = trainer(0, accum)
    got = run(*first, range(saved_at))
    ckpt.save_checkpoint(str(tmp_path), saved_at, first[0])
    if accum > 1:
        assert saved_at % accum and any(a.any() for a in first[0].acc)  # mid-cycle
    fresh = trainer(7, accum)
    assert ckpt.restore_checkpoint(str(tmp_path), fresh[0]) == saved_at
    assert (fresh[0].step, fresh[0].updates) == (saved_at, saved_at // accum)
    got += run(*fresh, range(saved_at, total))

    assert [float(x) for x in got] == [float(x) for x in want]
    a, b = tensors(fresh[0]), tensors(ref[0])
    assert sorted(a) == sorted(b)
    for k in a:
        if not k.startswith("grad"):
            assert torch.equal(a[k], b[k]), k
    assert (fresh[0].step, fresh[0].updates) == (ref[0].step, ref[0].updates)


def test_restore_writes_into_the_live_tensors(tmp_path):
    src, dst = trainer(0, 2), trainer(3, 2)
    run(*src, range(3))
    ckpt.save_checkpoint(str(tmp_path), 3, src[0])
    run(*dst, range(1))
    live = tensors(dst[0])
    ptrs = {k: t.data_ptr() for k, t in live.items()}
    grads = [p.grad for p in dst[0].params]
    ckpt.restore_checkpoint(str(tmp_path), dst[0])
    after = tensors(dst[0])
    assert {k: t.data_ptr() for k, t in after.items()} == ptrs
    assert all(p.grad is g for p, g in zip(dst[0].params, grads))
    assert all(not g.any() for g in dst[0].grads)
    want = tensors(src[0])
    for k, t in after.items():
        if not k.startswith("grad"):
            assert torch.equal(t, want[k]), k


def test_keep_latest_and_atomic_write(tmp_path):
    d = str(tmp_path / "ckpts")
    assert ckpt.latest_step(d) is None
    os.makedirs(d)
    assert ckpt.latest_step(d) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore_params(d)
    state = trainer(0, 1)[0]
    for step in (1, 2, 10, 3, 11):
        path = ckpt.save_checkpoint(d, step, state, keep=2)
        assert path == os.path.join(d, f"checkpoint-{step}.pth") and os.path.exists(path)
    assert sorted(os.listdir(d)) == ["checkpoint-10.pth", "checkpoint-11.pth"]
    assert ckpt.latest_step(d) == 11


def test_restore_params_from_full_and_params_only(tmp_path):
    state, step, gen = trainer(0, 1)
    run(state, step, gen, range(2))
    full, only = str(tmp_path / "full"), str(tmp_path / "params")
    ckpt.save_checkpoint(full, 5, state)
    mae = build_mae(device="cpu", dtype="fp32", embed_dim=32, depth=1, num_heads=2,
                    decoder_embed_dim=32, decoder_depth=1, decoder_num_heads=2)
    ckpt.save_checkpoint(only, 9, mae)
    for d, model in ((full, state.model), (only, mae)):
        sd = ckpt.restore_params(d)
        want = model.state_dict()
        assert sorted(sd) == sorted(want)
        for k, v in want.items():
            assert sd[k].dtype == torch.float32 and torch.equal(sd[k], v.float()), k
    assert ckpt.restore_params(full, step=5).keys() == state.model.state_dict().keys()
    with pytest.raises(ValueError, match="weights only"):
        ckpt.restore_checkpoint(only, state)
    with pytest.raises(ValueError, match="accumulates"):
        ckpt.restore_checkpoint(full, trainer(0, 2)[0])


def test_graphed_steps_need_a_cuda_device():
    state = trainer(0, 1)[0]
    cfg = TrainConfig(batch_size=B)
    with pytest.raises(ValueError, match="CUDA"):
        ttrain.make_finetune_step(state, cfg, graphed=True)
    with pytest.raises(ValueError, match="CUDA"):
        ttrain.make_eval_step(state.model, graphed=True)
    mae = build_mae(device="cpu", dtype="fp32", embed_dim=32, depth=1, num_heads=2,
                    decoder_embed_dim=32, decoder_depth=1, decoder_num_heads=2)
    mstate = ttrain.init_train_state(mae, cfg, steps_per_epoch=2, world_batch=B)
    with pytest.raises(ValueError, match="CUDA"):
        ttrain.make_pretrain_step(mstate, cfg, graphed=True)
    # graphed=None on the CPU: the eager step
    step = ttrain.make_finetune_step(state, cfg, torch.Generator().manual_seed(0))
    assert not hasattr(step, "runner")
    assert np.isfinite(float(step(batch(0), 3)["loss"]))
