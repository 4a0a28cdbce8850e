"""Quick-check entry points of the port (counterpart of
``__graft_entry__.py``): ``entry``, a single-device forward and its
example inputs, and ``dryrun_multichip``, a data-parallel finetune dry run
on CPU ranks.

    python -c "from countr_tpu_torch import entry as e; e.dryrun_multichip(2)"
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

ENTRY_MODEL = "mae_vit_base6_patch16"  # the released-weights CounTR config
ENTRY_SHOT = 3

# __graft_entry__.py:67-71: the dry run's tiny model
DRYRUN_CONFIG = dict(img_size=64, patch_size=16, embed_dim=64, depth=2, num_heads=4,
                     decoder_embed_dim=32, decoder_depth=2, decoder_num_heads=4, head_width=32)


def entry(device=None):
    """(fn, example_args): the few-shot counting forward of
    ``mae_vit_base6_patch16`` in the bf16 inference build (B1 and the fused
    attention half-block B2 on the card), random weights from seed 0, on
    ``device`` (None = the CUDA card; raises without one; "cpu" on
    request), and its inputs: a zero image [1, 384, 384, 3] and zero
    exemplar crops [1, 3, 64, 64, 3], at shot 3. ``fn(*example_args)``
    returns the density [1, 384, 384]."""
    from countr_tpu_torch.config import fast_mode_overrides
    from countr_tpu_torch.models import build_countr

    model = build_countr(ENTRY_MODEL, device=device, **fast_mode_overrides("bf16"))
    dev = next(model.parameters()).device
    imgs = torch.zeros((1, 384, 384, 3), device=dev)
    boxes = torch.zeros((1, 3, 64, 64, 3), device=dev)

    @torch.inference_mode()
    def fn(imgs, boxes):
        return model(imgs, boxes, ENTRY_SHOT)

    fn.model = model
    return fn, (imgs, boxes)


def _dryrun_rank(args) -> dict:
    """One rank of ``dryrun_multichip``: the finetune steps at shots 3 and
    0 on this rank's rows of the global batch; returns the last loss."""
    from countr_tpu_torch.config import CounTRConfig, TrainConfig
    from countr_tpu_torch.engine.train import init_train_state, make_finetune_step
    from countr_tpu_torch.models.countr import CounTR
    from countr_tpu_torch.models.init import init_countr_
    from countr_tpu_torch.parallel.dist import init_distributed
    from countr_tpu_torch.parallel.mesh import rows_of

    mesh = init_distributed(args.device)
    world = mesh.world if mesh else 1
    rank = mesh.rank if mesh else 0
    tcfg = TrainConfig(batch_size=2 * world, epochs=2, warmup_epochs=1)
    model = CounTR(CounTRConfig(**DRYRUN_CONFIG))
    init_countr_(model, torch.Generator().manual_seed(0))
    model.train()
    state = init_train_state(model, tcfg, 4, tcfg.batch_size, mesh)
    step = make_finetune_step(state, tcfg, graphed=False)
    b, hw = tcfg.batch_size, DRYRUN_CONFIG["img_size"]
    batch = {"image": np.random.default_rng(0).uniform(0, 1, (b, hw, hw, 3)).astype(np.float32),
             "gt_density": np.zeros((b, hw, hw), np.float32),
             "boxes": np.zeros((b, 3, 64, 64, 3), np.float32)}
    batch = {k: torch.from_numpy(rows_of(v, rank, world)) for k, v in batch.items()}
    for shot in (3, 0):  # both exemplar paths
        m = step(batch, shot)
    return {"loss": float(m["loss"]), "world": world, "updates": state.updates}


def dryrun_multichip(n_devices: int) -> dict:
    """The finetune step of ``DRYRUN_CONFIG`` (shots 3 and 0) on
    ``n_devices`` gloo ranks on the CPU, started through
    ``parallel.dist.launch``, the gradients averaged across the ranks in
    the step. Returns rank 0's result; raises on a non-finite loss."""
    from countr_tpu_torch.parallel.dist import launch

    out = launch(_dryrun_rank, argparse.Namespace(device="cpu"), n_devices)
    if not np.isfinite(out["loss"]):
        raise AssertionError(f"non-finite loss {out['loss']}")
    print(f"dryrun_multichip OK: {out['world']} ranks, loss={out['loss']:.5f}, "
          f"updates={out['updates']}")
    return out
