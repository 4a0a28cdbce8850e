"""Shared CLI plumbing of the port (counterpart of
``countr_tpu/cli/common.py``): argument groups, the model build and
weight loading.

Every entry point takes ``--device`` (default ``cuda``): without a card
the build raises (``countr_tpu_torch.resolve_device``), and ``cpu`` runs
on the CPU on request. The JAX package's flags for JAX machinery
(``--debug_nans``, the compilation cache) and for W&B are not carried
(ROADMAP item 9).
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

from countr_tpu_torch.config import DTYPE_MODES, fast_mode_overrides


def add_data_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--data_path", default="./data/FSC147/", type=str)
    p.add_argument("--anno_file", default="annotation_FSC147_384.json", type=str)
    p.add_argument("--data_split_file", default="Train_Test_Val_FSC_147.json", type=str)
    p.add_argument("--im_dir", default="images_384_VarV2", type=str)
    p.add_argument("--class_file", default="ImageClasses_FSC147.txt", type=str)
    p.add_argument("--output_dir", default="./out", type=str)


def add_model_args(p: argparse.ArgumentParser, default_model: str = "mae_vit_base_patch16") -> None:
    p.add_argument("--model", default=default_model, type=str,
                   help="model preset name (see countr_tpu_torch.config.COUNTR_PRESETS)")
    p.add_argument("--resume", default="", type=str,
                   help=".pth checkpoint (reference format), or a directory of the "
                        "port's checkpoints (the latest step); empty = random "
                        "weights from --seed")
    p.add_argument("--dtype", default="bf16", choices=list(DTYPE_MODES),
                   help="compute dtype mode: bf16 = the fast mode (fused kernels, tanh "
                        "GELU, subpixel head); fp32 = exact; mixed = the bf16 trunk "
                        "under an fp32 density head; mixed_fast = mixed at the JAX "
                        "package's Precision.HIGH head, which is mixed's full fp32 "
                        "head here; mixed_bal = mixed with head stages 0-2 in bf16")
    p.add_argument("--exact_gelu", action="store_true",
                   help="exact erf GELU even in the bf16 and mixed modes (whose fast "
                        "path takes tanh GELU, an error below bf16 rounding)")
    p.add_argument("--unfreeze_encoder", action="store_true",
                   help="train the ViT encoder too (the reference freezes it under "
                        "torch.no_grad, models_mae_cross.py:204-205; unfreezing is for "
                        "training without a pretrained encoder)")
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--device", default="cuda", type=str,
                   help="torch device; cuda raises when no card is present, "
                        "cpu runs on the CPU")


def load_meta(args):
    from countr_tpu_torch.data.fsc147 import FSC147Meta

    return FSC147Meta.load(
        args.data_path, args.anno_file, args.data_split_file, args.im_dir,
        args.class_file,
    )


def build_counting_model(args, training: bool = False):
    """Build the counting model on ``args.device`` in the ``--dtype``
    mode (``config.fast_mode_overrides``) and load weights per --resume:
    - a path ending in .pth: a reference torch checkpoint
      (``load_torch_checkpoint``, reference loader: util/misc.py:363-376);
    - a directory: the latest of the port's own checkpoints
      (``restore_params``);
    - empty: random weights from ``--seed``.

    ``training=True`` (the finetune CLI) builds the model in train mode
    with the standalone LayerNorm and attention kernels (B1, B3/B4) in
    place of the forward-only fused half-block B2, as the JAX package's
    training builds (countr_tpu/cli/common.py:118-150). ``--exact_gelu``
    keeps the erf GELU; ``--unfreeze_encoder`` trains the encoder."""
    from countr_tpu_torch.engine import checkpoint as ckpt
    from countr_tpu_torch.models import build_countr

    over = fast_mode_overrides(args.dtype, training=training)
    if getattr(args, "exact_gelu", False) and "approx_gelu" in over:
        over["approx_gelu"] = False
    if getattr(args, "unfreeze_encoder", False):
        over["freeze_encoder"] = False
    model = build_countr(args.model, device=args.device, seed=args.seed, training=training,
                         **over)
    if args.resume.endswith(".pth"):
        ckpt.load_weights(model, ckpt.load_torch_checkpoint(args.resume))
    elif args.resume:
        ckpt.load_weights(model, ckpt.restore_params(args.resume))
        print(f"restored checkpoint from {args.resume}")
    return model


def build_engine(args, normalization: bool):
    """The CLIs' CountingEngine on ``args.device``. One device only: the
    multi-device pipeline is not ported yet (ROADMAP item 8)."""
    from countr_tpu_torch.engine.inference import CountingEngine

    if getattr(args, "n_devices", 0) > 1:
        raise ValueError(
            f"--n_devices {args.n_devices}: the port counts on one device; sharding "
            "window batches over several is not ported yet (ROADMAP item 8)")
    return CountingEngine(
        build_counting_model(args),
        batch_windows=args.batch_windows,
        normalization=normalization,
        max_s_cnt=getattr(args, "max_s_cnt", 1),
        narrow_policy=getattr(args, "narrow_policy", "pad"),
        device=args.device,
    )


def ensure_outdir(args) -> Optional[str]:
    if args.output_dir:
        os.makedirs(args.output_dir, exist_ok=True)
    return args.output_dir or None
