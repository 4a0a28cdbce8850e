"""Shared CLI plumbing of the port (counterpart of
``countr_tpu/cli/common.py``): argument groups, the model build and
weight loading.

Every entry point takes ``--device`` (default ``cuda``): without a card
the build raises (``countr_tpu_torch.resolve_device``), and ``cpu`` runs
on the CPU on request. ``--wandb_*`` name the optional W&B run
(``make_wandb``). ``--debug_nans`` is the port's ``jax_debug_nans``: no
CUDA graph, the training steps under ``torch.autograd.detect_anomaly``,
and the first step loss (training) or window batch density (counting)
that holds a NaN raises ``FloatingPointError`` naming it
(``nan_watched``).

``--n_devices``: the training CLIs run one rank per device
(``launch_ranks``, ``init_ranks``; ``parallel/dist.py``), the counting
CLIs shard each window chunk over the devices in one process
(``build_engine``).
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, Dict, Iterator, Optional

import torch

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
    p.add_argument("--debug_nans", action="store_true",
                   help="find NaNs: no CUDA graph, the training steps under "
                        "torch.autograd.detect_anomaly, and the first step loss or window "
                        "batch density holding a NaN raises FloatingPointError naming it")
    p.add_argument("--wandb_project", default="", type=str,
                   help="log to this W&B project when the client is available")
    p.add_argument("--wandb_title", default="", type=str,
                   help="W&B run name (reference --title)")
    p.add_argument("--wandb_team", default="", type=str,
                   help="W&B entity/team (reference --team)")
    p.add_argument("--wandb_id", default="", type=str,
                   help="W&B run id to resume (reference --wandb_id)")


def make_wandb(args, enabled: bool = True):
    """Rank 0's W&B writer from the reference's flag set (a no-op sink
    without ``--wandb_project`` or without the client)."""
    from countr_tpu_torch.utils.metrics import WandbWriter

    return WandbWriter(
        (getattr(args, "wandb_project", "") or None) if enabled else None,
        run_name=getattr(args, "wandb_title", "") or None,
        config=vars(args),
        team=getattr(args, "wandb_team", "") or None,
        run_id=getattr(args, "wandb_id", "") or None,
    )


def nan_watched(metrics: Iterator[Dict], where: Callable[[int], str],
                key: str = "loss") -> Iterator[Dict]:
    """``--debug_nans`` on a training CLI's stream of step metrics (each
    step runs when its metrics are drawn): every step drawn under
    ``torch.autograd.detect_anomaly``; the first step whose backward makes
    a NaN, or whose ``key`` holds one, raises ``FloatingPointError``
    naming ``where(i)`` (i counts the steps from 1), as ``jax_debug_nans``
    raises it."""
    i = 0
    while True:
        i += 1
        try:
            with torch.autograd.detect_anomaly():
                m = next(metrics)
        except StopIteration:
            return
        except RuntimeError as e:
            if "nan" not in str(e).lower():
                raise
            raise FloatingPointError(f"--debug_nans: NaN in {where(i)}: {e}") from e
        if not bool(torch.isfinite(m[key]).all()):
            raise FloatingPointError(f"--debug_nans: NaN in the {key} of {where(i)}")
        yield m


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


def launch_ranks(entry, args):
    """A training CLI's front: with ``--n_devices`` N > 1 outside torchrun,
    start N ranks of ``entry(args)`` here (``parallel.dist.launch``: one
    card each, or gloo processes with ``--device cpu``) and return rank 0's
    result; None when this process runs the training itself."""
    import os

    from countr_tpu_torch.parallel import dist

    n = args.n_devices
    if n <= 1 or "WORLD_SIZE" in os.environ:
        return None
    check_batch(args, n)
    return dist.launch(entry, args, n)


def check_batch(args, world: int) -> None:
    """The global ``--batch_size`` splits evenly over the ranks
    (``countr_tpu/cli/finetune.py:176-182``)."""
    if args.batch_size % world:
        raise ValueError(f"--batch_size {args.batch_size} must be divisible by the "
                         f"{world}-device mesh (--n_devices)")


def init_ranks(args):
    """This process's data-parallel ``parallel.mesh.Mesh`` when it is a rank
    (under torchrun, or started by ``launch_ranks``), with ``args.device``
    set to the rank's device; None in a single-process run, which
    ``--n_devices`` above 1 refuses. A rank's ``--n_devices`` must be 0 or
    the world size, and ``--batch_size`` a multiple of it."""
    from countr_tpu_torch.parallel import dist

    mesh = dist.init_distributed(args.device)
    if mesh is None:
        if args.n_devices > 1:
            check_batch(args, args.n_devices)
            raise ValueError(f"--n_devices {args.n_devices}: start the ranks through the "
                             "CLI's main() or under torchrun")
        return None
    if args.n_devices not in (0, mesh.world):
        raise ValueError(f"--n_devices {args.n_devices} in a run of {mesh.world} ranks")
    check_batch(args, mesh.world)
    args.device = str(mesh.device)
    return mesh


def resume(args, outdir: Optional[str], state, mesh) -> int:
    """``--do_resume``: restore ``outdir/ckpt_last``'s latest checkpoint
    into ``state`` and return the epoch after it (0 without one). The
    ranks of a data-parallel run meet at a barrier first, then each reads
    the same file (rank 0 wrote it)."""
    from countr_tpu_torch.engine import checkpoint as ckpt
    from countr_tpu_torch.parallel.dist import rank0_print

    if not (args.do_resume and outdir):
        return 0
    if mesh is not None:
        import torch.distributed as dist

        dist.barrier(group=mesh.host_group)
    last_dir = os.path.join(outdir, "ckpt_last")
    if ckpt.latest_step(last_dir) is None:
        return 0
    epoch = ckpt.restore_checkpoint(last_dir, state) + 1
    rank0_print(f"resumed epoch {epoch} from {last_dir}")
    return epoch


def build_engine(args, normalization: bool):
    """The CLIs' CountingEngine on ``args.device``; with ``--n_devices`` N
    > 1 each window chunk is split over N devices (``parallel.mesh
    .get_mesh``; ``--batch_windows`` a multiple of N)."""
    from countr_tpu_torch.engine.inference import CountingEngine

    n = getattr(args, "n_devices", 0)
    devices = None
    if n > 1:
        from countr_tpu_torch.parallel.mesh import get_mesh

        devices = get_mesh(n, args.device).devices
    return CountingEngine(
        build_counting_model(args),
        batch_windows=args.batch_windows,
        normalization=normalization,
        max_s_cnt=getattr(args, "max_s_cnt", 1),
        narrow_policy=getattr(args, "narrow_policy", "pad"),
        device=args.device,
        devices=devices,
        debug_nans=getattr(args, "debug_nans", False),
    )


def ensure_outdir(args) -> Optional[str]:
    if args.output_dir:
        os.makedirs(args.output_dir, exist_ok=True)
    return args.output_dir or None
