"""MAE self-supervised pretraining on FSC147 images on the port
(counterpart of ``countr_tpu/cli/pretrain.py``; reference: FSC_pretrain.py):
mask ratio 0.5, AdamW(0.9, 0.95) at blr * batch / 256, warmup-cosine,
periodic, last and params-only checkpoints (``cli.finetune
--init_from_mae`` reads the params-only ones), and the reconstruction
panel in TensorBoard where it imports.

Samples are RandomResizedCrop(img_size, bicubic) + flip crops (the model's
img_size: 384, or 378 for mae_vit_huge_patch14) made by PIL on the
loader's threads (or processes) and uploaded ahead of the step from pinned
memory (``data/loader.py device_prefetch``). With ``--resident_data`` the
decoded train split lives on the card as a column-major uint8 pool
(``engine/train_store.py PretrainStore``), the host draws only each crop's
scalars (~30 bytes a sample), and the step materialises the crops with two
bicubic band products. On the card every step is replayed from a CUDA graph
captured before the first batch. Data parallel with ``--n_devices N`` (or
under torchrun), as ``cli/finetune.py`` describes: each rank loads its
slice of the global batch and draws the masking noise at the global
batch's shape, keeping its rows. The optional W&B run (``--wandb_project``)
gets what the JAX CLI logs: the step scalars every ``--log_every`` global
steps, each epoch's record, and the periodic and params-only checkpoints
as the ``pretrain_periodic`` and ``pretrain_params`` artifacts.
``--debug_nans`` runs eager steps under anomaly detection
(``common.nan_watched``).

Usage:
  python -m countr_tpu_torch.cli.pretrain --data_path ./data/FSC147 \\
      --epochs 500 --batch_size 16 --blr 1.5e-4 [--resident_data]
  (add --device cpu to run on the CPU)
"""

from __future__ import annotations

import argparse
import functools
import itertools
import os
import time
from typing import Dict, Iterator, List

import numpy as np
import torch

from countr_tpu_torch.cli import common
from countr_tpu_torch.cli.finetune import N_DEVICES_HELP, epoch_seed
from countr_tpu_torch.config import TrainConfig
from countr_tpu_torch.parallel.dist import rank0_print
from countr_tpu_torch.utils.metrics import JsonlLogger, TBWriter
from countr_tpu_torch.utils.profiling import span


def get_args(argv=None):
    p = argparse.ArgumentParser("MAE pre-training")
    common.add_data_args(p)
    common.add_model_args(p, default_model="mae_vit_base_patch16")
    p.add_argument("--mask_ratio", default=0.5, type=float)
    p.add_argument("--norm_pix_loss", action="store_true")
    p.add_argument("--masked_loss", action="store_true",
                   help="average the loss over the masked patches only (standard MAE) "
                        "instead of the reference's all-patch mean")
    p.add_argument("--batch_size", default=16, type=int)
    p.add_argument("--epochs", default=500, type=int)
    p.add_argument("--warmup_epochs", default=10, type=int)
    p.add_argument("--blr", default=1.5e-4, type=float, help="base lr; lr = blr * batch / 256")
    p.add_argument("--lr", default=None, type=float)
    p.add_argument("--min_lr", default=0.0, type=float)
    p.add_argument("--weight_decay", default=0.05, type=float)
    p.add_argument("--accum_iter", default=1, type=int)
    p.add_argument("--num_workers", default=8, type=int)
    p.add_argument("--resident_data", action="store_true",
                   help="upload the decoded train split to the card once; the "
                        "RandomResizedCrop and flip run there from the crop's scalars "
                        "(~30 B a sample over the wire; see "
                        "countr_tpu_torch.engine.train_store)")
    p.add_argument("--use_processes", action="store_true",
                   help="process-pool data workers (GIL-free augmentation on many-core hosts)")
    p.add_argument("--ckpt_every", default=100, type=int)
    p.add_argument("--ckpt_last_every", default=1, type=int,
                   help="epochs between crash-resume 'last' checkpoints (a full-size MAE "
                        "training state is ~1.3 GB; raise on slow disks)")
    p.add_argument("--do_resume", action="store_true",
                   help="resume the full training state from output_dir/ckpt_last")
    p.add_argument("--log_every", default=50, type=int,
                   help="steps between train loss / lr scalars (0 = per epoch only; "
                        "reference cadence: FSC_finetune_cross.py:320-326)")
    p.add_argument("--recon_every", default=2000, type=int,
                   help="steps between reconstruction panels in TensorBoard "
                        "(reference: FSC_pretrain.py:267-291)")
    p.add_argument("--limit_steps", default=0, type=int, help="cap steps/epoch (smoke tests)")
    p.add_argument("--n_devices", default=0, type=int, help=N_DEVICES_HELP)
    return p.parse_args(argv)


def load_mae_weights(model, state_dict) -> None:
    """Load the MAE's learned tensors from a reference-layout state_dict,
    as the JAX package's ``convert_mae_state_dict`` takes them: a missing
    one raises, other keys (a released checkpoint's cls token and its
    position embedding) are ignored, and the fixed sin-cos position
    embeddings stay the model's."""
    from countr_tpu_torch.engine import checkpoint as ckpt

    learned = {name for name, _ in model.named_parameters()}
    missing = sorted(learned - set(state_dict))
    if missing:
        raise KeyError(f"the MAE checkpoint lacks {missing}")
    sd = dict(model.state_dict())
    sd.update({k: v for k, v in state_dict.items() if k in learned})
    ckpt.load_weights(model, sd)


def build_mae_model(args):
    """The MAE on ``args.device``: in the bf16 modes (every ``--dtype`` but
    fp32 builds bf16, as the JAX package's ``parse_dtype`` does) with the
    kernels B1 and B3/B4, tanh GELU (``--exact_gelu``: erf) and the fused
    half-block B2 off, which wins forward-only but costs time where the
    encoder trains (``countr_tpu/cli/pretrain.py:90-96``). Weights per
    ``--resume``: a reference ``.pth``, a directory of the port's
    checkpoints (the latest step), or random from ``--seed``."""
    from countr_tpu_torch.engine import checkpoint as ckpt
    from countr_tpu_torch.models import build_mae

    dtype = "fp32" if args.dtype == "fp32" else "bf16"
    over = dict(mask_ratio=args.mask_ratio, norm_pix_loss=args.norm_pix_loss)
    if dtype == "bf16" and args.exact_gelu:
        over["approx_gelu"] = False
    model = build_mae(args.model, dtype=dtype, device=args.device, seed=args.seed,
                      masked_loss=args.masked_loss, **over)
    if args.resume:
        load_mae_weights(model, ckpt.load_torch_checkpoint(args.resume)
                         if args.resume.endswith(".pth") else ckpt.restore_params(args.resume))
        print(f"initialized from MAE checkpoint {args.resume}")
    return model


def reconstruction_panel(model, imgs: torch.Tensor, noise=None, generator=None) -> np.ndarray:
    """The masked input, the reconstruction and the original of ``imgs[0]``
    side by side, [H, 3W, 3] in [0, 1] (reference: FSC_pretrain.py:267-291);
    the masking noise [1, L] is ``noise`` or drawn from ``generator``."""
    from countr_tpu_torch.models.mae import patchify, unpatchify
    from countr_tpu_torch.models.vit import casts_at_use

    p = model.cfg.patch_size
    img = imgs[:1]
    with torch.no_grad(), casts_at_use():  # no cached bf16 copy of the weights
        _, pred, mask = model(img, noise=noise, generator=generator)
        recon = unpatchify(pred.float(), p)
        masked = unpatchify(patchify(img, p) * (1 - mask)[..., None], p)
        panel = torch.cat([masked[0], recon[0], img[0]], dim=1)
    return np.clip(panel.cpu().numpy(), 0, 1)


def _recon_seed(seed: int, step: int) -> int:
    """The seed of a reconstruction panel's masking noise at ``step`` (its
    own generator: the step's draws stay as they are)."""
    return int(np.random.SeedSequence([seed, step, 1]).generate_state(1, np.uint64)[0]) >> 1


class Pretrain:
    """The CLI's run: the model, the training state, the loader (and on
    ``--resident_data`` the store) and the step, built by ``__init__`` (on
    the card the step's graphs are captured there, before any batch), and
    ``run()``, the epochs. ``graphed``: None = CUDA graphs on the card;
    False = eager steps. A data-parallel rank (``common.init_ranks``)
    trains on its slice of each global batch; rank 0 alone prints, logs
    and checkpoints."""

    def __init__(self, args, graphed=None):
        from countr_tpu_torch.data.fsc147 import PretrainDataset
        from countr_tpu_torch.data.loader import DataLoader
        from countr_tpu_torch.engine import train as engine
        from countr_tpu_torch.engine import train_store

        self.args = args
        if args.debug_nans:
            graphed = False
        self.mesh = mesh = common.init_ranks(args)
        self.rank, self.world = (mesh.rank, mesh.world) if mesh else (0, 1)
        self.main = self.rank == 0
        meta = common.load_meta(args)
        self.model = model = build_mae_model(args)
        self.device = next(model.parameters()).device
        # the crop is the model's img_size on both paths: refused here, before
        # the store and the step, where the model's patches cannot tile it
        self.img_size = model.cfg.img_size
        train_store.check_pretrain_crop(self.img_size, model.cfg.patch_size)
        self.outdir = common.ensure_outdir(args) if self.main else (args.output_dir or None)
        logs = self.outdir if self.main else None
        self.jsonl = JsonlLogger(logs)
        self.tb = TBWriter(os.path.join(logs, "tb") if logs else None)
        self.wandb = common.make_wandb(args, enabled=self.main)
        self.resident = args.resident_data
        self.store = None
        if self.resident:
            self.store = train_store.build_pretrain_store(meta, meta.splits["train"], self.device)
        self.train_ds = PretrainDataset(meta, seed=args.seed,
                                        store=self.store.catalog if self.resident else None,
                                        img_size=self.img_size)
        self.train_dl = DataLoader(self.train_ds, args.batch_size, shuffle=True,
                                   num_workers=args.num_workers, drop_last=True, seed=args.seed,
                                   use_processes=args.use_processes, process_index=self.rank,
                                   process_count=self.world)
        self.steps_per_epoch = len(self.train_dl)
        if args.limit_steps:
            self.steps_per_epoch = min(self.steps_per_epoch, args.limit_steps)

        self.tcfg = TrainConfig(
            batch_size=args.batch_size, epochs=args.epochs, warmup_epochs=args.warmup_epochs,
            blr=args.blr, lr=args.lr, min_lr=args.min_lr, weight_decay=args.weight_decay,
            accum_iter=args.accum_iter, seed=args.seed, output_dir=args.output_dir,
        )
        self.state = engine.init_train_state(
            model, self.tcfg, self.steps_per_epoch,
            args.batch_size * args.accum_iter, mesh)  # the effective batch scales blr
        self.generator = gen = torch.Generator(device=self.device)
        if self.resident:
            self.train_step = engine.make_store_pretrain_step(
                self.state, self.tcfg, self.store.arrays, self.store.max_w, gen, graphed=graphed)
            self.batch_keys = train_store.PRETRAIN_KEYS
        else:
            self.train_step = engine.make_pretrain_step(self.state, self.tcfg, gen,
                                                        graphed=graphed)
            self.batch_keys = ("image",)
        self.capture_s = self._capture() if hasattr(self.train_step, "capture") else 0.0

        self.start_epoch = common.resume(args, self.outdir, self.state, mesh)

    def _inputs(self, batch: Dict):
        """The step's argument of a batch on the device."""
        return batch if self.resident else batch["image"]

    def _capture(self) -> float:
        """Capture the step's graphs (its accumulate and update pair under
        accumulation) on a batch of the loader's shapes and dtypes; returns
        seconds."""
        t0 = time.perf_counter()
        b, hw, dev = self.args.batch_size // self.world, self.model.cfg.img_size, self.device
        if self.resident:
            # a valid crop (the warm-up runs it): image 0's top-left hw^2, inside
            # its stored 384-row layout for every hw up to 384
            i32 = functools.partial(torch.full, dtype=torch.int32, device=dev)
            i8 = functools.partial(torch.zeros, dtype=torch.int8, device=dev)
            batch = {"img_idx": i32((b,), 0), "crop_top": i32((b,), 0),
                     "crop_left": i32((b,), 0), "crop_h": i32((b,), hw), "crop_w": i32((b,), hw),
                     "transposed": i8((b,)), "flip": i8((b,))}
        else:
            batch = {"image": torch.zeros((b, hw, hw, 3), device=dev)}
        self.train_step.capture(self._inputs(batch))
        torch.cuda.synchronize(dev)
        return time.perf_counter() - t0

    def graphs(self) -> int:
        """The CUDA graphs captured so far (0 for eager steps)."""
        return len(self.train_step.runner) if hasattr(self.train_step, "runner") else 0

    def step_metrics(self, batches: Iterator[Dict], gstep: int) -> Iterator[Dict]:
        """Train on ``batches`` (on the device), the first at global step
        ``gstep``: each step's metrics. Every ``--log_every`` global steps
        the step's loss and learning rate go to TensorBoard and stdout,
        every ``--recon_every`` the reconstruction panel to TensorBoard."""
        args = self.args
        for batch in batches:
            m = self.train_step(self._inputs(batch))
            gstep += 1
            if args.log_every and gstep % args.log_every == 0 and self.main:
                with span("train.log"):
                    loss, lr = float(m["loss"]), float(self.state.schedule(gstep))
                    self.wandb.log({"train/loss_step": loss, "train/lr_step": lr}, step=gstep)
                    self.tb.scalar("train/loss_step", loss, gstep)
                    self.tb.scalar("train/lr_step", lr, gstep)
                    print(f"[step {gstep}] loss {loss:.4f} lr {lr:.3e}", flush=True)
            if args.recon_every and gstep % args.recon_every == 0 and self.tb.enabled:
                self._log_reconstruction(batch, gstep)
            yield m

    def _log_reconstruction(self, batch: Dict, gstep: int) -> None:
        if self.resident:
            from countr_tpu_torch.engine.train_store import materialize_pretrain_batch

            with torch.no_grad():
                imgs = materialize_pretrain_batch(
                    self.store.arrays, {k: batch[k][:1] for k in self.batch_keys},
                    self.store.max_w, self.img_size)
        else:
            imgs = batch["image"]
        gen = torch.Generator(device=self.device).manual_seed(_recon_seed(self.args.seed, gstep))
        self.tb.image("pretrain/reconstruction", reconstruction_panel(self.model, imgs,
                                                                      generator=gen), gstep)

    def train_epoch(self, epoch: int) -> Dict:
        """One epoch of steps on the loader's batches; returns the host sum
        of the losses and the number of steps."""
        from countr_tpu_torch.data.loader import device_prefetch

        args = self.args
        self.generator.manual_seed(epoch_seed(args.seed, epoch))
        batches = device_prefetch(self.train_dl.epoch(epoch), self.device, self.batch_keys)
        if args.limit_steps:
            batches = itertools.islice(batches, args.limit_steps)
        metrics = self.step_metrics(batches, epoch * self.steps_per_epoch)
        if args.debug_nans:
            metrics = common.nan_watched(metrics, lambda i: f"epoch {epoch} step {i}")
        total, n = None, 0
        for m in metrics:
            total = m["loss"] if total is None else total + m["loss"]
            n += 1
            if n % 32 == 0 and not torch.isfinite(total):
                # the running sum catches a NaN of any step in the window
                raise SystemExit(f"Loss is not finite at epoch {epoch}")
        return {"loss": float(total) if total is not None else 0.0, "steps": n}

    def run_epoch(self, epoch: int) -> Dict:
        """Train, log and keep checkpoints for ``epoch``; returns its
        stats."""
        t0 = time.time()
        tr = self.train_epoch(epoch)
        if not np.isfinite(tr["loss"]):
            raise SystemExit(f"Loss is not finite at epoch {epoch}")
        stats = {
            "epoch": epoch,
            "train/loss": tr["loss"] / max(tr["steps"], 1),
            "lr": float(self.state.schedule(epoch * self.steps_per_epoch)),
            "epoch_time_s": time.time() - t0,
        }
        rank0_print(f"[Epoch {epoch}] loss {stats['train/loss']:.4f} lr {stats['lr']:.2e} "
                    f"({stats['epoch_time_s']:.1f}s)", flush=True)
        self.jsonl.write(stats)
        self.tb.scalar("train/loss", stats["train/loss"], epoch)
        # the global step axis of the per-step scalars
        self.wandb.log(stats, step=(epoch + 1) * self.steps_per_epoch)
        self._keep(epoch)
        return stats

    def _keep(self, epoch: int) -> None:
        """Periodic checkpoints (keep 5) every ``--ckpt_every`` epochs and at
        the last; the crash-resume one (keep 1) and the params-only one that
        ``cli.finetune --init_from_mae`` reads (keep 1) every
        ``--ckpt_last_every`` epochs and at the last. W&B gets the periodic
        and the params-only directories as artifacts (reference:
        util/misc.py:331-335)."""
        from countr_tpu_torch.engine import checkpoint as ckpt

        if not self.outdir or not self.main:
            return
        args = self.args
        last = epoch + 1 == args.epochs
        if (args.ckpt_every and (epoch + 1) % args.ckpt_every == 0) or last:
            ckpt.save_checkpoint(os.path.join(self.outdir, "ckpt_periodic"), epoch, self.state,
                                 keep=5)
            self.wandb.log_artifact(os.path.join(self.outdir, "ckpt_periodic"),
                                    "pretrain_periodic")
        if epoch % max(1, args.ckpt_last_every) == 0 or last:
            ckpt.save_checkpoint(os.path.join(self.outdir, "ckpt_last"), epoch, self.state,
                                 keep=1)
            ckpt.save_checkpoint(os.path.join(self.outdir, "ckpt_params"), epoch, self.model,
                                 keep=1)
            self.wandb.log_artifact(os.path.join(self.outdir, "ckpt_params"), "pretrain_params")

    def run(self) -> List[Dict]:
        try:
            return [self.run_epoch(e) for e in range(self.start_epoch, self.args.epochs)]
        finally:
            self.close()

    def close(self) -> None:
        self.train_dl.close()
        self.tb.flush()


def main(args, graphed=None) -> List[Dict]:
    """Pretrain per ``args``; returns each epoch's stats (rank 0's, when
    ``--n_devices`` starts the ranks here)."""
    launched = common.launch_ranks(main, args)
    if launched is not None:
        return launched
    return Pretrain(args, graphed=graphed).run()


def _entry():
    from countr_tpu_torch.parallel import dist

    try:
        main(get_args())
    finally:
        dist.destroy()


if __name__ == "__main__":
    _entry()
