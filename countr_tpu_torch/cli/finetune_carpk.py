"""CARPK fine-tuning (1-shot car counting) on the port (counterpart of
``countr_tpu/cli/finetune_carpk.py``; reference: FSC_finetune_CARPK.py):
a local CARPK tree, one random exemplar per sample, the unmasked MSE, shot
1. The samples are made on the host by the loader's threads
(``data/carpk.py carpk_train_sample``) and uploaded ahead of the step from
pinned memory; with ``--resident_data`` the decoded split lives on the
card (``engine/carpk_store.py``) and each step ships an image index and
the exemplar's crop maps. On the card every step is replayed from a CUDA
graph captured before the first batch. Data parallel with ``--n_devices
N`` (or under torchrun), as ``cli/finetune.py`` describes: the global
``--batch_size`` must be a multiple of N, as the JAX CLI shards it over
its mesh.

Without ``--carpk_root`` the samples come from the Deep Lake hub stream
(``data/carpk.py CarpkHub``), and the CLI exits as the JAX package does
where the ``hub`` client does not import. ``--debug_nans`` runs eager
steps under anomaly detection (``common.nan_watched``).

Usage:
  python -m countr_tpu_torch.cli.finetune_carpk --carpk_root /data/CARPK \\
      --resume fsc147_weights.pth --epochs 30
  (add --device cpu to run on the CPU)
"""

from __future__ import annotations

import argparse
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
from countr_tpu_torch.utils.metrics import JsonlLogger


def get_args(argv=None):
    p = argparse.ArgumentParser("CARPK fine-tuning")
    common.add_model_args(p, default_model="mae_vit_base6_patch16")
    p.add_argument("--carpk_root", default="", type=str,
                   help="local CARPK directory (Images/ + Annotations/ [+ ImageSets/])")
    p.add_argument("--output_dir", default="./out_carpk", type=str)
    p.add_argument("--batch_size", default=1, type=int)
    p.add_argument("--epochs", default=30, type=int)
    p.add_argument("--warmup_epochs", default=2, type=int)
    p.add_argument("--blr", default=2e-4, type=float)
    p.add_argument("--lr", default=None, type=float)
    p.add_argument("--weight_decay", default=0.05, type=float)
    p.add_argument("--accum_iter", default=1, type=int)
    p.add_argument("--num_workers", default=4, type=int)
    p.add_argument("--limit_steps", default=0, type=int)
    p.add_argument("--n_devices", default=1, type=int, help=N_DEVICES_HELP)
    p.add_argument("--resident_data", action="store_true",
                   help="keep the decoded train split on the card and run the resize, crop, "
                        "density and exemplar preparation there (engine.carpk_store): the "
                        "host ships ~1.5 KB of geometry a sample instead of ~2.3 MB of pixels")
    return p.parse_args(argv)


class _TrainAdapter:
    """The CARPK source and the reference's train transform as a loader
    dataset; a sample's randomness is seeded by (seed, epoch, index)."""

    def __init__(self, source, seed: int):
        self.source = source
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return len(self.source)

    def __getitem__(self, idx: int):
        from countr_tpu_torch.data.carpk import carpk_train_sample

        rng = np.random.default_rng(np.random.SeedSequence([self.seed, self.epoch, idx]))
        return carpk_train_sample(rng, self.source[idx])


class FinetuneCarpk:
    """The CLI's run: the model, the training state, the loader or the
    store and the step, built by ``__init__`` (on the card the step's graph
    is captured there, before any batch), and ``run()``, the epochs.
    ``graphed``: None = CUDA graphs on the card; False = eager steps. A
    data-parallel rank (``common.init_ranks``) trains on its slice of each
    global batch; rank 0 alone prints, logs and checkpoints."""

    def __init__(self, args, graphed=None):
        from countr_tpu_torch.data.carpk import load_carpk
        from countr_tpu_torch.data.loader import DataLoader
        from countr_tpu_torch.engine import train as engine

        self.args = args
        if args.debug_nans:
            graphed = False
        self.mesh = mesh = common.init_ranks(args)
        self.rank, self.world = (mesh.rank, mesh.world) if mesh else (0, 1)
        self.main = self.rank == 0
        self.model = model = common.build_counting_model(args, training=True)
        self.device = next(model.parameters()).device
        self.outdir = common.ensure_outdir(args) if self.main else None
        self.jsonl = JsonlLogger(self.outdir)
        src = load_carpk("train", args.carpk_root)
        self.resident = args.resident_data
        self.store = self.dl = None
        if self.resident:
            from countr_tpu_torch.engine.carpk_store import build_carpk_store

            self.store = build_carpk_store(src, self.device)
            steps = len(src) // args.batch_size
        else:
            self.dl = DataLoader(_TrainAdapter(src, args.seed), args.batch_size, shuffle=True,
                                 num_workers=args.num_workers, drop_last=True, seed=args.seed,
                                 process_index=self.rank, process_count=self.world)
            steps = len(self.dl)
        self.steps_per_epoch = max(min(steps, args.limit_steps or steps), 1)

        # the unmasked MSE: the reference's pixel mask is commented out for
        # CARPK (reference: FSC_finetune_CARPK.py:250-252)
        self.tcfg = TrainConfig(
            batch_size=args.batch_size, epochs=args.epochs, warmup_epochs=args.warmup_epochs,
            blr=args.blr, lr=args.lr, weight_decay=args.weight_decay,
            accum_iter=args.accum_iter, seed=args.seed, loss_mask_p=1.0)
        self.state = engine.init_train_state(
            model, self.tcfg, self.steps_per_epoch,
            args.batch_size * args.accum_iter, mesh)  # the effective batch scales blr
        self.generator = torch.Generator(device=self.device)
        if self.resident:
            self.step = engine.make_carpk_store_step(self.state, self.tcfg, self.store.arrays,
                                                     self.generator, graphed=graphed)
            self.batch_keys = engine.CARPK_KEYS
        else:
            step = engine.make_finetune_step(self.state, self.tcfg, self.generator,
                                             graphed=graphed)

            def shot1(batch):
                return step(batch, 1)

            if hasattr(step, "runner"):
                shot1.runner = step.runner
                shot1.capture = lambda batch: step.capture(batch, 1)
            self.step = shot1
            self.batch_keys = engine.FINETUNE_KEYS
        self.capture_s = self._capture() if hasattr(self.step, "capture") else 0.0

    def _capture(self) -> float:
        """Capture the step's graphs on a batch of the loader's (or the
        geometry's) shapes and dtypes; returns seconds."""
        from countr_tpu_torch.engine.carpk_store import EX

        t0 = time.perf_counter()
        b, hw, dev = self.args.batch_size // self.world, self.model.cfg.img_size, self.device
        if self.resident:
            # a valid geometry (the warm-up runs it): image 0, every tap at 0
            i32 = torch.zeros((b, EX), dtype=torch.int32, device=dev)
            f32 = torch.zeros((b, EX), device=dev)
            batch = {"img_idx": torch.zeros((b,), dtype=torch.int32, device=dev), "bx0": i32,
                     "bx1": i32, "bwx": f32, "by0": i32, "by1": i32, "bwy": f32,
                     "ex_valid": torch.ones((b,), device=dev)}
        else:
            batch = {"image": torch.zeros((b, hw, hw, 3), device=dev),
                     "gt_density": torch.zeros((b, hw, hw), device=dev),
                     "boxes": torch.zeros((b, 3, 64, 64, 3), device=dev)}
        self.step.capture(batch)
        torch.cuda.synchronize(dev)
        return time.perf_counter() - t0

    def graphs(self) -> int:
        """The CUDA graphs captured so far (0 for eager steps)."""
        return len(self.step.runner) if hasattr(self.step, "runner") else 0

    def batches(self, epoch: int) -> Iterator[Dict]:
        """The epoch's host batches: the loader's samples, or on the
        resident path each batch's indices and exemplar maps, from per-epoch
        seeded streams (a resumed run at epoch N would draw what an
        uninterrupted run draws at epoch N); a rank's rows of each global
        batch."""
        from countr_tpu_torch.parallel.mesh import rows_of

        if not self.resident:
            yield from self.dl.epoch(epoch)
            return
        from countr_tpu_torch.engine.carpk_store import exemplar_geometry

        seed, bs, n = self.args.seed, self.args.batch_size, self.store.n_images
        host_rng = np.random.default_rng(np.random.SeedSequence([seed, epoch, 1]))
        order = np.random.default_rng(np.random.SeedSequence([seed, epoch])).permutation(n)
        for base in range(0, n - bs + 1, bs):
            idxs = order[base : base + bs]
            geo = exemplar_geometry(host_rng, self.store, idxs)
            geo["img_idx"] = idxs.astype(np.int32)
            yield {k: rows_of(v, self.rank, self.world) for k, v in geo.items()}

    def step_metrics(self, batches: Iterator[Dict]) -> Iterator[Dict]:
        """Train on ``batches`` (on the device): each step's metrics."""
        for batch in batches:
            yield self.step(batch)

    def train_epoch(self, epoch: int) -> Dict:
        """One epoch of steps; returns the host sums of the metrics and the
        number of steps."""
        from countr_tpu_torch.data.loader import device_prefetch

        args = self.args
        self.generator.manual_seed(epoch_seed(args.seed, epoch))
        batches = device_prefetch(self.batches(epoch), self.device, self.batch_keys)
        if args.limit_steps:
            batches = itertools.islice(batches, args.limit_steps)
        metrics = self.step_metrics(batches)
        if args.debug_nans:
            metrics = common.nan_watched(metrics, lambda i: f"epoch {epoch} step {i}")
        totals, n = None, 0
        for m in metrics:
            totals = m if totals is None else {k: totals[k] + m[k] for k in totals}
            n += 1
            if n % 32 == 0 and not torch.isfinite(totals["loss"]):
                raise SystemExit(f"Loss is not finite at epoch {epoch}")
        sums = {k: float(v) for k, v in totals.items()} if totals else {}
        return {"loss": sums.get("loss", 0.0), "mae": sums.get("mae", 0.0), "steps": n}

    def run_epoch(self, epoch: int) -> Dict:
        from countr_tpu_torch.engine import checkpoint as ckpt

        t0 = time.time()
        tr = self.train_epoch(epoch)
        n = max(tr["steps"], 1)
        stats = {"epoch": epoch, "train/loss": tr["loss"] / n, "train/MAE": tr["mae"] / n,
                 "epoch_time_s": time.time() - t0}
        if not np.isfinite(stats["train/loss"]):
            raise SystemExit(f"Loss is not finite at epoch {epoch}")
        rank0_print(f"[CARPK e{epoch}] loss {stats['train/loss']:.4f} "
                    f"MAE {stats['train/MAE']:.2f}", flush=True)
        self.jsonl.write(stats)
        if self.outdir:
            ckpt.save_checkpoint(os.path.join(self.outdir, "ckpt_last"), epoch, self.state,
                                 keep=1)
        return stats

    def run(self) -> List[Dict]:
        try:
            return [self.run_epoch(e) for e in range(self.args.epochs)]
        finally:
            self.close()

    def close(self) -> None:
        if self.dl is not None:
            self.dl.close()


def main(args, graphed=None) -> List[Dict]:
    """Fine-tune on CARPK per ``args``; returns each epoch's stats (rank
    0's, when ``--n_devices`` starts the ranks here)."""
    launched = common.launch_ranks(main, args)
    if launched is not None:
        return launched
    return FinetuneCarpk(args, graphed=graphed).run()


def _entry():
    from countr_tpu_torch.parallel import dist

    try:
        main(get_args())
    finally:
        dist.destroy()


if __name__ == "__main__":
    _entry()
