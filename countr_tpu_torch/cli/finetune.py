"""FSC147 supervised fine-tuning of the counting decoder on the port
(counterpart of ``countr_tpu/cli/finetune.py``).

The encoder is frozen (``--unfreeze_encoder`` trains it), the loss is the
masked MSE, each batch draws its shot number with the m_flag rule, and
each epoch validates (MAE, RMSE, NAE) and keeps periodic, last and
minimum-MAE checkpoints (reference: FSC_finetune_cross.py). Samples are
augmented on the host by the loader's threads (or processes); with
``--device_aug`` the host does the geometry and the card the photometric
chain inside the step; with ``--resident_data`` the decoded train and
validation splits live on the card (``engine/train_store.py``), the host
draws only each sample's geometry, and the step materialises the pixels
(``--resident_pipeline``: one batch ahead, trajectory-exact, opt-in). The
loader's batches are uploaded ahead of the step from pinned memory
(``data/loader.py device_prefetch``). On the card every step, eval and
materialisation is replayed from a CUDA graph, all captured before the
first batch.

Data parallel with ``--n_devices N`` (or under ``torchrun
--nproc_per_node N``): one rank per card (gloo processes with ``--device
cpu``); ``--batch_size`` stays the global batch, each rank loads its slice,
and the step averages the gradients and metrics across the ranks inside
its graph (``engine/train.py TrainState``). Rank 0 alone prints, logs and
writes checkpoints.

Logging, as the JAX CLI logs: ``log.txt`` (one JSON line an epoch);
TensorBoard under ``<output_dir>/tb`` and the optional W&B run
(``--wandb_project``): ``train/loss_step`` and ``train/lr_step`` every
``--log_every`` steps at the global step, each epoch's stats (TensorBoard
at the epoch, W&B at the global step that ends it), and every
``--panel_every`` epochs, in a single process, the ``val/density_<name>``
panels of the first four validation samples (GT overlay | prediction |
prediction overlay), whose forward is replayed on the card from a CUDA
graph captured with the others. W&B also gets the minimum-MAE checkpoint
as the ``finetuning_minMAE`` artifact. ``--debug_nans`` runs eager steps
under anomaly detection (``common.nan_watched``).

Usage:
  python -m countr_tpu_torch.cli.finetune --data_path ./data/FSC147 \\
      --model mae_vit_base6_patch16 --epochs 1000 --batch_size 8 --blr 2e-4
  (add --device cpu to run on the CPU)
"""

from __future__ import annotations

import argparse
import functools
import itertools
import os
import random
import time
from typing import Dict, Iterator, List

import numpy as np
import torch

from countr_tpu_torch.cli import common
from countr_tpu_torch.config import TrainConfig
from countr_tpu_torch.parallel.dist import rank0_print
from countr_tpu_torch.utils.metrics import JsonlLogger, TBWriter
from countr_tpu_torch.utils.profiling import span


def get_args(argv=None):
    p = argparse.ArgumentParser("FSC147 fine-tuning")
    common.add_data_args(p)
    common.add_model_args(p, default_model="mae_vit_base6_patch16")
    p.add_argument("--batch_size", default=8, type=int)
    p.add_argument("--epochs", default=1000, type=int)
    p.add_argument("--warmup_epochs", default=10, type=int)
    p.add_argument("--blr", default=2e-4, type=float, help="base lr; lr = blr * batch / 256")
    p.add_argument("--lr", default=None, type=float)
    p.add_argument("--min_lr", default=0.0, type=float)
    p.add_argument("--weight_decay", default=0.05, type=float)
    p.add_argument("--accum_iter", default=1, type=int)
    p.add_argument("--no_aug", action="store_true", help="disable train-time augmentation")
    p.add_argument("--device_aug", action="store_true",
                   help="run the photometric augmentation and the density synthesis on "
                        "the card inside the train step (uint8 geometry on the host; a "
                        "quarter of the upload; see countr_tpu_torch.ops.augment)")
    p.add_argument("--resident_data", action="store_true",
                   help="upload the decoded train and validation splits to the card once "
                        "and materialise every augmented batch there from per-sample "
                        "geometry (~KBs a step over the wire; see "
                        "countr_tpu_torch.engine.train_store)")
    p.add_argument("--resident_pipeline", action="store_true",
                   help="with --resident_data: materialise batch j+1 in the step that "
                        "trains batch j (the same trajectory, one batch behind; opt-in)")
    p.add_argument("--num_workers", default=8, type=int)
    p.add_argument("--use_processes", action="store_true",
                   help="process-pool data workers (GIL-free augmentation on many-core hosts)")
    p.add_argument("--ckpt_every", default=50, type=int)
    p.add_argument("--ckpt_last_every", default=1, type=int,
                   help="epochs between crash-resume 'last' checkpoints (the reference "
                        "saves every epoch)")
    p.add_argument("--do_resume", action="store_true",
                   help="resume the full training state from output_dir/ckpt_last")
    p.add_argument("--init_from_mae", default="", type=str,
                   help="MAE pretrain checkpoint to initialise the encoder from: a reference "
                        ".pth, or a directory of the port's checkpoints")
    p.add_argument("--init_from_mae_model", default="mae_vit_base_patch16", type=str,
                   help="MAE preset of a checkpoint directory given to --init_from_mae "
                        "(its encoder width and depth must match)")
    p.add_argument("--limit_steps", default=0, type=int, help="cap steps/epoch (smoke tests)")
    p.add_argument("--n_devices", default=0, type=int, help=N_DEVICES_HELP)
    p.add_argument("--panel_every", default=10, type=int,
                   help="epochs between validation density panels in TensorBoard and W&B "
                        "(0 = off; reference: FSC_finetune_cross.py:352-405)")
    p.add_argument("--log_every", default=50, type=int,
                   help="steps between train loss / lr scalars in TensorBoard and W&B (0 = per "
                        "epoch only; reference: FSC_finetune_cross.py:320-326)")
    return p.parse_args(argv)


N_DEVICES_HELP = ("data-parallel ranks, one per card (gloo processes with --device cpu), "
                  "started here unless run under torchrun (0 or 1: one process); "
                  "--batch_size is the global batch and must be a multiple of N")


def sample_shot_num(rng: random.Random, m_flags: np.ndarray, mesh=None) -> int:
    """0-3 shots, but a Type-2 mosaic in the batch bans 0-shot
    (reference: FSC_finetune_cross.py:277-284). The mosaic test spans the
    global batch (``parallel.mesh.global_any``), so that every rank draws
    the same shot from its identically seeded ``rng``."""
    from countr_tpu_torch.parallel.mesh import global_any

    return rng.randint(1 if global_any(m_flags, mesh) else 0, 3)


def epoch_seed(seed: int, epoch: int) -> int:
    """The seed of the step's generator (the augmentation's factors and
    the loss masks) for ``epoch``: a run resumed at epoch N draws what the
    uninterrupted run draws there."""
    return int(np.random.SeedSequence([seed, epoch]).generate_state(1, np.uint64)[0]) >> 1


def val_positions(n: int, batch: int, rank: int, world: int):
    """A rank's validation samples: global batches of ``batch`` over n
    samples, each split into ``world`` contiguous parts, the last batch
    padded. Returns (sample index, valid) per position, batch // world
    positions a batch; a padding position repeats sample n - 1 with valid
    0, as one process pads its last batch."""
    from countr_tpu_torch.parallel.mesh import rows_of

    pos = [rows_of(np.arange(g * batch, (g + 1) * batch), rank, world)
           for g in range(-(-n // batch))]
    pos = np.concatenate(pos) if pos else np.zeros(0, np.int64)
    return np.minimum(pos, n - 1), (pos < n).astype(np.float32)


class _Positions:
    """``dataset`` at the positions ``index`` (a loader's dataset)."""

    def __init__(self, dataset, index):
        self.dataset = dataset
        self.index = index

    def __len__(self) -> int:
        return len(self.index)

    def __getitem__(self, i: int):
        return self.dataset[int(self.index[i])]


def init_encoder(model, path: str, mae_model: str = "mae_vit_base_patch16") -> None:
    """Load the ViT encoder (patch_embed, blocks, norm) of an MAE
    checkpoint into ``model``: a reference ``.pth`` (the layout of
    ``mae_state_dict_from_flax``), or a directory of the port's
    checkpoints (the latest step) of the MAE preset ``mae_model``, whose
    encoder width and depth the checkpoint must have (as the JAX CLI
    restores into that preset's template). The reference's non-strict
    load of the pretrain checkpoint (util/misc.py:363-376)."""
    from countr_tpu_torch.engine import checkpoint as ckpt
    from countr_tpu_torch.engine.train import transfer_encoder

    if path.endswith(".pth"):
        sd = ckpt.load_torch_checkpoint(path)
    else:
        sd = ckpt.restore_params(path)
        check_mae_preset(sd, mae_model)
    ckpt.load_weights(model, transfer_encoder(sd, model.state_dict(), depth=model.cfg.depth))


def check_mae_preset(state_dict, name: str) -> None:
    """Raise unless the MAE state dict has preset ``name``'s encoder width
    and depth."""
    from countr_tpu_torch.config import MAE_PRESETS

    cfg = MAE_PRESETS[name]
    width = int(state_dict["patch_embed.proj.weight"].shape[0])
    depth = len({k.split(".")[1] for k in state_dict if k.startswith("blocks.")})
    if (width, depth) != (cfg.embed_dim, cfg.depth):
        raise ValueError(f"--init_from_mae: the checkpoint's encoder is {depth} x {width}; "
                         f"--init_from_mae_model {name} is {cfg.depth} x {cfg.embed_dim}")


def val_panel(sample: Dict, density: np.ndarray) -> np.ndarray:
    """A validation sample's [H, 3W, 3] triptych: GT overlay | prediction
    | prediction overlay, the density in the red channel (the JAX
    ``_log_val_panels``; reference W&B panels: FSC_finetune_cross.py:
    352-405)."""
    img = sample["image"]
    zeros = np.zeros_like(sample["gt_density"])
    gt = np.stack([sample["gt_density"], zeros, zeros], -1)
    pred = np.stack([density, np.zeros_like(density), np.zeros_like(density)], -1)
    return np.concatenate([np.clip(img / 2 + gt, 0, 1), np.clip(pred, 0, 1),
                           np.clip(img / 2 + pred, 0, 1)], axis=1)


N_PANELS = 4  # validation samples a panel epoch shows (countr_tpu/cli/finetune.py:524)


def _zeros(shape, dtype, device) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=device)


class Finetune:
    """The CLI's run: the model, the training state, the loaders (and on
    ``--resident_data`` the stores) and the steps, built by ``__init__``
    (on the card every graph is captured there, before any batch), and
    ``run()``, the epochs. ``graphed``: None = CUDA graphs on the card;
    False = eager steps. As a data-parallel rank (``common.init_ranks``)
    it trains on its slice of each global batch and validates its part of
    each validation batch; rank 0 alone prints, logs and checkpoints."""

    def __init__(self, args, graphed=None):
        from countr_tpu_torch.data.fsc147 import TrainDataset, ValDataset
        from countr_tpu_torch.data.loader import DataLoader
        from countr_tpu_torch.engine import train as engine

        self.args = args
        if args.debug_nans:
            graphed = False
        self.mesh = mesh = common.init_ranks(args)
        self.rank, self.world = (mesh.rank, mesh.world) if mesh else (0, 1)
        self.main = self.rank == 0
        meta = common.load_meta(args)
        self.model = model = common.build_counting_model(args, training=True)
        self.device = next(model.parameters()).device
        if args.init_from_mae:
            init_encoder(model, args.init_from_mae, args.init_from_mae_model)
            rank0_print(f"initialized encoder from {args.init_from_mae}")
        self.outdir = common.ensure_outdir(args) if self.main else (args.output_dir or None)
        logs = self.outdir if self.main else None
        self.jsonl = JsonlLogger(logs)
        self.tb = TBWriter(os.path.join(logs, "tb") if logs else None)
        self.wandb = common.make_wandb(args, enabled=self.main)
        self.device_aug = args.device_aug and not args.no_aug
        self.resident = args.resident_data and not args.no_aug
        self.pipelined = self.resident and args.resident_pipeline

        self.store = self.val_store = None
        if self.resident:
            from countr_tpu_torch.engine.train_store import build_store

            self.store = build_store(meta, meta.splits["train"], self.device)
        self.train_ds = TrainDataset(meta, do_aug=not args.no_aug, seed=args.seed,
                                     device_aug=self.device_aug,
                                     store_index=self.store.index if self.resident else None)
        self.val_ds = ValDataset(meta)
        self.train_dl = DataLoader(self.train_ds, args.batch_size, shuffle=True,
                                   num_workers=args.num_workers, drop_last=True, seed=args.seed,
                                   use_processes=args.use_processes, process_index=self.rank,
                                   process_count=self.world)
        self.local_batch = args.batch_size // self.world
        val_index, self.val_valid = val_positions(len(self.val_ds), args.batch_size, self.rank,
                                                  self.world)
        self.val_dl = DataLoader(_Positions(self.val_ds, val_index), self.local_batch,
                                 num_workers=args.num_workers)
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
            from countr_tpu_torch.engine.train_store import build_val_store

            arrays = self.store.arrays
            if self.pipelined:
                self.prime = engine.make_store_materialize(self.state, self.tcfg, arrays, gen,
                                                           graphed=graphed)
                self.pipe_step = engine.make_store_finetune_step_pipelined(
                    self.state, self.tcfg, arrays, gen, graphed=graphed)
                self.train_phase = engine.make_store_train_phase(self.state, self.tcfg,
                                                                 graphed=graphed)
                self.train_steps = (self.prime, self.pipe_step, self.train_phase)
            else:
                self.train_step = engine.make_store_finetune_step(self.state, self.tcfg,
                                                                  arrays, gen, graphed=graphed)
                self.train_steps = (self.train_step,)
            # validation is resident too: its fixed 384^2 samples would
            # otherwise upload again every epoch
            self.val_store = build_val_store(self.val_ds, self.device)
            self.eval_step = engine.make_store_eval_step(model, self.val_store.arrays,
                                                         graphed=graphed, mesh=mesh)
            self.batch_keys = engine.STORE_KEYS
        else:
            self.train_step = engine.make_finetune_step(
                self.state, self.tcfg, gen, graphed=graphed, device_aug=self.device_aug)
            self.train_steps = (self.train_step,)
            self.eval_step = engine.make_eval_step(model, graphed=graphed, mesh=mesh)
            self.batch_keys = engine.DEVICE_AUG_KEYS if self.device_aug else engine.FINETUNE_KEYS
        # the panels: a single process only (countr_tpu/cli/finetune.py:472),
        # and only where a sink takes them
        self.n_panels = min(N_PANELS, len(self.val_ds))
        sinks = self.tb.enabled or getattr(self.wandb, "enabled", True)
        self.panels = (engine.make_panel_forward(model, graphed=graphed)
                       if args.panel_every and self.world == 1 and self.n_panels and sinks
                       else None)
        self._panel_inputs = None
        self.capture_s = self._capture() if hasattr(self.eval_step, "capture") else 0.0

        self.start_epoch = common.resume(args, self.outdir, self.state, mesh)
        self.min_mae = float("inf")

    def _capture(self) -> float:
        """Capture the train step's graphs for every reachable shot (its
        accumulate and update pair under accumulation; on the pipelined
        path the materialisation, the pipelined step and the train phase)
        and the eval step's for shots 0-3 at the padded validation batch, on
        batches of the loader's shapes and dtypes; returns seconds."""
        from countr_tpu_torch.data.fsc147 import TrainDataset
        from countr_tpu_torch.engine import train as engine

        t0 = time.perf_counter()
        b, hw, dev = self.local_batch, self.model.cfg.img_size, self.device
        boxes = _zeros((b, 3, 64, 64, 3), torch.float32, dev)
        dots = {"dots": _zeros((b, TrainDataset.MAX_DEVICE_DOTS, 2), torch.int16, dev),
                "n_dots": _zeros((b,), torch.int32, dev)}
        if self.resident:
            # a valid geometry (the warm-up runs it): image 0's top-left
            # 384^2 through the identity map and as every mosaic cell
            i32 = functools.partial(torch.full, dtype=torch.int32, device=dev)
            batch = {"img_idx": i32((b,), 0),
                     "affine_C": torch.eye(2, device=dev).expand(b, 2, 2).contiguous(),
                     "affine_d": _zeros((b, 2), torch.float32, dev),
                     "is_mosaic": torch.ones((b,), device=dev), "cell_idx": i32((b, 4), 0),
                     "cell_top": i32((b, 4), 0), "cell_left": i32((b, 4), 0),
                     "cell_len": i32((b, 4), hw), "blend_l": i32((b,), 10), **dots}
            val = {"idxs": _zeros((b,), torch.int64, dev),
                   "valid": _zeros((b,), torch.float32, dev)}
        elif self.device_aug:
            batch = {"image_u8": _zeros((b, hw, hw, 3), torch.uint8, dev), **dots,
                     "apply_photo": _zeros((b,), torch.float32, dev), "boxes": boxes}
        else:
            batch = {"image": _zeros((b, hw, hw, 3), torch.float32, dev),
                     "gt_density": _zeros((b, hw, hw), torch.float32, dev), "boxes": boxes}
        if not self.resident:
            val = {"image": _zeros((b, hw, hw, 3), torch.float32, dev),
                   "gt_density": _zeros((b, hw, hw), torch.float32, dev), "boxes": boxes,
                   "valid": _zeros((b,), torch.float32, dev)}
        if self.pipelined:
            carry = dict(zip(engine.CARRY_KEYS, (
                _zeros((b, hw, hw, 3), torch.float32, dev),
                _zeros((b, hw, hw), torch.float32, dev), boxes,
                _zeros((hw, hw), torch.bool, dev))))
            self.prime.capture(batch)
        for shot in range(4):
            if self.pipelined:
                self.pipe_step.capture(carry, batch, shot)
                self.train_phase.capture(carry, shot)
            else:
                self.train_step.capture(batch, shot)
            self.eval_step.capture(val, shot)
        if self.panels is not None:
            n = self.n_panels
            self.panels.capture({"image": _zeros((n, hw, hw, 3), torch.float32, dev),
                                 "boxes": _zeros((n, 3, 64, 64, 3), torch.float32, dev)},
                                engine.PANEL_SHOT)
        torch.cuda.synchronize(dev)
        return time.perf_counter() - t0

    def graphs(self) -> int:
        """The CUDA graphs captured so far (0 for eager steps)."""
        return sum(len(f.runner) for f in (*self.train_steps, self.eval_step, self.panels)
                   if hasattr(f, "runner"))

    def _val_batches(self) -> Iterator[Dict]:
        """This rank's part of each validation batch, the last batch padded
        with ``valid`` 0: the resident store's indices (wrapped around),
        else the loader's samples (the last one repeated;
        ``val_positions``)."""
        from countr_tpu_torch.parallel.mesh import rows_of

        b, lb = self.args.batch_size, self.local_batch
        if self.resident:
            n = self.val_store.n
            for i0 in range(0, n, b):
                k = min(b, n - i0)
                idxs = np.arange(i0, i0 + b, dtype=np.int64) % n
                valid = np.concatenate([np.ones(k, np.float32), np.zeros(b - k, np.float32)])
                yield {"idxs": rows_of(idxs, self.rank, self.world),
                       "valid": rows_of(valid, self.rank, self.world)}
            return
        for i, batch in enumerate(self.val_dl.epoch(0)):
            out = {k: batch[k] for k in ("image", "gt_density", "boxes")}
            out["valid"] = self.val_valid[i * lb:(i + 1) * lb]
            yield out

    def step_metrics(self, batches: Iterator[Dict], py_rng: random.Random) -> Iterator[Dict]:
        """Train on ``batches`` (on the device): each step's metrics. Each
        batch's shot is drawn from ``py_rng`` with the m_flag rule. On the
        pipelined path the step that receives batch j + 1 trains batch j,
        and the epoch's last batch trains alone: the same draws, in the
        same order, as the serial path."""
        def shot(flags) -> int:
            return sample_shot_num(py_rng, flags, self.mesh)

        if not self.pipelined:
            for batch in batches:
                yield self.train_step(batch, shot(batch["m_flag"]))
            return
        carry = flags = None
        for batch in batches:
            if carry is None:
                carry = self.prime(batch)
            else:
                m, carry = self.pipe_step(carry, batch, shot(flags))
                yield m
            flags = batch["m_flag"]
        if carry is not None:
            yield self.train_phase(carry, shot(flags))

    def train_epoch(self, epoch: int, py_rng: random.Random) -> Dict:
        """One epoch of steps on the loader's batches; returns the host
        sums of the metrics and the number of steps."""
        from countr_tpu_torch.data.loader import device_prefetch

        args = self.args
        self.generator.manual_seed(epoch_seed(args.seed, epoch))
        batches = device_prefetch(self.train_dl.epoch(epoch), self.device, self.batch_keys)
        if args.limit_steps:
            batches = itertools.islice(batches, args.limit_steps)
        metrics = self.step_metrics(batches, py_rng)
        if args.debug_nans:
            metrics = common.nan_watched(metrics, lambda i: f"epoch {epoch} step {i}")
        totals, n_steps = None, 0
        for m in metrics:
            totals = m if totals is None else {k: totals[k] + m[k] for k in totals}
            n_steps += 1
            if n_steps % 32 == 0 and not torch.isfinite(totals["loss"]):
                # the running sum catches a NaN of any step in the window
                raise SystemExit(f"Loss is not finite at epoch {epoch}")
            if args.log_every and n_steps % args.log_every == 0 and self.main:
                # the per-step scalars (reference: FSC_finetune_cross.py:320-326)
                with span("train.log"):
                    gstep = epoch * self.steps_per_epoch + n_steps
                    rec = {"train/loss_step": float(m["loss"]),
                           "train/lr_step": float(self.state.schedule(gstep))}
                    self.wandb.log(rec, step=gstep)
                    for k, v in rec.items():
                        self.tb.scalar(k, v, gstep)
        sums = {k: float(v) for k, v in totals.items()} if totals else {}
        return {"loss": sums.get("loss", 0.0), "mae": sums.get("mae", 0.0),
                "mse": sums.get("mse", 0.0), "steps": n_steps}

    def validate(self, py_rng: random.Random) -> Dict:
        """The validation split (reference: FSC_finetune_cross.py:328-350):
        error sums over the real samples, each batch at a shot drawn from
        ``py_rng``."""
        from countr_tpu_torch.data.loader import device_prefetch

        v = {"err_sum": 0.0, "sq_sum": 0.0, "nae_sum": 0.0, "n": 0.0}
        for batch in device_prefetch(self._val_batches(), self.device):
            em = self.eval_step(batch, py_rng.randint(0, 3))
            for k in v:
                v[k] += float(em[k])
        return v

    def run_epoch(self, epoch: int) -> Dict:
        """Train, validate, log and keep checkpoints for ``epoch``;
        returns its stats."""
        t0 = time.time()
        # A per-epoch seeded shot-number stream (train and val draws): a
        # --do_resume run at epoch N draws what an uninterrupted run draws
        # at epoch N, as the step's generator (epoch_seed) does.
        py_rng = random.Random(f"{self.args.seed}:{epoch}")
        tr = self.train_epoch(epoch, py_rng)
        if not np.isfinite(tr["loss"]):
            raise SystemExit(f"Loss is not finite at epoch {epoch}")
        v = self.validate(py_rng)
        n, vn = max(tr["steps"], 1), max(v["n"], 1)
        val_mae = v["err_sum"] / vn
        stats = {
            "epoch": epoch,
            "train/loss": tr["loss"] / n,
            "train/MAE": tr["mae"] / n,
            "train/RMSE": (tr["mse"] / n) ** 0.5,
            "val/MAE": val_mae,
            "val/RMSE": (v["sq_sum"] / vn) ** 0.5,
            "val/NAE": v["nae_sum"] / vn,
            "lr": float(self.state.schedule(epoch * self.steps_per_epoch)),
            "epoch_time_s": time.time() - t0,
        }
        rank0_print(f"[Epoch {epoch}] loss {stats['train/loss']:.4f} train MAE "
                    f"{stats['train/MAE']:.2f} val MAE {val_mae:.2f} val RMSE "
                    f"{stats['val/RMSE']:.2f} ({stats['epoch_time_s']:.1f}s)", flush=True)
        self.jsonl.write(stats)
        # W&B steps are monotonic: the epoch's record shares the global
        # step axis with the per-step scalars
        wandb_step = (epoch + 1) * self.steps_per_epoch
        self.wandb.log(stats, step=wandb_step)
        for k, v in stats.items():
            if k != "epoch":
                self.tb.scalar(k, v, epoch)
        every = self.args.panel_every
        if self.panels is not None and every and epoch % every == 0:
            self.log_val_panels(epoch, wandb_step)
        self._keep(epoch, val_mae)
        return stats

    def panel_inputs(self):
        """The validation panels' samples (the first ``n_panels``) and their
        image and exemplar batch on the device, made once."""
        if self._panel_inputs is None:
            samples = [self.val_ds[i] for i in range(self.n_panels)]
            batch = {k: torch.from_numpy(np.stack([s[k] for s in samples])).to(self.device)
                     for k in ("image", "boxes")}
            self._panel_inputs = samples, batch
        return self._panel_inputs

    def panel_densities(self):
        """The panels' samples and their densities at ``PANEL_SHOT``, from
        the panel forward (replayed from its graph on the card)."""
        from countr_tpu_torch.engine.train import PANEL_SHOT

        samples, batch = self.panel_inputs()
        return samples, self.panels(batch, PANEL_SHOT)["density"].cpu().numpy()

    def log_val_panels(self, epoch: int, wandb_step: int) -> None:
        """The ``val/density_<name>`` triptychs (``val_panel``) to
        TensorBoard at ``epoch`` and W&B at ``wandb_step``
        (countr_tpu/cli/finetune.py:524-548)."""
        samples, out = self.panel_densities()
        for s, density in zip(samples, out):
            panel = val_panel(s, density)
            self.tb.image(f"val/density_{s['name']}", panel, epoch)
            self.wandb.image(f"val/density_{s['name']}", panel, wandb_step)

    def _keep(self, epoch: int, val_mae: float) -> None:
        """Periodic, last and minimum-MAE checkpoints (reference:
        FSC_finetune_cross.py:407-420)."""
        from countr_tpu_torch.engine import checkpoint as ckpt

        if not self.outdir or not self.main:
            return
        args = self.args
        if args.ckpt_every and epoch % args.ckpt_every == 0 and epoch != 0:
            ckpt.save_checkpoint(os.path.join(self.outdir, "ckpt_periodic"), epoch, self.state,
                                 keep=5)
        if epoch % max(1, args.ckpt_last_every) == 0 or epoch + 1 == args.epochs:
            ckpt.save_checkpoint(os.path.join(self.outdir, "ckpt_last"), epoch, self.state,
                                 keep=1)
        if val_mae < self.min_mae:
            self.min_mae = val_mae
            ckpt.save_checkpoint(os.path.join(self.outdir, "ckpt_minMAE"), epoch, self.state,
                                 keep=1)
            # the best checkpoint as an artifact (reference: util/misc.py:331-335)
            self.wandb.log_artifact(os.path.join(self.outdir, "ckpt_minMAE"), "finetuning_minMAE")

    def run(self) -> List[Dict]:
        try:
            return [self.run_epoch(e) for e in range(self.start_epoch, self.args.epochs)]
        finally:
            self.close()

    def close(self) -> None:
        self.train_dl.close()
        self.val_dl.close()
        self.tb.flush()


def main(args, graphed=None) -> List[Dict]:
    """Fine-tune per ``args``; returns each epoch's stats (rank 0's, when
    ``--n_devices`` starts the ranks here)."""
    launched = common.launch_ranks(main, args)
    if launched is not None:
        return launched
    return Finetune(args, graphed=graphed).run()


def _entry():
    from countr_tpu_torch.parallel import dist

    try:
        main(get_args())
    finally:
        dist.destroy()


if __name__ == "__main__":
    _entry()
