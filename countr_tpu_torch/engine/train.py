"""Training engine (counterpart of ``countr_tpu/engine/train.py``):
AdamW with the reference's decay groups and frozen encoder, the
masked-MSE finetune step, the eval step, the MAE pretrain step and the
encoder transfer.

Mixed precision as in the JAX package: bf16 activations with fp32
parameters and optimizer state (the reference's fp16 AMP + GradScaler,
util/misc.py:260-287, is not needed with bf16's fp32 exponent range).

The JAX step is a pure function of a TrainState; here the state holds
the model and a ``torch.optim.AdamW`` that update in place, and a step
returns the metrics. Gradient accumulation (``MultiSteps``), the
resident-store steps and the in-step device augmentation are not ported
yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Tuple

import torch
from torch import nn

from countr_tpu_torch.config import DENSITY_SCALE, TrainConfig
from countr_tpu_torch.engine.schedule import warmup_cosine


def decay_mask(model: nn.Module) -> Dict[str, bool]:
    """Weight decay only for >=2-D params — the timm
    ``add_weight_decay`` no-decay-for-1D-and-bias grouping the reference
    applies (reference: FSC_finetune_cross.py:234)."""
    return {name: p.ndim > 1 for name, p in model.named_parameters()}


# Parameter-name prefixes of the counting model's frozen ViT encoder (the
# JAX package's FROZEN_ENCODER_PREFIXES "patch_embed", "blocks_", "norm"
# in the reference state_dict names). The reference runs the encoder
# under torch.no_grad(), so these never get a .grad and AdamW neither
# steps nor decays them.
FROZEN_ENCODER_PREFIXES = ("patch_embed.", "blocks.", "norm.")


def frozen_labels(model: nn.Module, prefixes=FROZEN_ENCODER_PREFIXES) -> Dict[str, str]:
    """``{param name: "frozen" | "train"}``."""
    return {name: "frozen" if name.startswith(prefixes) else "train"
            for name, _ in model.named_parameters()}


def make_optimizer(
    model: nn.Module, cfg: TrainConfig, steps_per_epoch: int, world_batch: int,
) -> Tuple[torch.optim.AdamW, Callable[[int], float]]:
    """AdamW(0.9, 0.95, eps 1e-8) + warmup-cosine. Two groups: the
    >=2-D parameters with ``cfg.weight_decay``, the rest without. When
    the model's encoder is frozen (``model.cfg.freeze_encoder``) its
    parameters are in no group: no optimizer state, no update."""
    if cfg.accum_iter != 1:
        raise NotImplementedError(
            "gradient accumulation (accum_iter > 1, optax.MultiSteps in the JAX "
            "package) is not ported yet"
        )
    sched = warmup_cosine(
        cfg.resolved_lr(world_batch), epochs=cfg.epochs,
        warmup_epochs=cfg.warmup_epochs, steps_per_epoch=steps_per_epoch,
        min_lr=cfg.min_lr,
    )
    frozen = frozen_labels(model) if getattr(model.cfg, "freeze_encoder", False) else {}
    decay = decay_mask(model)
    groups = {True: [], False: []}
    for name, p in model.named_parameters():
        if frozen.get(name) != "frozen":
            groups[decay[name]].append(p)
    opt = torch.optim.AdamW(
        [{"params": groups[True], "weight_decay": cfg.weight_decay},
         {"params": groups[False], "weight_decay": 0.0}],
        lr=0.0, betas=(0.9, 0.95), eps=1e-8,
    )
    return opt, sched


@dataclasses.dataclass
class TrainState:
    """The model, its optimizer and LR schedule, and the count of updates
    made (the JAX TrainState's ``step``)."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    step: int = 0

    def apply_gradients(self) -> None:
        """One AdamW update from the parameters' ``.grad``, as optax's:
        the learning rate is the schedule at the step count before the
        update (so a warmup starts at lr 0), and every trainable
        parameter is updated, one without a gradient (the exemplar CNN at
        zero shots, the shot token otherwise) as with a zero gradient —
        its moments decay and weight decay applies. torch's AdamW would
        skip a ``None`` gradient, so it is filled with zeros first."""
        lr = self.schedule(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
            for p in group["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        self.optimizer.step()
        self.step += 1


def init_train_state(
    model: nn.Module, cfg: TrainConfig, steps_per_epoch: int, world_batch: int,
) -> TrainState:
    opt, sched = make_optimizer(model, cfg, steps_per_epoch, world_batch)
    return TrainState(model, opt, sched)


def finetune_loss(model, imgs, gt, boxes, shot_num: int, mask):
    """Masked MSE ``sum((out - gt)^2 * mask / HW) / B`` with one [HW, HW]
    pixel mask shared across the batch (reference:
    FSC_finetune_cross.py:290-295). Returns (loss, density)."""
    hw = model.cfg.img_size
    out = model(imgs, boxes, shot_num)
    sq = torch.square(out - gt) * mask.float()
    return torch.sum(sq / (hw * hw)) / imgs.shape[0], out


def count_errors(out: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """|predicted count - true count| per sample; counts are density sums
    over DENSITY_SCALE."""
    pred_cnt = out.sum(dim=(1, 2)) / DENSITY_SCALE
    gt_cnt = gt.sum(dim=(1, 2)) / DENSITY_SCALE
    return (pred_cnt - gt_cnt).abs()


def finetune_core(state: TrainState, imgs, gt, boxes, shot_num: int, mask) -> Dict:
    """Forward, backward and one update on the given batch and loss mask
    (the JAX ``_finetune_core``). Returns the metrics ``loss`` (before the
    update), ``mae`` and ``mse`` of the counts, as 0-d tensors."""
    state.optimizer.zero_grad(set_to_none=True)
    loss, out = finetune_loss(state.model, imgs, gt, boxes, shot_num, mask)
    loss.backward()
    state.apply_gradients()
    err = count_errors(out.detach(), gt)
    return {"loss": loss.detach(), "mae": err.mean(), "mse": err.square().mean()}


def loss_mask(hw: int, p: float, generator: torch.Generator) -> torch.Tensor:
    """A [hw, hw] Bernoulli(p) keep mask drawn on the generator's device."""
    return torch.rand((hw, hw), generator=generator, device=generator.device) < p


def make_finetune_step(
    state: TrainState, cfg: TrainConfig, generator: torch.Generator | None = None,
) -> Callable[[Mapping[str, torch.Tensor], int], Dict]:
    """Returns step(batch, shot_num) -> metrics, updating ``state``.

    batch: {'image' [B,384,384,3], 'gt_density' [B,384,384], 'boxes'
    [B,3,64,64,3]} on the model's device. The loss mask is drawn from
    ``generator`` (default: one on the model's device seeded with
    ``cfg.seed``)."""
    dev = next(state.model.parameters()).device
    gen = generator
    if gen is None:
        gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    hw = state.model.cfg.img_size

    def step(batch, shot_num: int) -> Dict:
        mask = loss_mask(hw, cfg.loss_mask_p, gen)
        return finetune_core(state, batch["image"], batch["gt_density"].float(),
                             batch["boxes"], shot_num, mask)

    return step


def make_eval_step(model: nn.Module):
    """Returns eval(batch, shot_num) -> masked error SUMS ``err_sum``,
    ``sq_sum``, ``nae_sum`` and ``n`` (reference val loop:
    FSC_finetune_cross.py:328-350); ``batch["valid"]`` masks padding
    samples."""

    @torch.inference_mode()
    def eval_fn(batch, shot_num: int) -> Dict:
        out = model(batch["image"], batch["boxes"], shot_num)
        gt = batch["gt_density"].float()
        err = count_errors(out, gt)
        gt_cnt = gt.sum(dim=(1, 2)) / DENSITY_SCALE
        nae = torch.where(gt_cnt > 0, err / gt_cnt.clamp_min(1e-9), torch.zeros_like(err))
        v = batch["valid"].float()
        return {"err_sum": (err * v).sum(), "sq_sum": (err.square() * v).sum(),
                "nae_sum": (nae * v).sum(), "n": v.sum()}

    return eval_fn


def make_pretrain_step(
    state: TrainState, cfg: TrainConfig, generator: torch.Generator | None = None,
) -> Callable[..., Dict]:
    """Returns step(imgs, noise=None) -> metrics, updating ``state``: the
    forward, backward and one AdamW update of the MAE loss over all
    parameters (the JAX ``make_pretrain_step``, ``engine/train.py:368-383``;
    reference hot loop: FSC_pretrain.py:254-299). imgs [B, H, W, 3] on
    the model's device; the masking noise [B, L] is ``noise`` or, without
    it, drawn from ``generator`` (default: one on the model's device
    seeded with ``cfg.seed``). Metrics: ``loss`` before the update, a 0-d
    tensor."""
    dev = next(state.model.parameters()).device
    gen = generator
    if gen is None:
        gen = torch.Generator(device=dev).manual_seed(cfg.seed)

    def step(imgs, noise=None) -> Dict:
        state.optimizer.zero_grad(set_to_none=True)
        loss, _, _ = state.model(imgs, noise=noise, generator=None if noise is not None else gen)
        loss.backward()
        state.apply_gradients()
        return {"loss": loss.detach()}

    return step


ENCODER_PREFIXES = ("patch_embed.", "norm.")


def transfer_encoder(mae_state: Mapping, countr_state: Mapping, depth: int = 12) -> Dict:
    """Copy the pretrained ViT encoder (patch_embed, blocks.0..depth-1,
    norm) from an MAE state_dict into a counting-model state_dict — the
    reference's non-strict load of the pretrain checkpoint into
    SupervisedMAE (reference: util/misc.py:363-376; only encoder keys
    match). Returns a new dict."""
    prefixes = ENCODER_PREFIXES + tuple(f"blocks.{i}." for i in range(depth))
    out = dict(countr_state)
    for k, v in mae_state.items():
        if k.startswith(prefixes) and k in out:
            out[k] = v
    return out
