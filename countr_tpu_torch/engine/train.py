"""Training engine (counterpart of ``countr_tpu/engine/train.py``):
AdamW with the reference's decay groups and frozen encoder, gradient
accumulation with ``optax.MultiSteps``' semantics, the masked-MSE
finetune step, the eval step, the MAE pretrain step and the encoder
transfer.

Mixed precision as in the JAX package: bf16 activations with fp32
parameters and optimizer state (the reference's fp16 AMP + GradScaler,
util/misc.py:260-287, is not needed with bf16's fp32 exponent range).

The JAX step is a pure function of a TrainState, compiled once per shape
and ``shot_num``. Here the state holds the model, a ``torch.optim.AdamW``
and every buffer a step writes, allocated once and updated in place; a
step returns the metrics. On a CUDA device each step is replayed from a
CUDA graph (``engine/graphs.py``), one per input shape, ``shot_num`` and,
under accumulation, kind of mini-step: the counterpart of ``jax.jit``.
On the CPU, or with ``graphed=False``, the same step runs eagerly. With
``device_aug`` the finetune step runs the photometric augmentation and the
density synthesis itself (``ops/augment.py``), inside its graph. The
resident-store steps are not ported yet.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Mapping, Tuple

import torch
from torch import nn

from countr_tpu_torch.config import DENSITY_SCALE, TrainConfig
from countr_tpu_torch.engine.schedule import warmup_cosine
from countr_tpu_torch.models.vit import casts_at_use
from countr_tpu_torch.ops.augment import augment_batch


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
    parameters are in no group: no optimizer state, no update.

    On a CUDA device the optimizer is ``capturable`` (its step counts on
    the device, ``foreach``) and the learning rate is one 0-d device
    tensor shared by both groups, which ``TrainState`` writes before each
    step: a CUDA graph of the step reads it at every replay, where a float
    would be frozen into the graph. Gradient accumulation
    (``cfg.accum_iter``, optax.MultiSteps in the JAX package) is
    ``TrainState``'s."""
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
    dev = next(model.parameters()).device
    cuda = dev.type == "cuda"
    lr = torch.zeros((), device=dev) if cuda else 0.0
    opt = torch.optim.AdamW(
        [{"params": groups[True], "weight_decay": cfg.weight_decay, "lr": lr},
         {"params": groups[False], "weight_decay": 0.0, "lr": lr}],
        lr=lr, betas=(0.9, 0.95), eps=1e-8,
        **(dict(capturable=True, foreach=True) if cuda else {}),
    )
    # the eager steps on the card run the same capturable update on
    # purpose (the same bits as the graphed ones): no warning about it
    opt._warned_capturable_if_run_uncaptured = True
    return opt, sched


class TrainState:
    """The model, its AdamW and LR schedule, and the counts ``step``
    (mini-steps taken: the JAX TrainState's ``step``) and ``updates``
    (AdamW updates made: MultiSteps' ``gradient_step``, the inner
    optimizer's count). Without accumulation the two are equal.

    Every buffer a step writes exists from the start and is only ever
    written in place, so a CUDA graph of the step stays valid: a gradient
    for every trainable parameter (zeroed in place at each step, never set
    to None), Adam's moments and step counts, and under ``accum_iter`` > 1
    the accumulator. A trainable parameter the step's loss does not reach
    (the exemplar CNN at zero shots, the shot token otherwise) thus gets a
    zero gradient, as in optax: its moments decay and weight decay
    applies.

    Gradient accumulation follows ``optax.MultiSteps`` (use_grad_mean):
    mini-step n of each cycle of ``accum_iter`` folds its gradient g into
    the running mean, acc + (g - acc) / (n + 1); the first accum_iter - 1
    mini-steps leave the parameters, moments and ``updates`` untouched,
    and the last applies AdamW to the mean at lr = schedule(updates) and
    clears the accumulator."""

    def __init__(self, model: nn.Module, optimizer: torch.optim.Optimizer,
                 schedule: Callable[[int], float], accum_iter: int = 1):
        if accum_iter < 1:
            raise ValueError(f"accum_iter must be >= 1; got {accum_iter}")
        self.model = model
        self.optimizer = optimizer
        self.schedule = schedule
        self.accum_iter = accum_iter
        self.step = 0
        self.updates = 0
        self.params = [p for g in optimizer.param_groups for p in g["params"]]
        self.device = self.params[0].device
        with torch.no_grad():
            self.grads = [torch.zeros_like(p) for p in self.params]
            self.acc = [torch.zeros_like(p) for p in self.params] if accum_iter > 1 else []
            self.divisor = torch.ones((), device=self.device)  # n + 1 of MultiSteps
            for group in optimizer.param_groups:
                for p in group["params"]:
                    st = optimizer.state[p]
                    if not st:  # what torch's AdamW makes at its first step
                        cap = group.get("capturable", False)
                        st["step"] = torch.zeros((), device=p.device if cap else "cpu")
                        st["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                        st["exp_avg_sq"] = torch.zeros_like(p,
                                                            memory_format=torch.preserve_format)
        for p, g in zip(self.params, self.grads):
            p.grad = g

    def moments(self, p: torch.Tensor) -> list:
        """Adam's tensors for parameter ``p``: step, exp_avg, exp_avg_sq."""
        st = self.optimizer.state[p]
        return [st["step"], st["exp_avg"], st["exp_avg_sq"]]

    def mutable(self) -> list:
        """Every tensor a step writes: the trainable parameters, their
        gradients, Adam's tensors and the accumulator."""
        return (list(self.params) + self.grads + self.acc
                + [t for p in self.params for t in self.moments(p)])

    def begin_step(self) -> bool:
        """The host's part before a mini-step: put the gradient buffers
        back if something replaced them, write the learning rate of an
        update and the accumulator's divisor into the optimizer and onto
        the device. Returns whether this mini-step updates."""
        n = self.step % self.accum_iter
        update = n == self.accum_iter - 1
        for p, g in zip(self.params, self.grads):
            if p.grad is not g:
                p.grad = g
        if update:
            lr = self.schedule(self.updates)
            for group in self.optimizer.param_groups:
                if torch.is_tensor(group["lr"]):
                    group["lr"].fill_(lr)
                else:
                    group["lr"] = lr
        if self.accum_iter > 1:
            self.divisor.fill_(n + 1)
        return update

    def zero_grads(self) -> None:
        torch._foreach_zero_(self.grads)

    def apply_gradients(self, update: bool) -> None:
        """The device's part after the backward: fold the gradients into
        the accumulator (MultiSteps' acc + (g - acc) / (n + 1), in that
        order of operations) and, on an update, AdamW on the mean (the
        gradients themselves without accumulation)."""
        if self.accum_iter > 1:
            torch._foreach_sub_(self.grads, self.acc)
            torch._foreach_div_(self.grads, self.divisor)
            if update:
                torch._foreach_add_(self.grads, self.acc)
                torch._foreach_zero_(self.acc)
            else:
                torch._foreach_add_(self.acc, self.grads)
        if update:
            self.optimizer.step()

    def end_step(self, update: bool) -> None:
        self.step += 1
        self.updates += update


def init_train_state(
    model: nn.Module, cfg: TrainConfig, steps_per_epoch: int, world_batch: int,
) -> TrainState:
    opt, sched = make_optimizer(model, cfg, steps_per_epoch, world_batch)
    return TrainState(model, opt, sched, cfg.accum_iter)


def _resolve_graphed(device: torch.device, graphed) -> bool:
    """``graphed`` None means CUDA graphs on a CUDA device and eager
    steps on the CPU; True on a CPU model raises."""
    if graphed is None:
        return device.type == "cuda"
    if graphed and device.type != "cuda":
        raise ValueError(f"graphed steps need a CUDA device; the model is on {device}")
    return bool(graphed)


def _shapes(*tensors) -> tuple:
    return tuple((tuple(t.shape), t.dtype) for t in tensors)


def _replay(runner, key, fn, *inputs) -> Dict:
    """``runner(key, fn, *inputs)``, captured with the casts inside the
    graph; the metrics are copied out of the graph's pool."""
    with casts_at_use():
        out = runner(key, fn, *inputs)
    return {k: v.clone() for k, v in out.items()}


def _graphed_train_step(state: TrainState, device_step, generator, split):
    """The step of ``make_finetune_step`` / ``make_pretrain_step`` on a
    CUDA device. ``split(*args)`` gives a call's tensor inputs and static
    arguments; ``device_step(*inputs, update=..., **static)`` is replayed
    from a graph keyed on the static arguments, the inputs' shapes and the
    kind of mini-step. Under accumulation each key has two graphs, one
    that accumulates and one that updates: the host knows which mini-step
    comes, so neither graph runs work that the other needs, where one
    graph that selects would run AdamW at every mini-step and discard it.
    The accumulator's divisor and the learning rate are device scalars
    that ``TrainState.begin_step`` writes before each replay.
    ``step.capture(*args)`` captures a key's graphs without taking a step;
    ``step.runner`` counts the replays and their kernel launches."""
    from countr_tpu_torch.engine.graphs import GraphRunner

    runner = GraphRunner(state.device, state.mutable, (generator,))

    def graph(args, kw, update: bool):
        inputs, static = split(*args, **kw)
        key = (tuple(sorted(static.items())), _shapes(*inputs), update)
        return key, functools.partial(device_step, update=update, **static), inputs

    def step(*args, **kw) -> Dict:
        update = state.begin_step()
        key, fn, inputs = graph(args, kw, update)
        m = _replay(runner, key, fn, *inputs)
        state.end_step(update)
        return m

    def capture(*args, **kw) -> None:
        for update in (True,) if state.accum_iter == 1 else (False, True):
            key, fn, inputs = graph(args, kw, update)
            with casts_at_use():
                runner.capture(key, fn, *inputs)

    step.runner, step.capture = runner, capture
    return step


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


def _finetune_device(state: TrainState, imgs, gt, boxes, shot_num: int, mask,
                     update: bool) -> Dict:
    """The device's part of a finetune mini-step (what a graph holds)."""
    state.zero_grads()
    loss, out = finetune_loss(state.model, imgs, gt, boxes, shot_num, mask)
    loss.backward()
    state.apply_gradients(update)
    err = count_errors(out.detach(), gt)
    return {"loss": loss.detach(), "mae": err.mean(), "mse": err.square().mean()}


def finetune_core(state: TrainState, imgs, gt, boxes, shot_num: int, mask) -> Dict:
    """Forward, backward and one mini-step on the given batch and loss
    mask, eagerly (the JAX ``_finetune_core``). Returns the metrics
    ``loss`` (before the update), ``mae`` and ``mse`` of the counts, as
    0-d tensors."""
    update = state.begin_step()
    m = _finetune_device(state, imgs, gt, boxes, shot_num, mask, update)
    state.end_step(update)
    return m


def loss_mask(hw: int, p: float, generator: torch.Generator) -> torch.Tensor:
    """A [hw, hw] Bernoulli(p) keep mask drawn on the generator's device."""
    return torch.rand((hw, hw), generator=generator, device=generator.device) < p


FINETUNE_KEYS = ("image", "gt_density", "boxes")
DEVICE_AUG_KEYS = ("image_u8", "dots", "n_dots", "apply_photo", "boxes")


def make_finetune_step(
    state: TrainState, cfg: TrainConfig, generator: torch.Generator | None = None,
    graphed: bool | None = None, device_aug: bool = False,
) -> Callable[[Mapping[str, torch.Tensor], int], Dict]:
    """Returns step(batch, shot_num) -> metrics, updating ``state``.

    batch: {'image' [B,384,384,3], 'gt_density' [B,384,384], 'boxes'
    [B,3,64,64,3]} on the model's device (``FINETUNE_KEYS``). With
    ``device_aug`` it is the host-geometry sample instead
    (``DEVICE_AUG_KEYS``: 'image_u8' uint8, 'dots' [B,K,2], 'n_dots',
    'apply_photo', 'boxes'), and the step first runs
    ``ops.augment.augment_batch`` (the counterpart of the JAX step's
    ``device_aug``). The augmentation's factors and then the loss mask
    are drawn from ``generator`` (default: one on the model's device
    seeded with ``cfg.seed``) inside the step. On a CUDA device
    (``graphed`` None or True) the step is replayed from a CUDA graph per
    batch shape, ``shot_num`` and kind of mini-step, the generator
    registered with each; ``step.capture(batch, shot_num)`` captures a
    shot's graphs ahead, ``step.runner`` counts the replays.
    ``graphed=False`` runs the same step eagerly, as on the CPU."""
    gen = generator
    if gen is None:
        gen = torch.Generator(device=state.device).manual_seed(cfg.seed)
    hw = state.model.cfg.img_size
    keys = DEVICE_AUG_KEYS if device_aug else FINETUNE_KEYS

    def device_step(*ins, shot_num: int, update: bool) -> Dict:
        if device_aug:
            imgs, gt = augment_batch(*ins[:4], gen)
        else:
            imgs, gt = ins[0], ins[1].float()
        mask = loss_mask(hw, cfg.loss_mask_p, gen)
        return _finetune_device(state, imgs, gt, ins[-1], shot_num, mask, update)

    def inputs(batch, shot_num):
        return tuple(batch[k] for k in keys)

    if _resolve_graphed(state.device, graphed):
        return _graphed_train_step(
            state, device_step, gen,
            lambda batch, shot_num: (inputs(batch, shot_num), {"shot_num": shot_num}))

    def step(batch, shot_num: int) -> Dict:
        update = state.begin_step()
        m = device_step(*inputs(batch, shot_num), shot_num=shot_num, update=update)
        state.end_step(update)
        return m

    return step


def make_eval_step(model: nn.Module, graphed: bool | None = None):
    """Returns eval(batch, shot_num) -> masked error SUMS ``err_sum``,
    ``sq_sum``, ``nae_sum`` and ``n`` (reference val loop:
    FSC_finetune_cross.py:328-350); ``batch["valid"]`` masks padding
    samples. On a CUDA device (``graphed`` None or True) it is replayed
    from a CUDA graph per batch shape and ``shot_num`` (``eval.capture(batch,
    shot_num)`` captures one ahead, ``eval.runner`` counts), with the bf16
    casts of the weights inside the graph, so that the graph stays valid
    while training changes the weights; ``graphed=False`` runs it
    eagerly, as on the CPU."""

    def device_eval(image, gt, boxes, valid, *, shot_num: int) -> Dict:
        out = model(image, boxes, shot_num)
        gt = gt.float()
        err = count_errors(out, gt)
        gt_cnt = gt.sum(dim=(1, 2)) / DENSITY_SCALE
        nae = torch.where(gt_cnt > 0, err / gt_cnt.clamp_min(1e-9), torch.zeros_like(err))
        v = valid.float()
        return {"err_sum": (err * v).sum(), "sq_sum": (err.square() * v).sum(),
                "nae_sum": (nae * v).sum(), "n": v.sum()}

    def inputs(batch):
        return batch["image"], batch["gt_density"], batch["boxes"], batch["valid"]

    dev = next(model.parameters()).device
    if not _resolve_graphed(dev, graphed):
        @torch.inference_mode()
        def eval_fn(batch, shot_num: int) -> Dict:
            return device_eval(*inputs(batch), shot_num=shot_num)

        return eval_fn

    from countr_tpu_torch.engine.graphs import GraphRunner

    runner = GraphRunner(dev)

    def graph(batch, shot_num: int):
        ins = inputs(batch)
        return (shot_num, _shapes(*ins)), functools.partial(device_eval, shot_num=shot_num), ins

    @torch.inference_mode()
    def eval_fn(batch, shot_num: int) -> Dict:
        key, fn, ins = graph(batch, shot_num)
        return _replay(runner, key, fn, *ins)

    @torch.inference_mode()
    def capture(batch, shot_num: int) -> None:
        key, fn, ins = graph(batch, shot_num)
        with casts_at_use():
            runner.capture(key, fn, *ins)

    eval_fn.runner, eval_fn.capture = runner, capture
    return eval_fn


def make_pretrain_step(
    state: TrainState, cfg: TrainConfig, generator: torch.Generator | None = None,
    graphed: bool | None = None,
) -> Callable[..., Dict]:
    """Returns step(imgs, noise=None) -> metrics, updating ``state``: the
    forward, backward and one mini-step of the MAE loss over all
    parameters (the JAX ``make_pretrain_step``, ``engine/train.py:368-383``;
    reference hot loop: FSC_pretrain.py:254-299). imgs [B, H, W, 3] on
    the model's device; the masking noise [B, L] is ``noise`` or, without
    it, drawn inside the step from ``generator`` (default: one on the
    model's device seeded with ``cfg.seed``). Metrics: ``loss`` before the
    update, a 0-d tensor. On a CUDA device (``graphed`` None or True) the
    step is replayed from a CUDA graph per input shape and kind of
    mini-step (``step.capture(imgs, noise)``, ``step.runner`` as for the
    finetune step); ``graphed=False`` runs it eagerly, as on the CPU."""
    gen = generator
    if gen is None:
        gen = torch.Generator(device=state.device).manual_seed(cfg.seed)

    def device_step(imgs, *noise, update: bool) -> Dict:
        state.zero_grads()
        loss, _, _ = state.model(imgs, noise=noise[0] if noise else None,
                                 generator=None if noise else gen)
        loss.backward()
        state.apply_gradients(update)
        return {"loss": loss.detach()}

    def inputs(imgs, noise=None):
        return (imgs,) if noise is None else (imgs, noise)

    if _resolve_graphed(state.device, graphed):
        return _graphed_train_step(state, device_step, gen,
                                   lambda *a, **kw: (inputs(*a, **kw), {}))

    def step(imgs, noise=None) -> Dict:
        update = state.begin_step()
        m = device_step(*inputs(imgs, noise), update=update)
        state.end_step(update)
        return m

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
