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
(the groups and Adam's state; the update is one ``ops.fused_adamw`` pass)
and every buffer a step writes, allocated once and updated in place; a
step returns the metrics. On a CUDA device each step is replayed from a
CUDA graph (``engine/graphs.py``), one per input shape, ``shot_num`` and,
under accumulation, kind of mini-step: the counterpart of ``jax.jit``.
On the CPU, or with ``graphed=False``, the same step runs eagerly. With
``device_aug`` the finetune step runs the photometric augmentation and the
density synthesis itself (``ops/augment.py``), inside its graph. The
resident-store steps (``make_store_finetune_step``, its pipelined pair,
``make_store_eval_step``, ``make_carpk_store_step`` and
``make_store_pretrain_step``) materialise their batches from a store on the
device (``engine/train_store.py``, ``engine/carpk_store.py``) inside the
same graphs.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Mapping, Tuple

import torch
import torch.distributed as dist
from torch import nn

from countr_tpu_torch.config import DENSITY_SCALE, TrainConfig
from countr_tpu_torch.engine.schedule import warmup_cosine
from countr_tpu_torch.models.vit import casts_at_use
from countr_tpu_torch.ops.augment import (
    augment_batch, density_from_dots, draw_photometric, photometric,
)
from countr_tpu_torch.ops.fused_adamw import AdamWSegments, fused_adamw
from countr_tpu_torch.parallel.mesh import rows_of
from countr_tpu_torch.utils.profiling import span


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

    The optimizer holds the groups, their settings and Adam's state (its
    ``state_dict`` is what a checkpoint saves); ``TrainState`` makes the
    update itself, one ``ops.fused_adamw`` pass over every group. On a
    CUDA device the learning rate is one 0-d device tensor shared by both
    groups, which ``TrainState`` writes before each step: a CUDA graph of
    the step reads it at every replay, where a float would be frozen into
    the graph. Gradient accumulation (``cfg.accum_iter``, optax.MultiSteps
    in the JAX package) is ``TrainState``'s."""
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
    lr = torch.zeros((), device=dev) if dev.type == "cuda" else 0.0
    opt = torch.optim.AdamW(
        [{"params": groups[True], "weight_decay": cfg.weight_decay, "lr": lr},
         {"params": groups[False], "weight_decay": 0.0, "lr": lr}],
        lr=lr, betas=(0.9, 0.95), eps=1e-8,
    )
    return opt, sched


def all_reduce_mean(t: torch.Tensor, group, world: int) -> torch.Tensor:
    """``t`` averaged across the ranks of ``group``, in place: a SUM
    all-reduce, then the division (gloo has no AVG). At world 1 nothing is
    divided, so the step keeps the bits it has without a group."""
    dist.all_reduce(t, group=group)
    if world > 1:
        t.div_(world)
    return t


def _across(metrics: Dict, group, world: int, mean: bool) -> Dict:
    """0-d ``metrics`` averaged (``mean``) or summed across the ranks of
    ``group`` in one all-reduce; as they are without a group."""
    if group is None:
        return metrics
    t = torch.stack(list(metrics.values()))
    if mean:
        all_reduce_mean(t, group, world)
    else:
        dist.all_reduce(t, group=group)
    return dict(zip(metrics, t.unbind()))


class TrainState:
    """The model, its AdamW and LR schedule, and the counts ``step``
    (mini-steps taken: the JAX TrainState's ``step``) and ``updates``
    (AdamW updates made: MultiSteps' ``gradient_step``, the inner
    optimizer's count). Without accumulation the two are equal.

    Every buffer a step writes exists from the start and is only ever
    written in place, so a CUDA graph of the step stays valid: a gradient
    for every trainable parameter (zeroed in place at each step, never set
    to None), Adam's moments and step count, and under ``accum_iter`` > 1
    the accumulator. A trainable parameter the step's loss does not reach
    (the exemplar CNN at zero shots, the shot token otherwise) thus gets a
    zero gradient, as in optax: its moments decay and weight decay
    applies.

    The gradients and Adam's two moments are views of flat float32
    buffers laid out alike, in the groups' order (``segments``,
    ``ops.fused_adamw.AdamWSegments``): ``flat`` (the gradients),
    ``exp_avg`` and ``exp_avg_sq``, and under ``accum_iter`` > 1
    ``flat_acc`` (the accumulator, ``acc``). The optimizer's
    state holds those views under ``exp_avg`` and ``exp_avg_sq`` and one
    shared 0-d step count (``adam_step``) under every ``step``, so that
    its ``state_dict`` keeps torch's layout. An update is one
    ``fused_adamw`` pass over the three buffers and the parameters in
    place, on the card one kernel launch.

    Gradient accumulation follows ``optax.MultiSteps`` (use_grad_mean):
    mini-step n of each cycle of ``accum_iter`` folds its gradient g into
    the running mean, acc + (g - acc) / (n + 1); the first accum_iter - 1
    mini-steps leave the parameters, moments and ``updates`` untouched,
    and the last applies AdamW to the mean at lr = schedule(updates) and
    clears the accumulator.

    Data parallelism (``mesh``, a rank's ``parallel.mesh.Mesh``): each
    rank's flat gradient buffer is averaged across the ranks by one
    all-reduce before the accumulation
    (``apply_gradients``), and the steps average their metrics and sum the
    eval's error sums the same way; on the card the collectives are
    captured in the steps' graphs. Every per-sample random value is drawn
    at the global batch's shape and the rank keeps its rows, and every
    shared one (the loss mask) from a generator seeded alike on every
    rank, so that N ranks compute what one process computes on the global
    batch."""

    def __init__(self, model: nn.Module, optimizer: torch.optim.Optimizer,
                 schedule: Callable[[int], float], accum_iter: int = 1, mesh=None):
        if accum_iter < 1:
            raise ValueError(f"accum_iter must be >= 1; got {accum_iter}")
        self.model = model
        self.optimizer = optimizer
        self.schedule = schedule
        self.accum_iter = accum_iter
        self.step = 0
        self.updates = 0
        self.group = mesh.group if mesh is not None else None
        self.rank, self.world = (mesh.rank, mesh.world) if mesh is not None else (0, 1)
        groups = optimizer.param_groups
        if any(g["weight_decay"] or (g["betas"], g["eps"]) != (groups[0]["betas"],
                                                              groups[0]["eps"])
               for g in groups[1:]):
            raise ValueError("TrainState: the groups after the first must share its betas "
                             "and eps and take no weight decay")
        self.params = [p for g in groups for p in g["params"]]
        self.device = self.params[0].device
        self.segments = AdamWSegments(self.params, len(groups[0]["params"]))
        n = self.segments.length
        with torch.no_grad():
            self.flat = torch.zeros(n, device=self.device)
            self.grads = self.segments.views(self.flat)
            self.exp_avg, self.exp_avg_sq = (torch.zeros(n, device=self.device),
                                             torch.zeros(n, device=self.device))
            self.adam_step = torch.zeros((), device=self.device)
            self.flat_acc = torch.zeros(n, device=self.device) if accum_iter > 1 else None
            self.acc = self.segments.views(self.flat_acc) if accum_iter > 1 else []
            self.divisor = torch.ones((), device=self.device)  # n + 1 of MultiSteps
        for p, g, m, v in zip(self.params, self.grads, self.segments.views(self.exp_avg),
                              self.segments.views(self.exp_avg_sq)):
            p.grad = g
            optimizer.state[p].update(step=self.adam_step, exp_avg=m, exp_avg_sq=v)

    def moments(self, p: torch.Tensor) -> list:
        """Adam's tensors for parameter ``p``: step, exp_avg, exp_avg_sq."""
        st = self.optimizer.state[p]
        return [st["step"], st["exp_avg"], st["exp_avg_sq"]]

    def mutable(self) -> list:
        """Every tensor a step writes: the trainable parameters, the flat
        buffers of their gradients and of Adam's moments, Adam's step count
        and the accumulator's flat buffer."""
        return (list(self.params) + [self.flat, self.exp_avg, self.exp_avg_sq, self.adam_step]
                + ([self.flat_acc] if self.accum_iter > 1 else []))

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
        self.flat.zero_()

    def apply_gradients(self, update: bool) -> None:
        """The device's part after the backward: on a data-parallel rank,
        average the gradients across the ranks (one all-reduce of the flat
        buffer: the global batch's gradient, since every rank's loss is a
        mean over the same number of samples); fold them into the
        accumulator (MultiSteps' acc + (g - acc) / (n + 1), in that order
        of operations, elementwise on the two flat buffers) and, on an
        update, AdamW on the mean (the gradients themselves without
        accumulation): the step count, then one ``fused_adamw`` pass."""
        if self.group is not None:
            all_reduce_mean(self.flat, self.group, self.world)
        if self.accum_iter > 1:
            self.flat.sub_(self.flat_acc).div_(self.divisor)
            if update:
                self.flat.add_(self.flat_acc)
                self.flat_acc.zero_()
            else:
                self.flat_acc.add_(self.flat)
        if update:
            group = self.optimizer.param_groups[0]
            beta1, beta2 = group["betas"]
            self.adam_step.add_(1)
            fused_adamw(self.segments, self.flat, self.exp_avg, self.exp_avg_sq,
                        self.adam_step, group["lr"], beta1=beta1, beta2=beta2, eps=group["eps"],
                        weight_decay=group["weight_decay"])

    def end_step(self, update: bool) -> None:
        self.step += 1
        self.updates += update


def init_train_state(
    model: nn.Module, cfg: TrainConfig, steps_per_epoch: int, world_batch: int, mesh=None,
) -> TrainState:
    opt, sched = make_optimizer(model, cfg, steps_per_epoch, world_batch)
    return TrainState(model, opt, sched, cfg.accum_iter, mesh)


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
    """The step of ``_train_step`` on a CUDA device. ``split(*args)``
    gives a call's tensor inputs and static arguments;
    ``device_step(*inputs, update=..., **static)`` is replayed
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

    runner = GraphRunner(state.device, state.mutable, () if generator is None else (generator,))

    def graph(args, kw, update: bool):
        inputs, static = split(*args, **kw)
        key = (tuple(sorted(static.items())), _shapes(*inputs), update)
        return key, functools.partial(device_step, update=update, **static), inputs

    def step(*args, **kw) -> Dict:
        with span("train.step"):
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


def _train_step(state: TrainState, device_step, generator, graphed, split):
    """step(*args) of a training mini-step: ``split(*args)`` gives the
    call's tensor inputs and static arguments, ``device_step(*inputs,
    update=..., **static)`` runs the device's part. Replayed from CUDA
    graphs on a CUDA device (``graphed`` None or True,
    ``_graphed_train_step``; ``generator``, if any, registered with each
    graph); eagerly with ``graphed=False`` and on the CPU."""
    if _resolve_graphed(state.device, graphed):
        return _graphed_train_step(state, device_step, generator, split)

    def step(*args, **kw) -> Dict:
        with span("train.step"):
            inputs, static = split(*args, **kw)
            update = state.begin_step()
            m = device_step(*inputs, update=update, **static)
            state.end_step(update)
        return m

    return step


def _generator(state: TrainState, cfg: TrainConfig, generator) -> torch.Generator:
    """``generator``, or one on the model's device seeded with ``cfg.seed``."""
    if generator is None:
        generator = torch.Generator(device=state.device).manual_seed(cfg.seed)
    return generator


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
    return _across({"loss": loss.detach(), "mae": err.mean(), "mse": err.square().mean()},
                   state.group, state.world, mean=True)


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
    gen = _generator(state, cfg, generator)
    hw = state.model.cfg.img_size
    keys = DEVICE_AUG_KEYS if device_aug else FINETUNE_KEYS

    def device_step(*ins, shot_num: int, update: bool) -> Dict:
        if device_aug:
            imgs, gt = augment_batch(*ins[:4], gen, rank=state.rank, world=state.world)
        else:
            imgs, gt = ins[0], ins[1].float()
        mask = loss_mask(hw, cfg.loss_mask_p, gen)
        return _finetune_device(state, imgs, gt, ins[-1], shot_num, mask, update)

    return _train_step(state, device_step, gen, graphed, lambda batch, shot_num: (
        tuple(batch[k] for k in keys), {"shot_num": shot_num}))


# ---------------------------------------------------------------------------
# Resident-store steps (engine/train_store.py, engine/carpk_store.py)
# ---------------------------------------------------------------------------

STORE_KEYS = ("img_idx", "affine_C", "affine_d", "is_mosaic", "cell_idx", "cell_top",
              "cell_left", "cell_len", "blend_l", "dots", "n_dots")
CARRY_KEYS = ("imgs", "gt", "boxes", "mask")
CARPK_KEYS = ("img_idx", "bx0", "bx1", "bwx", "by0", "by1", "bwy", "ex_valid")


def materialize_train_batch(store_arrays: Mapping, geo: Mapping, generator: torch.Generator,
                            hw: int, loss_mask_p: float, n_mosaic=None, rank: int = 0,
                            world: int = 1) -> Dict:
    """A store batch's training inputs, on the store's device (the JAX
    ``_materialize_train_batch``): the pixels materialised from the pool
    (affine or mosaic), the photometric chain on the samples that are not
    mosaics (reference: util/FSC147.py:177-255, mosaic cells stay clean),
    the densities from the dot coordinates, and the batch's loss mask.
    The generator draws the photometric factors, then the mask: the
    pipelined step materialises batch j + 1 before it trains batch j and
    carries the mask, so that it draws what the serial step draws, in the
    same order. A data-parallel rank (``rank`` of ``world``) draws the
    global batch's factors and keeps its rows. Returns {'imgs', 'gt',
    'boxes', 'mask'} (``CARRY_KEYS``)."""
    from countr_tpu_torch.engine.train_store import materialize_batch

    imgs, boxes = materialize_batch(store_arrays, geo, n_mosaic)
    b, h, w = imgs.shape[:3]
    draws = draw_photometric(b, h, w, generator, rank=rank, world=world)
    clean = geo["is_mosaic"].reshape(b, 1, 1, 1) > 0
    imgs = torch.where(clean, imgs, photometric(imgs, draws))
    gt = density_from_dots(geo["dots"], geo["n_dots"], h, w)
    return {"imgs": imgs, "gt": gt, "boxes": boxes,
            "mask": loss_mask(hw, loss_mask_p, generator)}


def make_store_finetune_step(
    state: TrainState, cfg: TrainConfig, store_arrays: Mapping,
    generator: torch.Generator | None = None, graphed: bool | None = None, n_mosaic=None,
) -> Callable[[Mapping[str, torch.Tensor], int], Dict]:
    """Returns step(batch, shot_num) -> metrics: the resident-store
    finetune step (the JAX ``make_store_finetune_step``). batch holds only
    the geometry (``STORE_KEYS``, from ``TrainDataset(store_index=...)``)
    on the store's device; the step materialises the pixels from
    ``store_arrays`` (``TrainStore.arrays``, read in place: a graph holds
    their addresses, never a copy), augments, synthesises the densities,
    then trains (``materialize_train_batch``). Graphs, the generator and
    ``graphed`` as in ``make_finetune_step``."""
    gen = _generator(state, cfg, generator)
    hw = state.model.cfg.img_size

    def device_step(*ins, shot_num: int, update: bool) -> Dict:
        c = materialize_train_batch(store_arrays, dict(zip(STORE_KEYS, ins)), gen, hw,
                                    cfg.loss_mask_p, n_mosaic, state.rank, state.world)
        return _finetune_device(state, c["imgs"], c["gt"], c["boxes"], shot_num, c["mask"],
                                update)

    return _train_step(state, device_step, gen, graphed, lambda batch, shot_num: (
        tuple(batch[k] for k in STORE_KEYS), {"shot_num": shot_num}))


def make_store_materialize(
    state: TrainState, cfg: TrainConfig, store_arrays: Mapping,
    generator: torch.Generator | None = None, graphed: bool | None = None, n_mosaic=None,
) -> Callable[[Mapping[str, torch.Tensor]], Dict]:
    """Returns materialize(batch) -> carry (``CARRY_KEYS``): a store
    batch's training inputs (``materialize_train_batch``), which prime the
    pipelined step. On a CUDA device (``graphed`` None or True) replayed
    from one CUDA graph per batch shape (``materialize.capture(batch)``),
    the generator registered with it; the carry is a copy out of the
    graph's pool."""
    gen = _generator(state, cfg, generator)
    hw = state.model.cfg.img_size

    def device_fn(*ins) -> Dict:
        with torch.no_grad():
            return materialize_train_batch(store_arrays, dict(zip(STORE_KEYS, ins)), gen, hw,
                                           cfg.loss_mask_p, n_mosaic, state.rank, state.world)

    def inputs(batch):
        return tuple(batch[k] for k in STORE_KEYS)

    if not _resolve_graphed(state.device, graphed):
        return lambda batch: device_fn(*inputs(batch))

    from countr_tpu_torch.engine.graphs import GraphRunner

    runner = GraphRunner(state.device, generators=(gen,))

    def materialize(batch) -> Dict:
        ins = inputs(batch)
        return _replay(runner, _shapes(*ins), device_fn, *ins)

    def capture(batch) -> None:
        ins = inputs(batch)
        runner.capture(_shapes(*ins), device_fn, *ins)

    materialize.runner, materialize.capture = runner, capture
    return materialize


def make_store_finetune_step_pipelined(
    state: TrainState, cfg: TrainConfig, store_arrays: Mapping,
    generator: torch.Generator | None = None, graphed: bool | None = None, n_mosaic=None,
) -> Callable:
    """Returns step(carry, next_batch, shot_num) -> (metrics, next_carry):
    the software-pipelined resident step (the JAX
    ``make_store_finetune_step_pipelined``). It trains on the carried batch,
    materialised one call earlier, and materialises ``next_batch``, in one
    graph per shot on a CUDA device. shot_num applies to the carried batch.
    The trajectory is the serial step's one batch behind, to the bit: batch
    j trains on the same pixels, photometric factors and loss mask, since
    the generator draws batch j's factors and mask when batch j is
    materialised (``materialize_train_batch``). Prime the first carry with
    ``make_store_materialize``; train the last carry of an epoch with
    ``make_store_train_phase``. ``step.capture(carry, batch, shot_num)``
    and ``step.runner`` as for the other steps."""
    gen = _generator(state, cfg, generator)
    hw = state.model.cfg.img_size
    n = len(CARRY_KEYS)

    def device_step(*ins, shot_num: int, update: bool) -> Dict:
        imgs, gt, boxes, mask = ins[:n]
        m = _finetune_device(state, imgs, gt, boxes, shot_num, mask, update)
        with torch.no_grad():
            c = materialize_train_batch(store_arrays, dict(zip(STORE_KEYS, ins[n:])), gen, hw,
                                        cfg.loss_mask_p, n_mosaic, state.rank, state.world)
        return {**m, **{"next_" + k: v for k, v in c.items()}}

    inner = _train_step(state, device_step, gen, graphed, lambda carry, batch, shot_num: (
        tuple(carry[k] for k in CARRY_KEYS) + tuple(batch[k] for k in STORE_KEYS),
        {"shot_num": shot_num}))

    def step(carry, batch, shot_num: int):
        out = inner(carry, batch, shot_num)
        return ({k: v for k, v in out.items() if not k.startswith("next_")},
                {k: out["next_" + k] for k in CARRY_KEYS})

    if hasattr(inner, "runner"):
        step.runner, step.capture = inner.runner, inner.capture
    return step


def make_store_train_phase(state: TrainState, cfg: TrainConfig,
                           graphed: bool | None = None) -> Callable[[Mapping, int], Dict]:
    """Returns train(carry, shot_num) -> metrics: the pipelined step's
    train half alone (the JAX ``make_store_train_phase``), for the last
    carried batch of an epoch. It draws nothing (the carry holds its loss
    mask); one graph per shot on a CUDA device."""

    def device_step(imgs, gt, boxes, mask, *, shot_num: int, update: bool) -> Dict:
        return _finetune_device(state, imgs, gt, boxes, shot_num, mask, update)

    return _train_step(state, device_step, None, graphed, lambda carry, shot_num: (
        tuple(carry[k] for k in CARRY_KEYS), {"shot_num": shot_num}))


def make_carpk_store_step(
    state: TrainState, cfg: TrainConfig, store_arrays: Mapping,
    generator: torch.Generator | None = None, graphed: bool | None = None,
) -> Callable[[Mapping[str, torch.Tensor]], Dict]:
    """Returns step(batch) -> metrics: the resident CARPK finetune step
    (the JAX ``make_carpk_store_step``). batch holds an image index and the
    random exemplar's crop maps (``CARPK_KEYS``, from
    ``carpk_store.exemplar_geometry``); the 384x384 resize and crop, the
    density and the exemplar resize run in the step from the resident uint8
    originals (``store_arrays``: ``CarpkStore.arrays``). shot_num is 1 and
    the CLI sets ``loss_mask_p`` 1.0, the reference's unmasked loss
    (reference: FSC_finetune_CARPK.py:242, :250-252). One graph on a CUDA
    device."""
    from countr_tpu_torch.engine.carpk_store import materialize_carpk_batch

    gen = _generator(state, cfg, generator)
    hw = state.model.cfg.img_size

    def device_step(*ins, shot_num: int, update: bool) -> Dict:
        geo = dict(zip(CARPK_KEYS, ins))
        imgs, boxes = materialize_carpk_batch(store_arrays, geo)
        idx = geo["img_idx"].long()
        gt = density_from_dots(store_arrays["dots"][idx], store_arrays["n_dots"][idx])
        mask = loss_mask(hw, cfg.loss_mask_p, gen)
        return _finetune_device(state, imgs, gt, boxes, shot_num, mask, update)

    return _train_step(state, device_step, gen, graphed, lambda batch: (
        tuple(batch[k] for k in CARPK_KEYS), {"shot_num": 1}))


def _error_sums(pred_cnt: torch.Tensor, gt_cnt: torch.Tensor, valid: torch.Tensor) -> Dict:
    """The eval steps' masked error sums over the samples with ``valid``."""
    err = (pred_cnt - gt_cnt).abs()
    nae = torch.where(gt_cnt > 0, err / gt_cnt.clamp_min(1e-9), torch.zeros_like(err))
    v = valid.float()
    return {"err_sum": (err * v).sum(), "sq_sum": (err.square() * v).sum(),
            "nae_sum": (nae * v).sum(), "n": v.sum()}


def _eval_step(device: torch.device, device_eval, inputs, graphed):
    """eval(batch, shot_num) of ``device_eval(*inputs(batch), shot_num=)``,
    without autograd: replayed from a CUDA graph per batch shape and
    ``shot_num`` on a CUDA device (``graphed`` None or True;
    ``eval.capture(batch, shot_num)`` captures one ahead, ``eval.runner``
    counts), with the bf16 casts of the weights inside the graph, so that
    it stays valid while training changes the weights; eagerly with
    ``graphed=False`` and on the CPU."""
    if not _resolve_graphed(device, graphed):
        @torch.inference_mode()
        def eval_fn(batch, shot_num: int) -> Dict:
            return device_eval(*inputs(batch), shot_num=shot_num)

        return eval_fn

    from countr_tpu_torch.engine.graphs import GraphRunner

    runner = GraphRunner(device)

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


def make_eval_step(model: nn.Module, graphed: bool | None = None, mesh=None):
    """Returns eval(batch, shot_num) -> masked error SUMS ``err_sum``,
    ``sq_sum``, ``nae_sum`` and ``n`` (reference val loop:
    FSC_finetune_cross.py:328-350) of batch {'image', 'gt_density',
    'boxes', 'valid'}; ``valid`` masks padding samples. On a data-parallel
    rank (``mesh``) the sums are the global ones, summed across the ranks
    in the step. Graphs as in ``_eval_step``."""
    group, world = _group_of(mesh)

    def device_eval(image, gt, boxes, valid, *, shot_num: int) -> Dict:
        out = model(image, boxes, shot_num)
        gt = gt.float()
        return _across(_error_sums(out.sum(dim=(1, 2)) / DENSITY_SCALE,
                                   gt.sum(dim=(1, 2)) / DENSITY_SCALE, valid),
                       group, world, mean=False)

    return _eval_step(next(model.parameters()).device, device_eval, lambda batch: (
        batch["image"], batch["gt_density"], batch["boxes"], batch["valid"]), graphed)


PANEL_SHOT = 3  # the validation panels' shot (countr_tpu/cli/finetune.py:536)


def make_panel_forward(model: nn.Module, graphed: bool | None = None):
    """Returns panel(batch, shot_num) -> {'density': [n, H, W] fp32}, the
    forward of batch {'image' [n, H, W, 3], 'boxes' [n, 3, 64, 64, 3]}
    without autograd: the finetune CLI's validation panels (the JAX CLI's
    eager ``model.apply``, countr_tpu/cli/finetune.py:524-548), at
    ``PANEL_SHOT``. Graphs as in ``_eval_step`` (``panel.capture(batch,
    shot_num)`` captures one ahead)."""
    def device_forward(image, boxes, *, shot_num: int) -> Dict:
        return {"density": model(image, boxes, shot_num).float()}

    return _eval_step(next(model.parameters()).device, device_forward,
                      lambda batch: (batch["image"], batch["boxes"]), graphed)


def make_store_eval_step(model: nn.Module, val_arrays: Mapping, graphed: bool | None = None,
                         mesh=None):
    """Returns eval(batch, shot_num) -> the sums of ``make_eval_step`` over
    the resident validation samples (``ValStore.arrays``) at batch['idxs']
    [B], with batch['valid'] [B] (the JAX ``make_store_eval_step``): the
    per-epoch upload is the index vectors. The true counts are the store's
    precomputed ones. ``mesh`` and graphs as in ``make_eval_step``."""
    from countr_tpu_torch.engine.train_store import INV_255

    group, world = _group_of(mesh)

    def device_eval(idxs, valid, *, shot_num: int) -> Dict:
        idxs = idxs.long()
        imgs = val_arrays["images"][idxs].float() * INV_255
        out = model(imgs, val_arrays["boxes"][idxs], shot_num)
        return _across(_error_sums(out.sum(dim=(1, 2)) / DENSITY_SCALE,
                                   val_arrays["gt_cnt"][idxs], valid), group, world, mean=False)

    return _eval_step(next(model.parameters()).device, device_eval,
                      lambda batch: (batch["idxs"], batch["valid"]), graphed)


def _pretrain_device(state: TrainState, imgs, noise, generator, update: bool) -> Dict:
    """The device's part of an MAE pretrain mini-step: the masking noise is
    ``noise`` or, if None, drawn from ``generator`` at the global batch's
    shape [B * world, L], this rank's rows kept (what the model draws
    itself at world 1)."""
    if noise is None:
        p = state.model.cfg.patch_size
        n_patches = (imgs.shape[1] // p) * (imgs.shape[2] // p)
        noise = rows_of(torch.rand((imgs.shape[0] * state.world, n_patches),
                                   generator=generator, device=generator.device),
                        state.rank, state.world)
    state.zero_grads()
    loss, _, _ = state.model(imgs, noise=noise)
    loss.backward()
    state.apply_gradients(update)
    return _across({"loss": loss.detach()}, state.group, state.world, mean=True)


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
    gen = _generator(state, cfg, generator)

    def device_step(imgs, *noise, update: bool) -> Dict:
        return _pretrain_device(state, imgs, noise[0] if noise else None, gen, update)

    return _train_step(state, device_step, gen, graphed, lambda imgs, noise=None: (
        (imgs,) if noise is None else (imgs, noise), {}))


def make_store_pretrain_step(
    state: TrainState, cfg: TrainConfig, store_arrays: Mapping, max_w: int,
    generator: torch.Generator | None = None, graphed: bool | None = None,
) -> Callable[..., Dict]:
    """Returns step(batch, noise=None) -> metrics: the resident-store MAE
    pretrain step (the JAX ``make_store_pretrain_step``,
    ``engine/train.py:386``). batch holds the crop's scalars
    (``train_store.PRETRAIN_KEYS``, from ``PretrainDataset(store=...)``) on
    the store's device, ~30 bytes a sample; the step materialises the
    RandomResizedCrop + flip from ``store_arrays`` (``PretrainStore.arrays``,
    read in place) with its two fp32 band products, at the model's
    ``img_size``, then trains as ``make_pretrain_step`` does. Noise, graphs
    and ``graphed`` as there."""
    from countr_tpu_torch.engine.train_store import PRETRAIN_KEYS, materialize_pretrain_batch

    gen = _generator(state, cfg, generator)
    n = len(PRETRAIN_KEYS)
    size = state.model.cfg.img_size

    def device_step(*ins, update: bool) -> Dict:
        with torch.no_grad():
            imgs = materialize_pretrain_batch(store_arrays, dict(zip(PRETRAIN_KEYS, ins[:n])),
                                              max_w, size)
        return _pretrain_device(state, imgs, ins[n] if len(ins) > n else None, gen, update)

    return _train_step(state, device_step, gen, graphed, lambda batch, noise=None: (
        tuple(batch[k] for k in PRETRAIN_KEYS) + (() if noise is None else (noise,)), {}))


def _group_of(mesh) -> tuple:
    """(group, world) of a data-parallel ``mesh``, (None, 1) without."""
    return (mesh.group, mesh.world) if mesh is not None else (None, 1)


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
