"""Per-step warmup + half-cycle cosine LR schedule (counterpart of
``countr_tpu/engine/schedule.py``).

Matches the reference's fractional-epoch semantics
(reference: util/lr_sched.py:9-21, called per accumulation step at
FSC_finetune_cross.py:270-271 with epoch_float = step/steps_per_epoch
+ epoch): linear warmup to ``lr`` over ``warmup_epochs``, then
min_lr + (lr - min_lr) * 0.5 * (1 + cos(pi * progress)).
"""

from __future__ import annotations

import math


def warmup_cosine(
    lr: float,
    *,
    epochs: int,
    warmup_epochs: int,
    steps_per_epoch: int,
    min_lr: float = 0.0,
):
    """Returns a schedule fn: step (int) -> lr (float)."""

    def schedule(step: int) -> float:
        e = step / steps_per_epoch  # fractional epoch
        if e < warmup_epochs:
            return lr * e / max(warmup_epochs, 1e-8)
        progress = (e - warmup_epochs) / max(epochs - warmup_epochs, 1e-8)
        return min_lr + (lr - min_lr) * 0.5 * (1.0 + math.cos(math.pi * progress))

    return schedule
