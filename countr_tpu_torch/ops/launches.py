"""The kernel wrappers' launch counters, read and set together.

Each wrapper adds one to its counter where it launches its kernel
(``fused_layer_norm.launches`` for B1's forward and ``.bwd_launches`` for
its backward, B1bwd, one a backward call whatever its launches;
``fused_attention_block.launches`` for B2, ``fused_attention.launches``
and ``.bwd_launches`` for B3 and B4 at every head dim, ``.launches_h80``
and ``.bwd_launches_h80`` for those of them at head dim 80 (B3h80,
B4h80), ``fused_mlp_block.launches`` for B5,
``fused_cross_attention_block.launches`` for B6, ``fused_adamw.launches``
for the training state's AdamW update, and ``fused_group_norm.launches``
for HGN, the density head's GroupNorm, one a stage call; neither replaces
a TPU kernel). A CUDA graph's replay runs
no wrapper: the graph runner (engine/graphs.py) keeps its own counts.
"""

from __future__ import annotations

KERNELS = ("B1", "B2", "B3", "B4", "B5", "B6", "AdamW", "B3h80", "B4h80", "B1bwd", "HGN")


def _counters():
    from countr_tpu_torch.ops.fused_adamw import fused_adamw
    from countr_tpu_torch.ops.fused_attn import fused_attention
    from countr_tpu_torch.ops.fused_block import fused_attention_block
    from countr_tpu_torch.ops.fused_cross import fused_cross_attention_block
    from countr_tpu_torch.ops.fused_gn import fused_group_norm
    from countr_tpu_torch.ops.fused_ln import fused_layer_norm
    from countr_tpu_torch.ops.fused_mlp import fused_mlp_block

    return {"B1": (fused_layer_norm, "launches"), "B2": (fused_attention_block, "launches"),
            "B3": (fused_attention, "launches"), "B4": (fused_attention, "bwd_launches"),
            "B5": (fused_mlp_block, "launches"),
            "B6": (fused_cross_attention_block, "launches"),
            "AdamW": (fused_adamw, "launches"),
            "B3h80": (fused_attention, "launches_h80"),
            "B4h80": (fused_attention, "bwd_launches_h80"),
            "B1bwd": (fused_layer_norm, "bwd_launches"),
            "HGN": (fused_group_norm, "launches")}


def launch_counts() -> dict:
    """{kernel id: the wrapper's launch count}."""
    return {k: getattr(fn, attr) for k, (fn, attr) in _counters().items()}


def set_launch_counts(counts: dict) -> None:
    """Set every wrapper's counter to ``counts[kernel id]``."""
    for k, (fn, attr) in _counters().items():
        setattr(fn, attr, counts[k])


def reset_launch_counts() -> None:
    set_launch_counts(dict.fromkeys(KERNELS, 0))
