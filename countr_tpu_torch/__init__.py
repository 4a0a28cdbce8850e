"""countr_tpu_torch — the PyTorch/CUDA port of countr_tpu for NVIDIA Hopper.

The JAX package ``countr_tpu`` is the reference; this package mirrors its
module layout (config, ops, models, engine) in PyTorch idiom and imports
nothing of it, nor JAX. Its six TPU kernels are hand-written Hopper
kernels here:

- ``ops/fused_ln.py``: LayerNorm (Triton), replaces
  ``countr_tpu/ops/pallas_ln.py::_ln_kernel`` (B1);
- ``ops/fused_block.py`` + ``csrc/attn_block.cu``: the attention
  half-block ``x + proj(MHA(qkv(LN(x))))`` (CUDA C++, sm_90a), replaces
  ``countr_tpu/ops/pallas_block.py::_attn_block_kernel`` (B2);
- ``ops/fused_attn.py`` + ``csrc/attn.cu``: attention forward and
  backward, replace ``countr_tpu/ops/pallas_attn.py::_attn_kernel`` and
  ``_attn_bwd_kernel`` (B3, B4);
- ``ops/fused_mlp.py`` + ``csrc/mlp_block.cu``: the MLP half-block,
  replaces ``pallas_block.py::_mlp_block_kernel`` (B5);
- ``ops/fused_cross.py`` + ``csrc/cross_block.cu``: the cross-attention
  half-block, replaces ``pallas_block.py::_cross_block_kernel`` (B6).

Entry points (``models.build_countr``, ``models.build_mae``,
``engine.inference.CountingEngine``, ``entry.entry``, and the CLIs under
``cli/``: test, serve, demo, test_carpk, finetune, finetune_carpk,
pretrain) run on the card unless the caller passes ``device="cpu"``
(``--device cpu``); ``cli/aggregate`` is host code. ``CountingEngine``,
``count_image``, ``build_countr`` and ``build_mae`` are also names of the
package, resolved on first use.
"""

import torch

_LAZY = {
    "CountingEngine": ("countr_tpu_torch.engine.inference", "CountingEngine"),
    "count_image": ("countr_tpu_torch.engine.inference", "count_image"),
    "build_countr": ("countr_tpu_torch.models", "build_countr"),
    "build_mae": ("countr_tpu_torch.models", "build_mae"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        mod, sym = _LAZY[name]
        return getattr(importlib.import_module(mod), sym)
    raise AttributeError(f"module 'countr_tpu_torch' has no attribute {name!r}")


def resolve_device(device) -> torch.device:
    """``None`` means the CUDA card; a CUDA request without a card raises
    (no silent fall back to the CPU)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "countr_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' explicitly to run on the CPU"
        )
    return dev


def disable_tf32() -> None:
    """fp32 parity mode: full fp32 matrix products and convolutions (the
    JAX fp32 path runs Precision.HIGHEST; cuDNN convs default to TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
