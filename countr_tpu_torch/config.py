"""Typed model configuration (counterpart of ``countr_tpu/config.py``).

What the counting, finetune and pretrain paths need: the geometry
constants, the CounTR and MAE configs with torch dtypes, the named
presets and the training knobs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

# Density maps are scaled by this factor at synthesis time and divided
# back at count readout (reference: util/FSC147.py:278).
DENSITY_SCALE = 60.0

# All spatial processing happens on 384x384 windows.
IMG_SIZE = 384
PATCH_SIZE = 16
EXEMPLAR_SIZE = 64
MAX_SHOTS = 3  # exemplar slots of a training sample

# Sliding-window inference geometry (reference:
# FSC_test_cross(few-shot).py:294-349).
WINDOW = 384
STRIDE = 128

# Test-time normalization threshold (reference:
# FSC_test_cross(few-shot).py:353-359).
TTN_THRESHOLD = 1.8


@dataclasses.dataclass(frozen=True)
class CounTRConfig:
    """Counting model (reference: models_mae_cross.py:18-106).

    ``dtype`` is the compute dtype; parameters stay fp32. The bf16 fast
    mode sets ``use_pallas_attention`` (the fused kernels: LayerNorm and
    the attention half-block), ``approx_gelu`` and ``subpixel_head``.
    The name ``use_pallas_attention`` is kept from the JAX config so the
    two packages' presets read alike; here it gates the Hopper kernels.

    ``head_dtype`` overrides the density head's dtype (the mixed modes:
    fp32 under a bf16 trunk); ``head_stage_dtypes`` overrides it per
    stage (stage0 24^2, stage1 48^2, stage2 96^2, stage3 192^2,
    pred + final upsample; None entries follow the head dtype), and is
    incompatible with ``subpixel_head``. Every fp32 head stage runs in
    full fp32 (``disable_tf32``).
    """

    img_size: int = IMG_SIZE
    patch_size: int = PATCH_SIZE
    in_chans: int = 3
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    decoder_embed_dim: int = 512
    decoder_depth: int = 2
    decoder_num_heads: int = 16
    mlp_ratio: float = 4.0
    ln_eps: float = 1e-6
    dtype: torch.dtype = torch.float32
    use_pallas_attention: bool = False
    fused_attn_block: bool = True
    fused_attn_block_decoder: Optional[bool] = None
    approx_gelu: bool = False
    head_dtype: Optional[torch.dtype] = None
    encoder_dtype: Optional[torch.dtype] = None
    decoder_dtype: Optional[torch.dtype] = None
    head_stage_dtypes: Optional[Tuple[Optional[torch.dtype], ...]] = None
    subpixel_head: bool = False
    freeze_encoder: bool = True
    head_width: int = 256

    def __post_init__(self):
        if self.head_width % 8 != 0:
            raise ValueError(
                f"head_width must be a multiple of the 8 GroupNorm groups "
                f"(reference: models_mae_cross.py:80-100); got {self.head_width}"
            )
        if self.head_stage_dtypes is not None:
            if len(self.head_stage_dtypes) != 5:
                raise ValueError(
                    "head_stage_dtypes must have 5 entries (stage0..3, "
                    f"pred); got {len(self.head_stage_dtypes)}"
                )
            if self.subpixel_head:
                raise ValueError(
                    "head_stage_dtypes is incompatible with subpixel_head "
                    "(the fused phase-space path assumes one head dtype)"
                )

    @property
    def grid_size(self) -> int:
        return self.img_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid_size * self.grid_size

    @property
    def head_dtypes(self) -> Tuple[torch.dtype, ...]:
        """The density head's dtype per stage (stage0..3, pred), resolved."""
        head = self.head_dtype or self.dtype
        stages = self.head_stage_dtypes or (None,) * 5
        return tuple(d or head for d in stages)

    @property
    def computes_fp32(self) -> bool:
        """Whether any stage computes in fp32: then matrix products and
        convolutions must not run in TF32 (``disable_tf32``)."""
        stages = (self.encoder_dtype or self.dtype, self.decoder_dtype or self.dtype,
                  *self.head_dtypes)
        return torch.float32 in stages


COUNTR_PRESETS = {
    "mae_vit_base_patch16": CounTRConfig(),
    "mae_vit_base_patch16_dec512d8b": CounTRConfig(),
    "mae_vit_base4_patch16": CounTRConfig(decoder_depth=4),
    "mae_vit_base_patch16_fim4": CounTRConfig(decoder_depth=4),
    # 6 interaction blocks — the released-weights config
    "mae_vit_base6_patch16": CounTRConfig(decoder_depth=6),
    "mae_vit_base_patch16_fim6": CounTRConfig(decoder_depth=6),
    "mae_vit_large_patch16": CounTRConfig(embed_dim=1024, depth=24, num_heads=16),
    "mae_vit_huge_patch14": CounTRConfig(
        patch_size=14, embed_dim=1280, depth=32, num_heads=16, img_size=378
    ),
}


@dataclasses.dataclass(frozen=True)
class MAEConfig:
    """MAE pre-training model (MaskedAutoencoderViTNoCT equivalent;
    reference: models_mae_noct.py:11-51, :207-234 presets).

    Gates as in ``CounTRConfig``. It has no ``freeze_encoder``: an MAE
    model trains all its parameters.
    """

    img_size: int = IMG_SIZE
    patch_size: int = PATCH_SIZE
    in_chans: int = 3
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    decoder_embed_dim: int = 512
    decoder_depth: int = 8
    decoder_num_heads: int = 16
    mlp_ratio: float = 4.0
    ln_eps: float = 1e-6
    norm_pix_loss: bool = False
    mask_ratio: float = 0.5  # reference: FSC_pretrain.py:45
    dtype: torch.dtype = torch.float32
    use_pallas_attention: bool = False
    fused_attn_block: bool = True
    approx_gelu: bool = False

    @property
    def grid_size(self) -> int:
        return self.img_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid_size * self.grid_size


MAE_PRESETS = {
    "mae_vit_base_patch16": MAEConfig(),
    "mae_vit_large_patch16": MAEConfig(embed_dim=1024, depth=24, num_heads=16),
    "mae_vit_huge_patch14": MAEConfig(
        patch_size=14, embed_dim=1280, depth=32, num_heads=16, img_size=378
    ),
}


def pretrain_overrides(dtype: str, fused_attn_block: bool = False) -> dict:
    """MAEConfig overrides of the pretrain CLI's build
    (``cli/pretrain.py:85-100``): in ``bf16`` the kernels (B1, B3/B4) and
    tanh GELU, with the fused half-block B2 off; ``fused_attn_block=True``
    keeps the config's own default, B2 on (its backward through B3/B4).
    ``fp32`` is the plain module path."""
    if dtype == "fp32":
        return dict(dtype=torch.float32, fused_attn_block=fused_attn_block)
    if dtype != "bf16":
        raise ValueError(f"unsupported dtype mode {dtype!r} (bf16 or fp32)")
    return dict(dtype=torch.bfloat16, use_pallas_attention=True, approx_gelu=True,
                fused_attn_block=fused_attn_block)


DTYPE_MODES = ("bf16", "fp32", "mixed", "mixed_fast", "mixed_bal")


def fast_mode_overrides(dtype: str, training: bool = False) -> dict:
    """Config overrides of the ``--dtype`` modes, as the JAX package's
    CLIs map them (cli/common.py:86-176): ``bf16`` (the fast mode: fused
    kernels, tanh GELU, subpixel head); ``fp32`` (plain module path,
    exact); ``mixed`` (the bf16 trunk with its kernels and tanh GELU under
    an fp32 density head on the reference formulation, no subpixel head);
    ``mixed_fast`` (the same build as ``mixed`` here); ``mixed_bal``
    (mixed with head stages 0-2 in bf16).
    ``training`` turns the fused attention half-block (B2) off and keeps
    the standalone kernels (B1, B3/B4), as the JAX package's training
    builds do (cli/common.py:126-130,149)."""
    bf16 = torch.bfloat16
    if dtype == "fp32":
        out = dict(dtype=torch.float32)
    elif dtype == "bf16":
        out = dict(dtype=bf16, use_pallas_attention=True, approx_gelu=True, subpixel_head=True)
    elif dtype in ("mixed", "mixed_fast", "mixed_bal"):
        # mixed_fast is JAX's Precision.HIGH head; the card has no such
        # mode (TF32 is coarser), so it runs as mixed's full fp32 head.
        out = dict(dtype=bf16, use_pallas_attention=True, approx_gelu=True,
                   subpixel_head=False, head_dtype=torch.float32,
                   head_stage_dtypes=(bf16, bf16, bf16, None, None) if dtype == "mixed_bal"
                   else None)
    else:
        raise ValueError(f"unsupported dtype mode {dtype!r} (one of {', '.join(DTYPE_MODES)})")
    if training:
        out["fused_attn_block"] = False
    return out


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Shared training-engine knobs.

    Defaults mirror the reference fine-tune script
    (reference: FSC_finetune_cross.py:30-107, run.sh:11-13).
    """

    batch_size: int = 8
    epochs: int = 1000
    warmup_epochs: int = 10
    blr: float = 2e-4
    lr: Optional[float] = None  # resolved as blr * eff_batch / 256
    min_lr: float = 0.0
    weight_decay: float = 0.05
    accum_iter: int = 1
    seed: int = 0
    # Loss pixel-mask keep probability (reference:
    # FSC_finetune_cross.py:290).
    loss_mask_p: float = 0.8
    # bf16 activations during training (params/opt state fp32).
    bf16: bool = True
    output_dir: str = "./out"
    ckpt_every_epochs: int = 50
    log_every_steps: int = 50

    def resolved_lr(self, world_batch: int) -> float:
        if self.lr is not None:
            return self.lr
        # reference: FSC_finetune_cross.py:220-221 (lr = blr * eff/256)
        return self.blr * world_batch / 256.0



@dataclasses.dataclass(frozen=True)
class TestConfig:
    """Inference-engine knobs (reference: FSC_test_cross(few-shot).py:26-78;
    the JAX package's ``TestConfig``)."""

    split: str = "test"
    external: bool = False
    box_bound: int = -1
    # >= this many tiny (<10x10) exemplars triggers 3x3 grid mode
    # (reference: FSC_test_cross(few-shot).py:59-60, :264-273).
    max_s_cnt: int = 1
    normalization: bool = True
    # windows per device forward (CountingEngine's batch_windows); a
    # multiple of the device count when the chunks are split over devices
    batch_windows: int = 16
    seed: int = 0
