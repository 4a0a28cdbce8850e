"""ViT building blocks (counterpart of ``countr_tpu/models/vit.py``).

Parameters keep the reference state_dict layout (timm 0.4 Block,
reference: models_crossvit.py:46-156): ``norm1``/``norm2`` LayerNorms,
``attn.qkv``/``attn.proj`` and ``mlp.fc1``/``mlp.fc2`` Linears with
[out, in] weights. Parameters stay fp32; each module computes in its
``dtype`` with the weights cast at use (see ``cast_param``), and adds
the bias after the product in the compute dtype, as flax's Dense does.

In the bf16 fast mode the LayerNorms take kernel B1 (ops/fused_ln.py),
and a block's attention takes either kernel B2 for the whole branch
(ops/fused_block.py, with its backward through B3/B4) or kernels B3/B4
for the attention core (ops/fused_attn.py; the training builds of the
CLIs, where B2 is off), behind the JAX package's gates.
``fused_mlp_branch`` runs the MLP branch as kernel B5
(ops/fused_mlp.py); as in the JAX package, no Block calls it.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F
from torch import nn

from countr_tpu_torch.ops.attention import multi_head_attention
from countr_tpu_torch.ops.fused_attn import fused_attention_qkv
from countr_tpu_torch.ops.fused_block import fused_attention_block
from countr_tpu_torch.ops.fused_ln import fused_layer_norm
from countr_tpu_torch.ops.fused_mlp import fused_mlp_block

_CASTS = threading.local()


@contextlib.contextmanager
def casts_at_use():
    """Within it (on this thread, as ``torch.no_grad``), ``cast_param``
    casts at every use and reads no cached copy. The training and eval
    steps are captured in it: a CUDA graph would keep the cached copy's
    address, which goes stale when the weights change in place (an
    optimizer step, a checkpoint restore), while a cast inside the graph
    reads the weights themselves."""
    prev = getattr(_CASTS, "at_use", False)
    _CASTS.at_use = True
    try:
        yield
    finally:
        _CASTS.at_use = prev


def cast_param(p: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``p`` in ``dtype``. Under autograd (grad mode on and ``p``
    requiring grad) the cast is made at use and stays differentiable: the
    gradient comes back to the fp32 parameter, as flax's cast-through
    VJP does. Otherwise (inference, ``no_grad``, a frozen parameter) the
    copy is cached on the parameter until it changes, so a bf16 weight is
    made once, not at every forward, except within ``casts_at_use``; the
    values are the same."""
    if p.dtype == dtype:
        return p
    if getattr(_CASTS, "at_use", False) or p.requires_grad and torch.is_grad_enabled():
        return p.to(dtype)
    hit = getattr(p, "_countr_cast", None)
    key = (p._version, p.device, dtype)
    if hit is None or hit[0] != key:
        hit = (key, p.detach().to(dtype).contiguous())
        p._countr_cast = hit
    return hit[1]


def dense(x: torch.Tensor, lin: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """flax Dense numerics: x and the weight in ``dtype``, product, then
    the bias added in ``dtype``."""
    x = x.to(dtype)
    return F.linear(x, cast_param(lin.weight, dtype)) + cast_param(lin.bias, dtype)


class PatchEmbed(nn.Module):
    """[B, H, W, C] -> [B, (H/p)*(W/p), D] patch tokens; the stride-p conv
    (``proj``, weight [D, C, p, p]) runs as reshape + one matmul."""

    def __init__(self, patch_size: int, in_chans: int, embed_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.patch_size = patch_size
        self.dtype = dtype
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size, patch_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        p = self.patch_size
        gh, gw = h // p, w // p
        x = x.reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, gh * gw, p * p * c).to(self.dtype)
        # [D, C, p, p] -> [D, (p, p, C)], the patch-pixel flatten order
        wt = cast_param(self.proj.weight, self.dtype).permute(0, 2, 3, 1)
        wt = wt.reshape(wt.shape[0], -1)
        return F.linear(x, wt) + cast_param(self.proj.bias, self.dtype)


class Mlp(nn.Module):
    """Linear -> GELU -> Linear. GELU is exact erf (in fp32) by default;
    ``approx_gelu`` selects the tanh approximation."""

    def __init__(self, dim: int, hidden: int, dtype: torch.dtype = torch.float32,
                 approx_gelu: bool = False):
        super().__init__()
        self.dtype = dtype
        self.approx_gelu = approx_gelu
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = dense(x, self.fc1, self.dtype)
        if self.approx_gelu:
            x = F.gelu(x, approximate="tanh")
        else:
            x = F.gelu(x.float()).to(self.dtype)
        return dense(x, self.fc2, self.dtype)


class LayerNorm(nn.LayerNorm):
    """fp32-statistics LayerNorm with learned ``weight``/``bias``.

    bf16 stage and bf16 input take kernel B1 (the JAX gate,
    models/vit.py:101-104); otherwise the module formulation below,
    whose output is in the stage dtype."""

    def __init__(self, dim: int, eps: float = 1e-6,
                 dtype: torch.dtype = torch.float32):
        super().__init__(dim, eps=eps)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype == torch.bfloat16 and x.dtype == torch.bfloat16:
            return fused_layer_norm(x, self.weight, self.bias, self.eps)
        x32 = x.float()
        mean = x32.mean(dim=-1, keepdim=True)
        var = (x32 - mean).square().mean(dim=-1, keepdim=True)
        y = (x32 - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight + self.bias).to(self.dtype)


class SelfAttention(nn.Module):
    """Fused-qkv MHSA (reference: models_crossvit.py:69-94).

    With ``use_kernels`` in a bf16 stage the attention core runs as
    kernels B3 (forward) and B4 (backward) on the packed qkv, the JAX
    gate of models/vit.py:175-178; otherwise the plain core."""

    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype = torch.float32,
                 use_kernels: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.use_kernels = use_kernels
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        qkv = dense(x, self.qkv, self.dtype)
        if self.use_kernels and self.dtype == torch.bfloat16:
            y = fused_attention_qkv(qkv, self.num_heads)
        else:
            y = multi_head_attention(*qkv.chunk(3, dim=-1), self.num_heads)
        return dense(y, self.proj, self.dtype)


def _branch_params(x: torch.Tensor, *params: torch.Tensor):
    """A fused branch's weights: the fp32 parameters themselves under
    autograd (the branch Function casts them and returns fp32 weight
    gradients, as the JAX entries take the fp32 flax params), else the
    cached copies in x's dtype."""
    if torch.is_grad_enabled() and any(p.requires_grad for p in params):
        return params
    return tuple(cast_param(p, x.dtype) for p in params)


def fused_attn_branch(x: torch.Tensor, norm: LayerNorm, attn: SelfAttention):
    """``x + proj(MHA(qkv(LN(x))))`` through kernel B2, from the same
    parameters as the LayerNorm/SelfAttention pair it replaces."""
    return fused_attention_block(
        x, norm.weight, norm.bias,
        *_branch_params(x, attn.qkv.weight, attn.qkv.bias, attn.proj.weight, attn.proj.bias),
        attn.num_heads, norm.eps,
    )


def fused_mlp_branch(x: torch.Tensor, norm: LayerNorm, mlp: Mlp):
    """``x + fc2(GELU(fc1(LN(x))))`` through kernel B5, from the same
    parameters as the LayerNorm/Mlp pair it would replace. Like the JAX
    package's (``models/vit.py:200``), no Block calls it: the fused MLP
    branch was measured slower than the modules on the TPU
    (``models/vit.py:259-263`` there)."""
    return fused_mlp_block(
        x, norm.weight, norm.bias,
        *_branch_params(x, mlp.fc1.weight, mlp.fc1.bias, mlp.fc2.weight, mlp.fc2.bias),
        norm.eps, mlp.approx_gelu,
    )


def use_fused_branch(use_kernels: bool, fused_block: bool, dtype, x) -> bool:
    """The JAX gate (models/vit.py:253-258): kernels on, the fused branch
    on, a bf16 stage and an already-bf16 residual stream."""
    return (use_kernels and fused_block and dtype == torch.bfloat16
            and x.dtype == torch.bfloat16)


class Block(nn.Module):
    """Pre-norm transformer encoder block (timm 0.4 Block semantics).

    With ``use_kernels`` and ``fused_block`` in a bf16 stage, the whole
    attention branch runs as kernel B2; with ``use_kernels`` alone, the
    attention core runs as B3/B4. The MLP branch stays modules."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 ln_eps: float = 1e-6, dtype: torch.dtype = torch.float32,
                 use_kernels: bool = False, fused_block: bool = True,
                 approx_gelu: bool = False):
        super().__init__()
        self.dtype = dtype
        self.use_kernels = use_kernels
        self.fused_block = fused_block
        self.norm1 = LayerNorm(dim, ln_eps, dtype)
        self.attn = SelfAttention(dim, num_heads, dtype, use_kernels)
        self.norm2 = LayerNorm(dim, ln_eps, dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype, approx_gelu)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if use_fused_branch(self.use_kernels, self.fused_block, self.dtype, x):
            x = fused_attn_branch(x, self.norm1, self.attn)
        else:
            x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))
