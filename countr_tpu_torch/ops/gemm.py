"""The GEMM that kernels B2, B5 and B6 share (``csrc/gemm.cuh``), exposed
alone with each of its epilogues, so the card tests and ``chip_smoke.py``
can hold it against its plain version and time it beside
``torch.matmul`` at every product of the paths. No model path calls it:
the block kernels launch the same GEMM from C.

``Out = epilogue(A · Wᵀ)`` for A [M, K] and W [N, K] (torch's [out, in]
layout), bf16, fp32 accumulation (wgmma), rounded where the TPU kernels
round (``pallas_block.py:60-63, 83-87, 228-240``): t = bf16(acc), then
t = bf16(t + bias), then by ``epilogue``

- ``"bias"``: nothing more;
- ``"residual"``: bf16(residual + t);
- ``"gelu_tanh"``: bf16(gelu_tanh(fp32 t)), rounded once;
- ``"gelu_erf"``: bf16(gelu_erf(fp32 t)).

``gemm_nt`` launches the kernel on a CUDA tensor (or raises) and is
``gemm_nt_plain`` on a CPU tensor. ``gemm_nt.launches`` counts kernel
launches. The kernel is built into ``csrc/mlp_block.cu``'s library
(``gemm_nt_forward``).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from countr_tpu_torch.ops import fused_mlp
from countr_tpu_torch.ops.cuda_build import launch, operand

EPILOGUES = ("bias", "residual", "gelu_tanh", "gelu_erf")  # gemm.cuh's Epilogue order
ENTRY = "gemm_nt"


def gemm_nt_plain(a, w, bias, residual=None, epilogue: str = "bias") -> torch.Tensor:
    """The kernel's function in plain PyTorch, at a's dtype: one rounding
    of the fp32 product, the bias added in a's dtype, then the epilogue."""
    if epilogue not in EPILOGUES:
        raise ValueError(f"{ENTRY}: epilogue must be one of {EPILOGUES}; got {epilogue!r}")
    cd = a.dtype
    t = F.linear(a, w.to(cd)) + bias.to(cd)
    if epilogue == "residual":
        return residual.to(cd) + t
    if epilogue == "gelu_tanh":
        return F.gelu(t, approximate="tanh")
    if epilogue == "gelu_erf":
        return F.gelu(t.float()).to(cd)
    return t


def _lib():
    lib, _ = fused_mlp._lib()
    if not getattr(lib, "_countr_gemm_bound", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.gemm_nt_forward.argtypes = [vp] * 5 + [ci] * 4 + [vp]
        lib.gemm_nt_forward.restype = ci
        lib._countr_gemm_bound = True
    return lib


def _launch(a, w, bias, residual, epilogue: str) -> torch.Tensor:
    if a.dtype != torch.bfloat16 or a.dim() != 2 or not a.is_contiguous() or a.data_ptr() % 16:
        raise ValueError(f"{ENTRY}: a must be a contiguous, 16-byte aligned bf16 [M, K] "
                         f"tensor; got {a.dtype} {tuple(a.shape)}")
    m, k = a.shape
    n = w.shape[0]
    if k % 8 or n % 8:
        raise ValueError(f"{ENTRY}: K={k}, N={n} is not supported (K % 8 == 0, N % 8 == 0)")
    dev, bf = a.device, torch.bfloat16
    w = operand(ENTRY, "w", w, bf, (n, k), dev)
    bias = operand(ENTRY, "bias", bias, bf, (n,), dev)
    r = None
    if epilogue == "residual":
        r = operand(ENTRY, "residual", residual, bf, (m, n), dev)
    lib = _lib()
    out = torch.empty((m, n), device=dev, dtype=bf)
    launch(ENTRY, lib.gemm_nt_forward, lib.mlp_block_error_string, dev,
           a, w, bias, r if r is not None else 0, out, m, n, k, EPILOGUES.index(epilogue))
    gemm_nt.launches += 1
    return out


def gemm_nt(a, w, bias, residual=None, epilogue: str = "bias") -> torch.Tensor:
    """``epilogue(a · wᵀ + bias)`` for a [M, K], w [N, K], bias [N] (and
    residual [M, N] for ``"residual"``): the shared Hopper GEMM on a CUDA
    tensor, ``gemm_nt_plain`` on a CPU tensor."""
    if epilogue not in EPILOGUES:
        raise ValueError(f"{ENTRY}: epilogue must be one of {EPILOGUES}; got {epilogue!r}")
    if epilogue == "residual" and residual is None:
        raise ValueError(f"{ENTRY}: the residual epilogue needs a residual")
    if a.device.type == "cpu":
        return gemm_nt_plain(a, w, bias, residual, epilogue)
    if a.device.type != "cuda":
        raise ValueError(f"{ENTRY}: unsupported device {a.device}")
    return _launch(a, w, bias, residual, epilogue)


gemm_nt.launches = 0
