"""B3, the attention core's forward on packed qkv (``ops/fused_attn.py``
+ ``csrc/attn.cu``), copied from the bounds of ``chip_smoke.py``:
4*B*N^2*C operations (QK^T and PV); bytes: qkv [B, N, 3C] read and the
output [B, N, C] written once, bf16.

Trace names: ``attn_resident_kernel`` or ``attn_twopass_kernel``. On the
training paths B2 is off, so these are B3's there."""

TRACE_NAMES = ("attn_resident_kernel", "attn_twopass_kernel")


def flops(b: int, n: int, c: int) -> float:
    return 4.0 * b * n * n * c


def nbytes(b: int, n: int, c: int) -> float:
    return 2.0 * b * n * 3 * c + 2.0 * b * n * c
