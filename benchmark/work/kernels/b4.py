"""B4, the attention core's backward (``ops/fused_attn.py`` +
``csrc/attn.cu``), copied from the bounds of ``chip_smoke.py``:
10*B*N^2*C operations (QK^T again, dP, dV, dQ, dK); bytes: qkv [B, N, 3C]
and dout [B, N, C] read, dqkv [B, N, 3C] written once, bf16.

Trace names: ``bwd_stats_kernel`` and ``bwd_main_kernel``, its two
passes."""

TRACE_NAMES = ("bwd_stats_kernel", "bwd_main_kernel")


def flops(b: int, n: int, c: int) -> float:
    return 10.0 * b * n * n * c


def nbytes(b: int, n: int, c: int) -> float:
    return 2.0 * b * n * 3 * c + 2.0 * b * n * c + 2.0 * b * n * 3 * c
