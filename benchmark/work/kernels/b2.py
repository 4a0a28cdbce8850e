"""B2, the attention half-block x + proj(MHA(qkv(LN(x)))) (``ops/
fused_block.py`` + ``csrc/attn_block.cu``), copied from the bounds of
``chip_smoke.py``: qkv 2*M*C*3C, QK^T and PV 4*B*N^2*C, proj 2*M*C^2
operations, M = B*N; bytes: x read and y written once (bf16), the
weights and biases read once.

Trace names: a B2 launch runs ``ln_rows_kernel``, ``gemm_nt_kernel``
twice and the attention core (``attn_resident_kernel`` or
``attn_twopass_kernel``). On the counting path no other wrapper launches
these (B3's core and B5/B6's GEMM are not on it), so their device time is
B2's there."""

TRACE_NAMES = ("ln_rows_kernel", "gemm_nt_kernel", "attn_resident_kernel",
               "attn_twopass_kernel")


def flops(b: int, n: int, c: int) -> float:
    m = b * n
    return 2.0 * m * c * 3 * c + 4.0 * b * n * n * c + 2.0 * m * c * c


def nbytes(b: int, n: int, c: int) -> float:
    m = b * n
    return 2.0 * m * c * 2 + 2.0 * (3 * c * c + c * c) + 2.0 * 4 * c + 4.0 * 2 * c
