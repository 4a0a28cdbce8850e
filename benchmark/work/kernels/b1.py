"""B1, the LayerNorm kernel (``ops/fused_ln.py``, Triton), copied from
the bounds of ``chip_smoke.py`` (PERF.md's kernel table: B1 is bound by
its bytes). A launch normalises ``rows`` rows of ``c`` bfloat16 values
with float32 statistics and a float32 scale and bias.

Trace names: the Triton kernel ``_ln_fwd`` (its compiled name starts so).
Its backward is the plain VJP (ATen kernels), not B1."""

TRACE_NAMES = ("_ln_fwd",)


def flops(rows: int, c: int) -> float:
    # mean, variance, normalise, scale and shift: ~8 operations a value,
    # on the CUDA cores; the bytes bound it
    return 8.0 * rows * c


def nbytes(rows: int, c: int) -> float:
    # x read, y written (bf16), scale and bias read (fp32)
    return 2.0 * rows * c * 2 + 2 * c * 4
