"""B1's backward, B1bwd (``ops/fused_ln.py``: the Triton row pass
``_ln_bwd`` and column pass ``_ln_bwd_cols``). A launch takes ``rows``
rows of ``c`` bfloat16 values and their output cotangent, and gives the
input's gradient in bfloat16 and the float32 scale's and bias's
gradients. Bound by its bytes.

Trace names: both kernels' compiled names start with ``_ln_bwd``, which
``_ln_fwd`` (B1's forward, ``b1.py``) does not hold."""

TRACE_NAMES = ("_ln_bwd",)


def flops(rows: int, c: int) -> float:
    # the rows' statistics again, x^, g*s, two row sums, dx, and the two
    # column sums: ~12 operations a value on the CUDA cores
    return 12.0 * rows * c


def nbytes(rows: int, c: int) -> float:
    # x and g read, dx written (bf16); dscale and dbias written (fp32)
    return 6.0 * rows * c + 8 * c
