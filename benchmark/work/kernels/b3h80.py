"""B3 at head dim 80 (ViT-H/14's encoder, 16 heads of 80): the same
function, operations and bytes as ``b3.py`` (4*B*N^2*C; qkv read and the
output written once, bf16), at the launches of the hd-80 instantiations
of the attention core alone.

Trace names: the templated kernels at HD = 80, ``attn_resident_kernel<80>``
(N <= 640) and ``attn_twopass_kernel<80>``; the decoder's B3 launches run
``<32>`` and are left out."""

from benchmark.work.kernels.b3 import flops, nbytes  # noqa: F401

# demangled ("<80>") and mangled ("ILi80E") forms of the names
TRACE_NAMES = tuple(f"{k}{t}" for k in ("attn_resident_kernel", "attn_twopass_kernel") for t in ("<80>", "ILi80E"))
