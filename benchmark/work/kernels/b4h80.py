"""B4 at head dim 80 (ViT-H/14's encoder, 16 heads of 80): the same
function, operations and bytes as ``b4.py`` (10*B*N^2*C; qkv and dout
read, dqkv written once, bf16), at the launches of the hd-80
instantiations of its two passes alone.

Trace names: ``bwd_stats_kernel<80>`` and ``bwd_main_kernel<80>``; the
decoder's B4 launches run ``<32>`` and are left out."""

from benchmark.work.kernels.b4 import flops, nbytes  # noqa: F401

# demangled ("<80>") and mangled ("ILi80E") forms of the names
TRACE_NAMES = tuple(f"{k}{t}" for k in ("bwd_stats_kernel", "bwd_main_kernel") for t in ("<80>", "ILi80E"))
