"""The port's Hopper kernels against their plain PyTorch versions, on the
card (bf16, the main path's shapes). Needs a CUDA device: every test
takes the ``cuda_device`` fixture, which skips without one. Imports no
JAX, so it runs on the card machine with

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py

Tolerances: B1 max|d| <= 2^-6 = 1.5625e-2 (docs/PARITY.md:228's
1.56e-2: one bf16 ulp in [2, 4)); B2 max|d| <= 2^-5 = 3.125e-2 (docs/PARITY.md:231's 3.1e-2: one
bf16 ulp of the residual stream in [4, 8); the kernel and the plain
version round at the same points but sum in another order). B3 and B4
(inputs N(0, 1)): one bf16 ulp of the largest reference value, and not
below docs/PARITY.md:229-230's 3.9e-3 (one ulp in [0.5, 1), where the
outputs at N = 576 lie); kernel and plain version round at the same
points (P and dS to bf16, outputs to bf16), so an output differs by one
rounding at most. B1's backward (B1bwd, its own kernels) at the
training steps' LayerNorm shapes: dx within one bf16 ulp of the largest
reference value (one rounding each side, after fp32 arithmetic in
another order), dscale and dbias within 1e-5 of their largest reference
value (fp32 sums over up to 23,328 rows in another order); the same
bits on two calls and replayed from a CUDA graph; only the gradients
asked for. The shared GEMM (ops/gemm.py) at every product of the
paths and at ragged M, N and K: max|d| <= 2^-5 * max(1, max|ref|), the
limit of B5, whose products it runs, and of B6 (kernel and plain version
round at the same points and sum in another order). B6, one kernel a
call, also at 64-row tiles that straddle batch elements, a single
partial tile and M not a multiple of 64, and at every width up to
C 2048 (LN(x) streamed; past C 1280 a 2-block cluster a tile, also with
an odd head count); it gives the same bits on two calls and replayed
from a CUDA graph on each launch plan, and its plans (resident or
streamed LN(x), one block or a cluster a tile) give the same bits where
a shape fits several. B2 and B3 also at
N = 1, 577 and 641, where the attention core holds K and V in shared
memory, and B3 at N = 832 and 833 at head dim 64, the last N it holds
and the first past it (the two-pass route). B3 and B4 also on logits
scaled x8 (one key dominates each row) at the same limit, and B3 and B4
give the same bits on two calls. B3 and B4 at head dim 80 (ViT-H/14's
encoder) at its pretrain shape, ragged N, the resident limit of 640 keys
and past it, x8 logits, the same bounds, counted by the hd-80 counters
too, and the same bits on two calls; the ViT-H decoder's [32, 729, 512]
at head dim 32. HGN (the density head's bias + GroupNorm + ReLU, and at
stage 3 the pred conv) at the count build's four head shapes, bf16 and
fp32: each output within one rounding of its plain version, elementwise
(kernel and plain version round at the same points, after statistics
summed in another order: one ulp of the reference, 2^-7 * |ref|, plus
1e-5 for the statistics' own fp32 difference in normalised units; fp32
outputs 1e-5 * max|ref|); the pred fold, a 256-term dot of such values
rounded once more, within two bf16 ulps of max|ref| (2^-6); the
statistics within 1e-5 relative, and against float64 no less accurate
than the fp32 arithmetic they replaced; the same bits on two calls and
replayed from a CUDA graph; the whole density head against the ATen chain it
replaces; and its refusals.
"""

import numpy as np
import pytest
import torch

from countr_tpu_torch.ops.fused_attn import (
    attention_bwd_plain, attention_exp2, core_plan, fused_attention, fused_attention_bwd,
    fused_attention_qkv, resident_max_n,
)
from countr_tpu_torch.ops.fused_block import attention_block_plain, fused_attention_block
from countr_tpu_torch.ops.fused_cross import cross_block_plain, fused_cross_attention_block
from countr_tpu_torch.ops.fused_gn import (
    fused_group_norm, fused_group_norm_phase, group_norm_phase_plain, group_norm_relu_plain,
    group_stats, group_stats_plain,
)
from countr_tpu_torch.ops.fused_ln import (
    fused_layer_norm, fused_layer_norm_bwd, layer_norm_bwd_plain, layer_norm_plain,
)
from countr_tpu_torch.ops.fused_mlp import fused_mlp_block, mlp_block_plain
from countr_tpu_torch.ops.gemm import EPILOGUES, gemm_nt, gemm_nt_plain

pytestmark = pytest.mark.cuda

LN_TOL = 2.0 ** -6
BLOCK_TOL = 2.0 ** -5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _t(rng, shape, dev, scale=1.0, offset=0.0, dtype=torch.float32):
    a = rng.standard_normal(shape).astype(np.float32) * scale + offset
    return torch.from_numpy(a).to(dev, dtype)


@pytest.mark.parametrize("rows,c", [(16 * 576, 768), (16 * 576, 512), (37, 96)])
def test_fused_ln_matches_plain(cuda_device, rows, c):
    rng = np.random.default_rng(0)
    x = _t(rng, (rows, c), cuda_device, dtype=torch.bfloat16)
    s = _t(rng, (c,), cuda_device, 0.05, 1.0)
    b = _t(rng, (c,), cuda_device, 0.05)
    n0 = fused_layer_norm.launches
    got = fused_layer_norm(x, s, b, 1e-6)
    torch.cuda.synchronize()
    assert fused_layer_norm.launches == n0 + 1
    want = layer_norm_plain(x, s, b, 1e-6)
    assert got.dtype == torch.bfloat16
    assert float((got.float() - want.float()).abs().max()) <= LN_TOL


@pytest.mark.parametrize("b,n,c,h", [
    (16, 576, 768, 12), (16, 576, 512, 16), (2, 128, 64, 4), (1, 192, 512, 16),
    (3, 100, 96, 3), (2, 70, 48, 3), (2, 577, 128, 2), (3, 1, 96, 3), (1, 641, 64, 4),
])
def test_fused_block_matches_plain(cuda_device, b, n, c, h):
    rng = np.random.default_rng(1)
    bf = torch.bfloat16
    x = _t(rng, (b, n, c), cuda_device, dtype=bf)
    lns = _t(rng, (c,), cuda_device, 0.05, 1.0)
    lnb = _t(rng, (c,), cuda_device, 0.05)
    w = [_t(rng, s, cuda_device, 0.05, dtype=bf)
         for s in ((3 * c, c), (3 * c,), (c, c), (c,))]
    n0 = fused_attention_block.launches
    got = fused_attention_block(x, lns, lnb, *w, h, 1e-6)
    torch.cuda.synchronize()
    assert fused_attention_block.launches == n0 + 1
    want = attention_block_plain(x, lns, lnb, *w, h, 1e-6)
    assert got.dtype == bf and got.shape == x.shape
    assert bool(torch.isfinite(got.float()).all())
    assert float((got.float() - want.float()).abs().max()) <= BLOCK_TOL


def test_fused_block_refuses_fp32_on_card(cuda_device):
    c = 64
    x = torch.zeros((1, 16, c), device=cuda_device)
    z = lambda *s: torch.zeros(s, device=cuda_device)  # noqa: E731
    with pytest.raises(ValueError):
        fused_attention_block(x, z(c), z(c), z(3 * c, c), z(3 * c), z(c, c), z(c), 4)


def test_fused_block_refuses_misaligned_on_card(cuda_device):
    c = 64
    x = torch.zeros(16 * c + 1, device=cuda_device, dtype=torch.bfloat16)[1:].view(1, 16, c)
    z = lambda *s: torch.zeros(s, device=cuda_device)  # noqa: E731
    with pytest.raises(ValueError, match="aligned"):
        fused_attention_block(x, z(c), z(c), z(3 * c, c), z(3 * c), z(c, c), z(c), 4)


def _ulp_limit(ref) -> float:
    top = float(ref.float().abs().max())
    return max(3.9e-3, 2.0 ** (np.floor(np.log2(top)) - 7))


ATTN_SHAPES = [(8, 576, 512, 16), (8, 576, 768, 12), (16, 288, 768, 12), (16, 576, 512, 16),
               (16, 576, 768, 12), (2, 37, 96, 3), (3, 100, 128, 2), (2, 70, 48, 3),
               (2, 577, 128, 2), (3, 1, 96, 3), (1, 641, 64, 4)]
# Head dim 64 at the attention core's resident limit and just past it.
RESIDENT_LIMIT_SHAPES = [(1, 832, 128, 2), (1, 833, 128, 2)]
# Logits scaled x8 (q times 8): one key dominates each row, so B4's online
# row statistics rescale their sums as the max grows; every head dim.
ATTN_X8_SHAPES = [(8, 576, 512, 16), (2, 100, 128, 2), (2, 70, 48, 3), (1, 641, 64, 4)]
# Head dim 80 (ViT-H/14's encoder, 16 heads of 80: tiles in two swizzled
# parts, B4's main pass on 2 warpgroups): its pretrain step's [32, 364,
# 1280], ragged N, the resident limit (640 keys) and past it (two-pass);
# and the ViT-H decoder's [32, 729, 512] at head dim 32.
HD80_SHAPES = [(32, 364, 1280, 16), (2, 100, 160, 2), (3, 37, 240, 3), (1, 640, 160, 2),
               (1, 641, 80, 1), (32, 729, 512, 16)]
HD80_X8_SHAPES = [(2, 100, 160, 2), (1, 641, 80, 1)]


@pytest.mark.parametrize("b,n,c,h,logit_scale", [s + (1.0,) for s in ATTN_SHAPES]
                         + [s + (1.0,) for s in RESIDENT_LIMIT_SHAPES]
                         + [s + (8.0,) for s in ATTN_X8_SHAPES]
                         + [s + (1.0,) for s in HD80_SHAPES]
                         + [s + (8.0,) for s in HD80_X8_SHAPES])
def test_fused_attention_matches_plain(cuda_device, b, n, c, h, logit_scale):
    rng = np.random.default_rng(2)
    qkv = _t(rng, (b, n, 3 * c), cuda_device, dtype=torch.bfloat16)
    qkv[..., :c] *= logit_scale  # exact: a power of 2
    g = _t(rng, (b, n, c), cuda_device, dtype=torch.bfloat16)
    counters = ("launches", "bwd_launches", "launches_h80", "bwd_launches_h80")
    before = [getattr(fused_attention, k) for k in counters]
    with torch.no_grad():
        got = fused_attention_qkv(qkv, h)
        dgot = fused_attention_bwd(qkv, g, h)
    torch.cuda.synchronize()
    h80 = int(c // h == 80)  # the hd-80 counters count those launches too
    assert [getattr(fused_attention, k) - v for k, v in zip(counters, before)] == [1, 1, h80, h80]
    q, k, v = qkv.chunk(3, dim=-1)
    want = attention_exp2(q, k, v, h)
    dwant = torch.cat(attention_bwd_plain(q, k, v, g, h), dim=-1)
    assert got.shape == (b, n, c) and dgot.shape == (b, n, 3 * c)
    assert bool(torch.isfinite(got.float()).all() and torch.isfinite(dgot.float()).all())
    assert float((got.float() - want.float()).abs().max()) <= _ulp_limit(want)
    assert float((dgot.float() - dwant.float()).abs().max()) <= _ulp_limit(dwant)


def test_attention_core_routes(cuda_device):
    """The resident route takes every N up to its limit (832 keys at head
    dim 64, 640 at 80) and the two-pass route the N past it; the card
    tests' shapes at and past the limit run one each. ViT-H/14's encoder
    shape runs 4 warpgroups with 2 Q buffers, one block an SM."""
    assert (resident_max_n(64), resident_max_n(80)) == (832, 640)
    assert [core_plan(*s)["resident"] for s in RESIDENT_LIMIT_SHAPES] == [1, 0]
    assert [core_plan(*s)["resident"] for s in HD80_SHAPES[3:5]] == [1, 0]
    for b, n, c, h in ATTN_SHAPES:
        plan = core_plan(b, n, c, h)
        assert plan["resident"] == 1 and plan["blocks"] >= 1, (b, n, c, h, plan)
    plan = core_plan(*HD80_SHAPES[0])
    assert (plan["resident"], plan["warpgroups"], plan["q_buffers"],
            plan["blocks_per_sm"]) == (1, 4, 2, 1), plan


@pytest.mark.parametrize("b,n,c,h", [(8, 576, 512, 16), (16, 576, 768, 12), (2, 577, 128, 2),
                                     (1, 833, 128, 2), (32, 364, 1280, 16), (1, 641, 80, 1)])
def test_fused_attention_is_deterministic(cuda_device, b, n, c, h):
    """B3 gives the same bits on two calls with the same inputs (each
    query row's sums are taken in a fixed order by one warpgroup)."""
    rng = np.random.default_rng(14)
    qkv = _t(rng, (b, n, 3 * c), cuda_device, dtype=torch.bfloat16)
    with torch.no_grad():
        first = fused_attention_qkv(qkv, h)
        torch.cuda.synchronize()
        assert torch.equal(fused_attention_qkv(qkv, h), first)


@pytest.mark.parametrize("b,n,c,h", [(8, 576, 512, 16), (16, 288, 768, 12), (2, 577, 128, 2),
                                     (32, 364, 1280, 16), (1, 641, 80, 1)])
def test_fused_attention_bwd_is_deterministic(cuda_device, b, n, c, h):
    """B4 gives the same bits on two calls with the same inputs (each
    (batch, head) is one block that adds its dQ partials in a fixed
    order; no atomics)."""
    rng = np.random.default_rng(13)
    qkv = _t(rng, (b, n, 3 * c), cuda_device, dtype=torch.bfloat16)
    g = _t(rng, (b, n, c), cuda_device, dtype=torch.bfloat16)
    first = fused_attention_bwd(qkv, g, h)
    torch.cuda.synchronize()
    assert torch.equal(fused_attention_bwd(qkv, g, h), first)


def test_fused_attention_autograd_is_b4(cuda_device):
    """The autograd Function's backward is B4: its gradient is the
    kernel's, bit for bit, through the public q/k/v entry."""
    rng = np.random.default_rng(3)
    b, n, c, h = 2, 100, 128, 4
    q, k, v = (_t(rng, (b, n, c), cuda_device, dtype=torch.bfloat16).requires_grad_(True)
               for _ in range(3))
    g = _t(rng, (b, n, c), cuda_device, dtype=torch.bfloat16)
    m0 = fused_attention.bwd_launches
    fused_attention(q, k, v, h).backward(g)
    assert fused_attention.bwd_launches == m0 + 1
    want = fused_attention_bwd(torch.cat([q, k, v], dim=-1).detach(), g, h)
    assert torch.equal(torch.cat([q.grad, k.grad, v.grad], dim=-1), want)


def _ln_bwd_args(rng, dev, rows, c):
    x = _t(rng, (rows, c), dev, dtype=torch.bfloat16)
    s = _t(rng, (c,), dev, 0.05, 1.0)
    b = _t(rng, (c,), dev, 0.05)
    g = _t(rng, (rows, c), dev, dtype=torch.bfloat16)
    return x, s, b, g


def _assert_ln_bwd_close(got, want):
    """dx within one bf16 ulp of max|ref|; dscale and dbias within 1e-5
    of max|ref| (sums over up to 23,328 rows in another order)."""
    dx, ds, db = got
    assert dx.dtype == torch.bfloat16 and ds.dtype == db.dtype == torch.float32
    top = float(want[0].float().abs().max())
    assert max_d(dx, want[0]) <= 2.0 ** (np.floor(np.log2(top)) - 7)
    for a, w in zip((ds, db), want[1:]):
        assert max_d(a, w) <= 1e-5 * float(w.abs().max())


def max_d(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def test_fused_ln_backward_matches_plain_autograd(cuda_device):
    """Autograd through B1 (its backward the B1bwd kernels) against
    autograd through the plain formula, at B1bwd's bounds (the backward
    was once the plain formula's VJP itself, and equal to the bit)."""
    x, s, b, g = _ln_bwd_args(np.random.default_rng(4), cuda_device, 4 * 576, 512)
    grads = []
    for fn in (fused_layer_norm, layer_norm_plain):
        xs = [t.detach().clone().requires_grad_(True) for t in (x, s, b)]
        n0 = fused_layer_norm.bwd_launches
        fn(*xs, 1e-6).backward(g)
        grads.append([t.grad for t in xs])
    assert fused_layer_norm.bwd_launches == n0  # the plain formula's backward: no kernel
    _assert_ln_bwd_close(*grads)


# The training steps' LayerNorm shapes: ViT-H/14's encoder and decoder,
# mae_base's encoder and decoder; and ragged small ones (C 80 and 96: two
# register tiles, rows not a multiple of a tile).
LN_BWD_SHAPES = [(11648, 1280), (23328, 512), (4608, 768), (9216, 512), (37, 96), (5, 80)]


@pytest.mark.parametrize("rows,c", LN_BWD_SHAPES)
def test_fused_ln_backward_kernel_matches_plain(cuda_device, rows, c):
    """B1bwd against ``layer_norm_bwd_plain``; two calls give the same
    bits; one B1bwd a backward call, and no forward launch."""
    x, s, b, g = _ln_bwd_args(np.random.default_rng(rows + c), cuda_device, rows, c)
    n0, f0 = fused_layer_norm.bwd_launches, fused_layer_norm.launches
    first = fused_layer_norm_bwd(x, s, b, g, 1e-6)
    second = fused_layer_norm_bwd(x, s, b, g, 1e-6)
    torch.cuda.synchronize()
    assert fused_layer_norm.bwd_launches == n0 + 2 and fused_layer_norm.launches == f0
    _assert_ln_bwd_close(first, layer_norm_bwd_plain(x, s, b, g, 1e-6))
    for a, w in zip(first, second):
        assert torch.equal(a, w)


@pytest.mark.parametrize("needs", [(True, False, False), (False, True, True),
                                   (False, True, False), (True, False, True)])
def test_fused_ln_backward_computes_what_is_asked_on_card(cuda_device, needs):
    """Through autograd: the inputs that require grad get their gradients
    (within B1bwd's bounds of the plain version's; each subset compiles
    a kernel of its own, which may round dx apart from the full call's),
    the others none."""
    x, s, b, g = _ln_bwd_args(np.random.default_rng(5), cuda_device, 4 * 576, 768)
    want = layer_norm_bwd_plain(x, s, b, g, 1e-6)
    ts = [t.detach().clone().requires_grad_(need) for t, need in zip((x, s, b), needs)]
    n0 = fused_layer_norm.bwd_launches
    fused_layer_norm(*ts, 1e-6).backward(g)
    assert fused_layer_norm.bwd_launches == n0 + 1
    top = float(want[0].float().abs().max())
    lims = [2.0 ** (np.floor(np.log2(top)) - 7)] + [1e-5 * float(w.abs().max()) for w in want[1:]]
    for t, need, w, lim in zip(ts, needs, want, lims):
        assert (t.grad is None) if not need else max_d(t.grad, w) <= lim


def test_fused_ln_backward_graphed_equals_eager(cuda_device):
    """A backward captured in a CUDA graph and replayed gives the eager
    call's bits, on the captured inputs and on new values copied in."""
    rng = np.random.default_rng(6)
    x, s, b, g = _ln_bwd_args(rng, cuda_device, 11648, 1280)
    eager = fused_layer_norm_bwd(x, s, b, g, 1e-6)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        fused_layer_norm_bwd(x, s, b, g, 1e-6)
        n0 = fused_layer_norm.bwd_launches
        with torch.cuda.graph(graph, stream=side):
            out = fused_layer_norm_bwd(x, s, b, g, 1e-6)
    torch.cuda.current_stream().wait_stream(side)
    assert fused_layer_norm.bwd_launches == n0 + 1
    graph.replay()
    torch.cuda.synchronize()
    for a, w in zip(out, eager):
        assert torch.equal(a, w)
    x.copy_(_t(rng, tuple(x.shape), cuda_device, dtype=torch.bfloat16))
    g.copy_(_t(rng, tuple(g.shape), cuda_device, dtype=torch.bfloat16))
    graph.replay()
    torch.cuda.synchronize()
    for a, w in zip(out, fused_layer_norm_bwd(x, s, b, g, 1e-6)):
        assert torch.equal(a, w)


def _cosine(a, b) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm()))


@pytest.mark.parametrize("b,n,c,h", [(16, 576, 768, 12), (16, 576, 512, 16), (2, 70, 48, 3)])
def test_fused_block_backward_matches_plain_autograd(cuda_device, b, n, c, h):
    """B2's backward (B3 recompute, B4) against autograd through the plain
    version, from fp32 weights: fp32 weight gradients, cosine >= 0.99."""
    rng = np.random.default_rng(5)
    x = _t(rng, (b, n, c), cuda_device, dtype=torch.bfloat16)
    w = [_t(rng, (c,), cuda_device, 0.05, 1.0), _t(rng, (c,), cuda_device, 0.05)]
    w += [_t(rng, s, cuda_device, 0.05) for s in ((3 * c, c), (3 * c,), (c, c), (c,))]
    g = _t(rng, (b, n, c), cuda_device, dtype=torch.bfloat16)
    grads = []
    for fn in (fused_attention_block, attention_block_plain):
        ts = [t.detach().clone().requires_grad_(True) for t in (x, *w)]
        n0, m0 = fused_attention.launches, fused_attention.bwd_launches
        fn(*ts, h, 1e-6).backward(g)
        grads.append([t.grad for t in ts])
        if fn is fused_attention_block:
            assert (fused_attention.launches, fused_attention.bwd_launches) == (n0 + 1, m0 + 1)
    for got, want in zip(*grads):
        assert got.dtype == want.dtype and bool(torch.isfinite(got).all())
        assert _cosine(got, want) >= 0.99


MLP_SHAPES = [(16, 576, 768, 3072, True), (16, 576, 768, 3072, False),
              (16, 576, 512, 2048, True), (3, 37, 96, 384, False), (2, 70, 48, 200, True)]


def _mlp_args(rng, dev, b, n, c, hid):
    x = _t(rng, (b, n, c), dev, dtype=torch.bfloat16)
    w = [_t(rng, (c,), dev, 0.05, 1.0), _t(rng, (c,), dev, 0.05)]
    w += [_t(rng, s, dev, 0.05) for s in ((hid, c), (hid,), (c, hid), (c,))]
    return x, w


@pytest.mark.parametrize("b,n,c,hid,approx", MLP_SHAPES)
def test_fused_mlp_matches_plain(cuda_device, b, n, c, hid, approx):
    rng = np.random.default_rng(6)
    x, w = _mlp_args(rng, cuda_device, b, n, c, hid)
    n0 = fused_mlp_block.launches
    got = fused_mlp_block(x, *w, 1e-6, approx)
    torch.cuda.synchronize()
    assert fused_mlp_block.launches == n0 + 1
    want = mlp_block_plain(x, *w, 1e-6, approx)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    assert bool(torch.isfinite(got.float()).all())
    lim = BLOCK_TOL * max(1.0, float(want.float().abs().max()))
    assert float((got.float() - want.float()).abs().max()) <= lim


# (b, n, c, heads, ny): every head dim the kernel is built for, 8 to 256;
# the decoder's width with 64-row tiles that straddle batch elements at
# ny 8, a single partial tile, and M = 90 (not a multiple of 64) at hd 64;
# past 64 rows a tile on the H100's 132 SMs (M > 8448), the 65-72-row
# tiles at hd 256, at 66-67 rows with C = 96 (hd 32 and hd 8), and at
# 64-65 rows (some tiles without rows past 64)
CROSS_SHAPES = [(16, 576, 512, 16, 3), (16, 576, 512, 16, 1), (2, 37, 96, 3, 8),
                (3, 100, 64, 4, 5), (2, 70, 256, 2, 2), (2, 37, 64, 8, 2),
                (2, 50, 768, 12, 3), (2, 33, 512, 2, 4), (3, 100, 512, 16, 8),
                (1, 5, 512, 16, 2), (2, 45, 768, 12, 3), (16, 576, 512, 2, 3),
                (2, 4400, 96, 3, 8), (2, 4400, 96, 12, 3), (2, 4225, 64, 4, 2),
                # the widths past 768: LN(x) streamed by K-chunks; 13 heads
                # of 64; C 1280 in 5 heads of 256 (a cluster splits them 3
                # / 2); over 132 tiles; a partial tile at C 2048
                (2, 33, 832, 13, 4), (2, 45, 1024, 16, 3), (16, 576, 1024, 16, 3),
                (1, 5, 1280, 5, 2), (16, 576, 1280, 5, 3), (2, 45, 1536, 24, 3),
                (16, 576, 2048, 16, 3), (4, 2300, 2048, 16, 8), (2, 45, 2048, 8, 8),
                (2, 45, 2048, 16, 1)]


def _cross_args(rng, dev, b, n, c, ny):
    bf = torch.bfloat16
    x, k, v = (_t(rng, s, dev, dtype=bf) for s in ((b, n, c), (b, ny, c), (b, ny, c)))
    w = [_t(rng, (c,), dev, 0.05, 1.0), _t(rng, (c,), dev, 0.05)]
    wq = [_t(rng, s, dev, 0.05) for s in ((c, c), (c,))]
    wp = [_t(rng, s, dev, 0.05) for s in ((c, c), (c,))]
    return (x, *w, *wq, k, v, *wp)


@pytest.mark.parametrize("b,n,c,h,ny", CROSS_SHAPES)
def test_fused_cross_matches_plain(cuda_device, b, n, c, h, ny):
    rng = np.random.default_rng(7)
    args = _cross_args(rng, cuda_device, b, n, c, ny)
    n0 = fused_cross_attention_block.launches
    got = fused_cross_attention_block(*args, h, 1e-6)
    torch.cuda.synchronize()
    assert fused_cross_attention_block.launches == n0 + 1
    want = cross_block_plain(*args, h, 1e-6)
    assert got.dtype == torch.bfloat16 and got.shape == args[0].shape
    assert bool(torch.isfinite(got.float()).all())
    lim = BLOCK_TOL * max(1.0, float(want.float().abs().max()))
    assert float((got.float() - want.float()).abs().max()) <= lim


# a shape on each launch plan (fused_cross.plan): resident LN(x) (the
# decoder's, 72-row tiles; 64-row tiles), streamed LN(x) one block a tile
# (72-row tiles at C 1024; 64-row tiles at C 768), a 2-block cluster a
# tile (C 2048, 72-row tiles; a partial tile)
CROSS_PLAN_SHAPES = [(16, 576, 512, 16, 3, "auto"), (3, 100, 512, 16, 8, "auto"),
                     (16, 576, 1024, 16, 3, "auto"), (2, 50, 768, 12, 3, "streamed"),
                     (16, 576, 2048, 16, 3, "auto"), (2, 45, 2048, 16, 8, "auto")]


@pytest.mark.parametrize("b,n,c,h,ny,plan", CROSS_PLAN_SHAPES)
def test_fused_cross_is_deterministic(cuda_device, b, n, c, h, ny, plan):
    rng = np.random.default_rng(11)
    args = _cross_args(rng, cuda_device, b, n, c, ny)
    kw = dict(plan=plan)
    first = fused_cross_attention_block(*args, h, 1e-6, **kw)
    second = fused_cross_attention_block(*args, h, 1e-6, **kw)
    assert torch.equal(first, second)


@pytest.mark.parametrize("b,n,c,h,ny,plan", [CROSS_PLAN_SHAPES[i] for i in (0, 2, 3, 4)])
def test_fused_cross_graphed_equals_eager(cuda_device, b, n, c, h, ny, plan):
    """A call captured in a CUDA graph (after an eager warm-up, which
    sets the kernel's attributes) and replayed gives the eager call's
    bits, on the captured inputs and on new values copied into them."""
    rng = np.random.default_rng(12)
    args = _cross_args(rng, cuda_device, b, n, c, ny)
    kw = dict(plan=plan)
    eager = fused_cross_attention_block(*args, h, 1e-6, **kw)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        fused_cross_attention_block(*args, h, 1e-6, **kw)
        n0 = fused_cross_attention_block.launches
        with torch.cuda.graph(graph, stream=side):
            out = fused_cross_attention_block(*args, h, 1e-6, **kw)
    torch.cuda.current_stream().wait_stream(side)
    assert fused_cross_attention_block.launches == n0 + 1
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    x2 = _t(rng, tuple(args[0].shape), cuda_device, dtype=torch.bfloat16)
    args[0].copy_(x2)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, fused_cross_attention_block(*args, h, 1e-6, **kw))


@pytest.mark.parametrize("b,n,c,h,ny,plans", [
    (16, 576, 512, 16, 3, ("resident", "streamed", "cluster")),
    (2, 50, 768, 12, 3, ("resident", "streamed", "cluster")),
    (2, 4400, 96, 3, 8, ("resident", "streamed", "cluster")),
    (2, 70, 256, 2, 2, ("resident", "streamed", "cluster")),
    (16, 576, 1024, 16, 3, ("streamed", "cluster")),
    (2, 33, 832, 13, 4, ("streamed", "cluster")),
    (1, 5, 1280, 5, 2, ("streamed", "cluster"))])
def test_fused_cross_plans_give_the_same_bits(cuda_device, b, n, c, h, ny, plans):
    """Every plan rounds at the same points and sums each output in the
    same order, so where a shape fits several they agree to the bit (LN(x)
    resident or streamed; one block or a cluster a tile); the plan that
    does not fit a shape raises ValueError."""
    from countr_tpu_torch.ops.fused_cross import plan

    rng = np.random.default_rng(13)
    args = _cross_args(rng, cuda_device, b, n, c, ny)
    outs = [fused_cross_attention_block(*args, h, 1e-6, plan=p) for p in plans]
    for p, out in zip(plans[1:], outs[1:]):
        assert torch.equal(out, outs[0]), p
    infos = [plan(b * n, c, h, p) for p in plans]
    assert [i["ln"] for i in infos] == ["resident" if p == "resident" else "streamed"
                                        for p in plans]
    assert infos[-1]["cluster"] == 2
    if "resident" not in plans:
        with pytest.raises(ValueError, match="no resident plan"):
            fused_cross_attention_block(*args, h, 1e-6, plan="resident")


def test_fused_cross_takes_plain_route_above_8_tokens(cuda_device):
    rng = np.random.default_rng(8)
    args = _cross_args(rng, cuda_device, 2, 64, 64, 9)
    n0 = fused_cross_attention_block.launches
    got = fused_cross_attention_block(*args, 4, 1e-6)
    assert fused_cross_attention_block.launches == n0
    assert torch.equal(got, cross_block_plain(*args, 4, 1e-6))


def test_fused_mlp_and_cross_backward_is_the_plain_vjp(cuda_device):
    rng = np.random.default_rng(9)
    x, w = _mlp_args(rng, cuda_device, 2, 64, 64, 256)
    cross = _cross_args(rng, cuda_device, 2, 64, 64, 3)
    g = _t(rng, (2, 64, 64), cuda_device, dtype=torch.bfloat16)
    for fn, plain, args, extra in ((fused_mlp_block, mlp_block_plain, (x, *w), (1e-6, True)),
                                   (fused_cross_attention_block, cross_block_plain, cross,
                                    (4, 1e-6))):
        grads = []
        for f in (fn, plain):
            ts = [t.detach().clone().requires_grad_(True) for t in args]
            f(*ts, *extra).backward(g)
            grads.append([t.grad for t in ts])
        for got, want in zip(*grads):
            assert torch.equal(got, want)


def test_fused_mlp_and_cross_refuse_fp32_and_malformed_input(cuda_device):
    rng = np.random.default_rng(10)
    x, w = _mlp_args(rng, cuda_device, 1, 16, 64, 256)
    with pytest.raises(ValueError, match="bf16"):
        fused_mlp_block(x.float(), *w)
    with pytest.raises(ValueError, match="w_fc2"):
        fused_mlp_block(x, *w[:4], w[4][:, :128], w[5])
    with pytest.raises(ValueError, match="aligned"):
        xm = torch.zeros(16 * 64 + 1, device=cuda_device, dtype=torch.bfloat16)[1:]
        fused_mlp_block(xm.view(1, 16, 64), *w)
    args = list(_cross_args(rng, cuda_device, 1, 16, 64, 3))
    with pytest.raises(ValueError, match="bf16"):
        fused_cross_attention_block(args[0].float(), *args[1:], 4)
    with pytest.raises(ValueError, match="bf16"):
        fused_cross_attention_block(*args[:5], args[5].float(), *args[6:], 4)
    with pytest.raises(ValueError, match="k and v"):
        fused_cross_attention_block(*args[:6], args[6][:, :2].contiguous(), *args[7:], 4)
    with pytest.raises(ValueError, match="heads"):
        fused_cross_attention_block(*args, 5)
    # rows wider than B2 and B5 take
    wide = _cross_args(rng, cuda_device, 1, 16, 2056, 3)
    with pytest.raises(ValueError, match="C <= 2048"):
        fused_cross_attention_block(*wide, 8)


# (M, N, K, epilogue): every product of the paths at 16 windows (B2's qkv
# and proj, encoder and decoder; B5's fc1 and fc2), then ragged M, N, K.
GEMM_CASES = [
    (9216, 2304, 768, "bias"), (9216, 768, 768, "residual"), (9216, 1536, 512, "bias"),
    (9216, 512, 512, "residual"), (9216, 3072, 768, "gelu_tanh"), (9216, 3072, 768, "gelu_erf"),
    (9216, 768, 3072, "residual"), (9216, 2048, 512, "gelu_tanh"), (9216, 512, 2048, "residual"),
] + [(37, n, 48, e) for n in (96, 144) for e in EPILOGUES]


@pytest.mark.parametrize("m,n,k,epilogue", GEMM_CASES)
def test_gemm_matches_plain(cuda_device, m, n, k, epilogue):
    rng = np.random.default_rng(11)
    bf = torch.bfloat16
    a = _t(rng, (m, k), cuda_device, dtype=bf)
    w = _t(rng, (n, k), cuda_device, 0.05, dtype=bf)
    bias = _t(rng, (n,), cuda_device, 0.05, dtype=bf)
    r = _t(rng, (m, n), cuda_device, dtype=bf)
    n0 = gemm_nt.launches
    got = gemm_nt(a, w, bias, r, epilogue)
    torch.cuda.synchronize()
    assert gemm_nt.launches == n0 + 1
    want = gemm_nt_plain(a, w, bias, r, epilogue)
    assert got.dtype == bf and got.shape == (m, n)
    assert bool(torch.isfinite(got.float()).all())
    lim = BLOCK_TOL * max(1.0, float(want.float().abs().max()))
    assert float((got.float() - want.float()).abs().max()) <= lim


def test_gemm_refuses_malformed_input(cuda_device):
    rng = np.random.default_rng(12)
    bf = torch.bfloat16
    a = _t(rng, (16, 40), cuda_device, dtype=bf)
    w, bias = _t(rng, (8, 40), cuda_device, dtype=bf), _t(rng, (8,), cuda_device, dtype=bf)
    with pytest.raises(ValueError, match="bf16"):
        gemm_nt(a.float(), w, bias)
    with pytest.raises(ValueError, match="K % 8"):
        gemm_nt(a[:, :36].contiguous(), w[:, :36].contiguous(), bias)
    with pytest.raises(ValueError, match="residual"):
        gemm_nt(a, w, bias, torch.zeros((16, 4), device=cuda_device, dtype=bf), "residual")


# HGN at the count build's window batch: the head's stages 0-2 (NHWC) and
# stage 3's flat phase tensor [N, 96, 96, 4 * 256] with the pred fold.
HGN_SHAPES = [(16, 24, 24, 256), (16, 48, 48, 256), (16, 96, 96, 256)]
HGN_PHASE = (16, 96, 96, 256)


def _hgn_args(rng, dev, shape, dtype, nchw=False):
    """A conv output without its bias (N(0.3, 1.5^2)), [N, H, W, C] in
    NHWC or (``nchw``) NCHW order, as a conv on the card returns either;
    the conv bias, the GroupNorm scale and shift."""
    n, h, w, c = shape
    x = _t(rng, shape, dev, 1.5, 0.3, dtype)
    if nchw:
        x = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    return (x, _t(rng, (c,), dev, 0.3), _t(rng, (c,), dev, 0.1, 1.0), _t(rng, (c,), dev, 0.1))


def _phase_args(rng, dev, dtype, n=16, h=96, w=96, c=256, nchw=True):
    """fused_group_norm_phase's arguments: the phase tensor (without the
    conv bias), the strips, the conv bias, scale and shift, 8 groups, the
    pred kernel and bias."""
    ph, cb, s, b = _hgn_args(rng, dev, (n, h, w, 4 * c), dtype, nchw)
    strips = tuple(_t(rng, sh, dev, 1.5, 0.3, dtype) for sh in
                   ((n, 2, 2 * w, c), (n, 2, 2 * w, c), (n, 2 * h, 2, c), (n, 2 * h, 2, c)))
    pk = _t(rng, (c,), dev, 0.05, dtype=dtype)
    pb = _t(rng, (1,), dev, 0.1)
    return [ph, strips, cb[:c], s[:c], b[:c], 8, pk, pb]


def _within_rounding(got, want, dtype):
    d = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        return float(d.max()) <= 1e-5 * max(1.0, float(want.abs().max()))
    return bool((d <= 2.0 ** -7 * want.float().abs() + 1e-5).all())


@pytest.mark.parametrize("nchw", [False, True], ids=["nhwc", "nchw"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("shape", HGN_SHAPES)
def test_hgn_matches_plain(cuda_device, shape, dtype, nchw):
    rng = np.random.default_rng(20)
    x, cb, s, b = _hgn_args(rng, cuda_device, shape, dtype, nchw)
    st, st_plain = group_stats(x, cb, 8), group_stats_plain(x, cb, 8)
    torch.testing.assert_close(st, st_plain, rtol=1e-5, atol=1e-6)
    n0 = fused_group_norm.launches
    got = fused_group_norm(x, cb, s, b, 8)
    torch.cuda.synchronize()
    assert fused_group_norm.launches == n0 + 1
    assert got.dtype == dtype and got.shape == x.shape and got.stride() == x.stride()
    assert _within_rounding(got, group_norm_relu_plain(x, cb, s, b, 8), dtype)


@pytest.mark.parametrize("nchw", [False, True], ids=["nhwc", "nchw"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_hgn_phase_matches_plain(cuda_device, dtype, nchw):
    rng = np.random.default_rng(21)
    args = _phase_args(rng, cuda_device, dtype, nchw=nchw)
    ph, cb = args[0], args[2]
    sums = group_stats(ph, cb, 8, sums=True)
    torch.testing.assert_close(sums, group_stats_plain(ph, cb, 8, sums=True),
                               rtol=1e-5, atol=1e-2)
    n0 = fused_group_norm.launches
    z, mean, rstd = fused_group_norm_phase(*args)
    torch.cuda.synchronize()
    assert fused_group_norm.launches == n0 + 1
    z_p, mean_p, rstd_p = group_norm_phase_plain(*args)
    torch.testing.assert_close(mean, mean_p, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(rstd, rstd_p, rtol=1e-5, atol=0)
    assert z.dtype == dtype and z.shape == (16, 96, 96, 4)
    lim = (2.0 ** -6 if dtype == torch.bfloat16 else 1e-5) * float(z_p.float().abs().max())
    assert float((z.float() - z_p.float()).abs().max()) <= lim


@pytest.mark.parametrize("nchw", [False, True], ids=["nhwc", "nchw"])
def test_hgn_statistics_against_float64(cuda_device, nchw):
    """The kernels' mean and rstd, and stage 3's sum of squares, on data
    with a mean of 20 and a spread of 1 at stage 2's shape: within the
    error of the fp32 arithmetic they replaced on the card (ops/norms.py's
    two-pass mean and variance; ops/subpixel.py's sums), or 4 fp32 ulps
    where both are exact to rounding."""
    rng = np.random.default_rng(25)
    x, _, _, _ = _hgn_args(rng, cuda_device, (16, 96, 96, 256), torch.float32, nchw)
    x = (x - 0.3) / 1.5 + 20  # N(20, 1), in x's memory order
    assert x.is_contiguous() != nchw
    zero = torch.zeros(256, device=cuda_device)
    floor = 4 * 2.0 ** -24
    xg64 = x.double().reshape(16, -1, 8, 32)
    mean64 = xg64.mean(dim=(1, 3))
    rstd64 = 1 / torch.sqrt((xg64 - mean64[:, None, :, None]).square().mean(dim=(1, 3)) + 1e-5)
    xg = x.reshape(16, -1, 8, 32)
    mean_old = xg.mean(dim=(1, 3))
    rstd_old = torch.reciprocal(torch.sqrt(
        (xg - mean_old[:, None, :, None]).square().mean(dim=(1, 3)) + 1e-5))
    s2_old = xg.square().sum(dim=(1, 3))
    mean, rstd = group_stats(x, zero, 8).unbind(1)
    s2 = group_stats(x, zero, 8, sums=True)[:, 1]
    for got, old, ref in ((mean, mean_old, mean64), (rstd, rstd_old, rstd64),
                          (s2, s2_old, xg64.square().sum(dim=(1, 3)))):
        err = float(((got.double() - ref) / ref).abs().max())
        old_err = float(((old.double() - ref) / ref).abs().max())
        assert err <= max(old_err, floor), (err, old_err)


def _hgn_calls(dev):
    rng = np.random.default_rng(22)
    calls = [(fused_group_norm, (*_hgn_args(rng, dev, shape, torch.bfloat16, k > 0), 8))
             for k, shape in enumerate(HGN_SHAPES)]
    calls.append((lambda *a: fused_group_norm_phase(*a)[0],
                  _phase_args(rng, dev, torch.bfloat16)))
    return calls


def test_hgn_is_deterministic_and_graphs(cuda_device):
    """Two calls give the same bits at every shape, and so does a call
    captured in a CUDA graph (after an eager warm-up) and replayed."""
    calls = _hgn_calls(cuda_device)
    eager = [fn(*a) for fn, a in calls]
    for (fn, a), e in zip(calls, eager):
        assert torch.equal(fn(*a), e)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        n0 = fused_group_norm.launches
        with torch.cuda.graph(graph, stream=side):
            outs = [fn(*a) for fn, a in calls]
    torch.cuda.current_stream().wait_stream(side)
    assert fused_group_norm.launches == n0 + len(calls)
    graph.replay()
    torch.cuda.synchronize()
    for o, e in zip(outs, eager):
        assert torch.equal(o, e)


@pytest.mark.parametrize("subpixel", [True, False], ids=["subpixel_bf16", "reference_fp32"])
def test_density_head_hgn_against_aten_chain(cuda_device, subpixel):
    """The whole density head of the count build (subpixel, bf16) and of
    the mixed builds' fp32 head (reference form) on a [16, 24, 24, 512]
    token grid: HGN where no gradient is recorded, against the ATen chain
    that autograd takes. bf16: the densities within 2^-5 of max|ref| (four
    stages, each within a rounding of the chain, compound), the window
    sums within 1e-2; fp32: within 1e-5 of max|ref|."""
    from torch import nn

    from countr_tpu_torch.models.countr import density_head

    torch.manual_seed(23)
    stages = []
    for k in range(4):
        layers = [nn.Conv2d(512 if k == 0 else 256, 256, 3, padding=1),
                  nn.GroupNorm(8, 256), nn.ReLU()]
        if k == 3:
            layers.append(nn.Conv2d(256, 1, 1))
        stages.append(nn.Sequential(*layers).to(cuda_device))
    for st in stages:
        with torch.no_grad():
            st[1].weight.uniform_(0.8, 1.2)
            st[1].bias.uniform_(-0.1, 0.1)
    dtype = torch.bfloat16 if subpixel else torch.float32
    dtypes = (dtype,) * 5
    grid = torch.randn(16, 24, 24, 512, device=cuda_device).to(dtype)
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        n0 = fused_group_norm.launches
        with torch.inference_mode():
            got = density_head(grid, stages, dtypes, subpixel).float()
        assert fused_group_norm.launches == n0 + 4
        want = density_head(grid, stages, dtypes, subpixel).float()  # autograd: the chain
        assert fused_group_norm.launches == n0 + 4
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    want = want.detach()
    top = float(want.abs().max())
    d = float((got - want).abs().max())
    if subpixel:
        assert d <= 2.0 ** -5 * top
        torch.testing.assert_close(got.sum(dim=(1, 2)), want.sum(dim=(1, 2)), rtol=1e-2, atol=0)
    else:
        assert d <= 1e-5 * top


def test_hgn_refuses_on_card(cuda_device):
    rng = np.random.default_rng(24)
    x, cb, s, b = _hgn_args(rng, cuda_device, (2, 8, 8, 64), torch.bfloat16)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        fused_group_norm(x.half(), cb, s, b, 8)
    with pytest.raises(ValueError, match="dense"):
        fused_group_norm(x.transpose(1, 2), cb, s, b, 8)
    with pytest.raises(ValueError, match="conv_bias"):
        fused_group_norm(x, cb[:32], s, b, 8)
    with pytest.raises(ValueError, match="scale"):
        fused_group_norm(x, cb, s.cpu(), b, 8)
    with pytest.raises(ValueError, match="groups"):
        fused_group_norm(x, cb, s, b, 7)
    with pytest.raises(ValueError, match="gradient"):
        fused_group_norm(x, cb, s.requires_grad_(), b, 8)
    args = _phase_args(rng, cuda_device, torch.bfloat16, 2, 8, 8, 64)
    with pytest.raises(ValueError, match="pred_kernel"):
        fused_group_norm_phase(*args[:6], args[6].float(), args[7])
    with pytest.raises(ValueError, match=r"\[N, h, w, 256\]"):
        fused_group_norm_phase(args[0][..., :128].contiguous(), *args[1:])
