"""Time B1's backward (``countr_tpu_torch/ops/fused_ln.py``: ``_ln_bwd``,
the row pass, and ``_ln_bwd_cols``, the column sums) on one CUDA card.

    python3 scripts/profile_torch_ln_bwd.py [--plans] [--out FILE]

At the LayerNorm shapes of the training steps (bf16 x and cotangent,
fp32 scale and bias): mae_base's pretrain [4608, 768] and [9216, 512],
ViT-H/14's [11648, 1280] and [23328, 512], and the finetune decoder's
[4608, 512]. Per shape it checks the kernels against
``layer_norm_bwd_plain`` (dx within one bf16 ulp of max|ref|, dscale and
dbias within 1e-5 of max|ref|, as tests/test_torch_cuda_kernels.py) and
that two calls give the same bits, then reports graph-replayed device
ms (``chip_smoke.graph_ms``) of: the kernels at ``bwd_plan``'s plan;
``layer_norm_bwd_plain``; the VJP of ``layer_norm_plain`` recomputed
under autograd (the ATen chain B1's backward ran before it had kernels);
``F.layer_norm``'s autograd backward (the library's yardstick); each
beside the bytes bound (6 bytes an element and 8 a column at 3.35 TB/s).
With ``--plans`` it also times every plan of a small grid (rows a tile,
warps, programs an SM),
each checked the same way. One JSON line per reading, also written to
FILE (default chiprun_out/profile_torch_ln_bwd.json). Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import importlib.util
import itertools
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SHAPES = ((4608, 768), (9216, 512), (11648, 1280), (23328, 512), (4608, 512))


def load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def plan_grid(c: int):
    """The plans ``--plans`` times at width ``c``."""
    from countr_tpu_torch.ops.fused_ln import BwdPlan

    block = 1 << (c - 1).bit_length()
    for rows, warps, per_sm in itertools.product((1, 2, 4, 8), (4, 8), (1, 2, 4, 8)):
        if rows * block <= 8192:
            yield BwdPlan(rows, warps, per_sm)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--plans", action="store_true")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "profile_torch_ln_bwd.json"))
    args = ap.parse_args(argv)

    import torch
    import torch.nn.functional as F

    from countr_tpu_torch.ops import fused_ln

    smoke = load_smoke()
    dev = torch.device("cuda")
    lines = []

    def say(**kv):
        lines.append(kv)
        print(json.dumps(kv), flush=True)

    say(device=torch.cuda.get_device_name(0), smi=smoke.smi_line())
    rng = np.random.default_rng(0)
    for rows, c in SHAPES:
        sets = [tuple(torch.from_numpy(rng.standard_normal((rows, c), np.float32)).to(
            dev, torch.bfloat16) for _ in range(2)) for _ in range(4)]
        s = torch.from_numpy(1 + 0.05 * rng.standard_normal(c, np.float32)).to(dev)
        b = torch.from_numpy(0.05 * rng.standard_normal(c, np.float32)).to(dev)
        x0, g0 = sets[0]
        want = fused_ln.layer_norm_bwd_plain(x0, s, b, g0, 1e-6)
        dx_lim = 2.0 ** (np.floor(np.log2(float(want[0].float().abs().max()))) - 7)
        sb_lim = [1e-5 * float(w.abs().max()) for w in want[1:]]
        bound_ms = (6 * rows * c + 8 * c) / smoke.H100_BYTES_PER_S * 1e3

        def check(plan):
            first = fused_ln._launch_bwd(x0, s, b, g0, 1e-6, (True, True, True), plan)
            second = fused_ln._launch_bwd(x0, s, b, g0, 1e-6, (True, True, True), plan)
            torch.cuda.synchronize()
            errs = [smoke.max_abs(a, w) for a, w in zip(first, want)]
            same = all(torch.equal(p, q) for p, q in zip(first, second))
            ok = errs[0] <= dx_lim and errs[1] <= sb_lim[0] and errs[2] <= sb_lim[1] and same
            return ok, errs, same

        def kernel_ms(plan):
            return smoke.graph_ms(torch, lambda x, g: fused_ln._launch_bwd(
                x, s, b, g, 1e-6, (True, True, True), plan), sets)

        plan = fused_ln.bwd_plan(c)
        ok, errs, same = check(plan)
        if not ok:
            raise AssertionError(f"B1bwd [{rows}, {c}] {plan}: errors {errs} (limits {dx_lim}, "
                                 f"{sb_lim}), same bits on two calls: {same}")

        def chain(x, g):
            xs = [t.detach().requires_grad_(True) for t in (x, s, b)]
            with torch.enable_grad():
                y = fused_ln.layer_norm_plain(*xs, 1e-6)
                return torch.autograd.grad(y, xs, g)

        sb16, bb16 = s.to(torch.bfloat16), b.to(torch.bfloat16)

        def library(x, g):
            xs = [t.detach().requires_grad_(True) for t in (x, sb16, bb16)]
            with torch.enable_grad():
                y = F.layer_norm(xs[0], (c,), xs[1], xs[2], 1e-6)
                return torch.autograd.grad(y, xs, g)

        say(shape=[rows, c], plan=plan._asdict(), max_abs_err=errs, limits=[dx_lim, *sb_lim],
            same_bits=same, ms=kernel_ms(plan), bound_ms=bound_ms, bound_by="bytes",
            plain_ms=smoke.graph_ms(torch, lambda x, g: fused_ln.layer_norm_bwd_plain(
                x, s, b, g, 1e-6), sets),
            aten_chain_ms=smoke.graph_ms(torch, chain, sets),
            library_ms=smoke.graph_ms(torch, library, sets),
            dx_only_ms=smoke.graph_ms(torch, lambda x, g: fused_ln._launch_bwd(
                x, s, b, g, 1e-6, (True, False, False)), sets),
            weights_only_ms=smoke.graph_ms(torch, lambda x, g: fused_ln._launch_bwd(
                x, s, b, g, 1e-6, (False, True, True)), sets))
        if args.plans:
            for p in plan_grid(c):
                try:
                    ok, errs, same = check(p)
                except Exception as e:  # a plan the compiler or the card refuses
                    say(shape=[rows, c], sweep=p._asdict(), ok=False, error=repr(e)[:300])
                    continue
                say(shape=[rows, c], sweep=p._asdict(), ok=ok, max_abs_err=errs,
                    ms=kernel_ms(p) if ok else None, bound_ms=bound_ms)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text("".join(json.dumps(ln) + "\n" for ln in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
