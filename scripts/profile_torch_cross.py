"""Time kernel B6 (the cross-attention half-block,
countr_tpu_torch/csrc/cross_block.cu) on one CUDA card.

    python3 scripts/profile_torch_cross.py [--tree DIR] [--plans] [--out FILE]

For the port under DIR (default: this checkout; the tree of another
commit, unpacked with ``git archive`` into a gitignored directory, times
that commit's B6 through its own wrapper and build), at the decoder's
[16, 576, 512], 16 heads, over ny 3, 1 and 8, and at [16, 576, 768], 12
heads (head dim 64), ny 3 (bf16, N(0, 1) activations, 0.05 N(0, 1)
weights, as ``chip_smoke.cross_phase`` makes them, from the same seed
whatever the tree), it reports per shape the call's device ms,
graph-replayed (``chip_smoke.graph_ms``), its max|d| against the tree's
``cross_block_plain``, and the tree's launch plan where its wrapper
reports one. With ``--plans`` (a tree whose wrapper names its plans,
``fused_cross.PLANS``) it also times every named plan that fits each
shape (LN(x) resident or streamed, one block or a 2-block cluster a
tile), a line each. One tree a process: to compare two commits, run
parent, this, this, parent in one command on the card. Prints one JSON
line per shape and plan and writes them to FILE (default
out_profile/profile_torch_cross.json; out_*/ is gitignored). Needs a
CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SHAPES = ((16, 576, 512, 16, 3), (16, 576, 512, 16, 1), (16, 576, 512, 16, 8),
          (16, 576, 768, 12, 3))


def load_smoke():
    """This checkout's chip_smoke.py, whatever tree is timed."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--plans", action="store_true")
    ap.add_argument("--out", default="out_profile/profile_torch_cross.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_cross: no CUDA device", file=sys.stderr)
        return 1
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    from countr_tpu_torch.ops import fused_cross

    smoke = load_smoke()
    plan = getattr(fused_cross, "plan", None)
    dev = torch.device("cuda")
    lines = []
    for b, n, c, h, ny in SHAPES:
        rng = np.random.default_rng(8)
        xs = [smoke.randn_on(torch, rng, dev, (b, n, c)) for _ in range(4)]
        k, v = (smoke.randn_on(torch, rng, dev, (b, ny, c)) for _ in range(2))
        lns = smoke.randn_on(torch, rng, dev, (c,), 0.05, 1.0, torch.float32)
        lnb = smoke.randn_on(torch, rng, dev, (c,), 0.05, 0.0, torch.float32)
        wq, bq, wp, bp = (smoke.randn_on(torch, rng, dev, s, 0.05)
                          for s in ((c, c), (c,), (c, c), (c,)))
        rest = (lns, lnb, wq, bq, k, v, wp, bp, h, 1e-6)

        names = [None]
        if args.plans:
            for name in sorted(set(fused_cross.PLANS) - {"auto"}):
                try:
                    plan(b * n, c, h, name)
                    names.append(name)
                except ValueError:  # the shape does not fit this plan
                    pass
        for name in names:
            kw = {"plan": name} if name else {}

            def kernel(x):
                return fused_cross.fused_cross_attention_block(x, *rest, **kw)

            err = smoke.max_abs(kernel(xs[0]), fused_cross.cross_block_plain(xs[0], *rest))
            info = (plan(b * n, c, h, name) if name else plan(b * n, c, h)) if plan else None
            line = dict(tree=str(tree), shape=[b, n, c, h], ny=ny, plan_name=name or "auto",
                        max_abs_err=err, ms=smoke.graph_ms(torch, kernel, [(x,) for x in xs]),
                        plan=info, card=smoke.smi_line())
            lines.append(line)
            print(json.dumps(line), flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text("\n".join(json.dumps(x) for x in lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
