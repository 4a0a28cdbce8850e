"""Profile kernels B3 and B4 (the attention forward and backward,
countr_tpu_torch/csrc/attn.cu and the core of csrc/attention.cuh) on one
CUDA card, kernel by kernel.

    python3 scripts/profile_torch_attn.py [--tree DIR] [--out FILE]

For the port under DIR (default: this checkout; the tree of another
commit, unpacked with ``git archive`` into a gitignored directory,
profiles that commit's kernels through its own wrappers and build), at
the shapes of the model paths ([8, 576, 512] x16 decoder, [8, 576, 768]
x12 encoder, [16, 288, 768] x12 MAE encoder, [16, 576, 512] x16 MAE
decoder, and for B3 also B2's encoder [16, 576, 768] x12; bf16,
N(0, 1)) it reports, per kernel and shape:
  - the call's device ms, graph-replayed (``chip_smoke.graph_ms``), and
    the function's work (B3 4·B·N²·C, B4 10·B·N²·C FLOP) over it in
    TFLOP/s;
  - each CUDA kernel's device ms per call (``chip_smoke.profile_run``
    over 20 calls);
  - B3's plan where the tree's wrapper reports one (``core_plan``:
    route, warpgroups, blocks an SM, blocks, shared bytes a block);
and, per CUDA kernel of the library, the static count of the SASS
instructions that decide what can bound it: tensor-core products (HMMA,
HGMMA), special function unit ops (MUFU: exp2, reciprocal), block
barriers (BAR), asynchronous copies (LDGSTS, UTMALDG, UBLKCP) and
mbarrier waits (SYNCS), from cuobjdump. Prints one JSON line per kernel
and shape and one of SASS counts, and writes them to FILE (default
out_profile/profile_torch_attn.json; out_*/ is gitignored). Needs a CUDA
device and nvcc.
"""

from __future__ import annotations

import argparse
import collections
import importlib.util
import itertools
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
SHAPES = ((8, 576, 512, 16), (8, 576, 768, 12), (16, 288, 768, 12), (16, 576, 512, 16))
B3_SHAPES = SHAPES + ((16, 576, 768, 12),)
OPCODES = ("HMMA", "HGMMA", "MUFU.EX2", "MUFU.RCP", "BAR", "LDGSTS", "UTMALDG", "UBLKCP",
           "SYNCS", "FFMA", "FMUL", "FADD")


def load_smoke():
    """This checkout's chip_smoke.py, whatever tree is profiled."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def sass_counts(lib_path: str) -> dict:
    """{kernel: {opcode: static count}} from cuobjdump -sass."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True, text=True,
                          check=True).stdout
    counts, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = collections.Counter()
            continue
        if name is None:
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m:
            op = m.group(1)
            for want in OPCODES:
                if op == want or op.startswith(want + "."):
                    counts[name][want] += 1
    return {k: dict(v) for k, v in counts.items()}


def measure(torch, smoke, fn, shape, flop_per, backward, iters: int = 20) -> dict:
    b, n, c, h = shape
    rng = np.random.default_rng(0)

    def t(*s):
        return torch.from_numpy(rng.standard_normal(s, np.float32)).to("cuda", torch.bfloat16)

    sets = [(t(b, n, 3 * c), t(b, n, c)) if backward else (t(b, n, 3 * c),) for _ in range(4)]
    with torch.no_grad():
        ms = smoke.graph_ms(torch, lambda *x: fn(*x, h), sets)
        cycle = itertools.cycle(sets)
        prof = smoke.profile_run(torch, lambda: fn(*next(cycle), h), iters)
    return dict(shape=list(shape), ms=ms, tflops=flop_per * b * n * n * c / ms / 1e9,
                kernels=[k for k in prof["top"] if "attn" in k["kernel"] or "bwd" in k["kernel"]])


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--out", default="out_profile/profile_torch_attn.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_attn: no CUDA device", file=sys.stderr)
        return 1
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    from countr_tpu_torch.ops import fused_attn

    smoke = load_smoke()
    # B3's plan, where the tree's wrapper reports one
    plan = getattr(fused_attn, "core_plan", None)
    lines = []
    runs = [("B3", fused_attn.fused_attention_qkv, 4, False, B3_SHAPES),
            ("B4", fused_attn.fused_attention_bwd, 10, True, SHAPES)]
    for name, fn, flop_per, backward, shapes in runs:
        for shape in shapes:
            line = dict(kernel=name, tree=str(tree), card=smoke.smi_line(),
                        **measure(torch, smoke, fn, shape, flop_per, backward))
            if not backward:
                line["core"] = plan(*shape) if plan else None
            lines.append(line)
            print(json.dumps(line), flush=True)
    lines.append({"sass": sass_counts(fused_attn.build()["path"])})
    print(json.dumps(lines[-1]), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text("\n".join(json.dumps(x) for x in lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
