"""Put an eager MAE pretraining step's device time down to its source
operations, on one CUDA card.

    python3 scripts/profile_torch_train_step.py [--tree DIR] [--model NAME]
        [--batch N] [--steps N] [--out FILE]

Builds the pretrain CLI's bf16 MAE (``build_mae``: B1, B3/B4, B2 off) of
the port under DIR (default: this checkout; another commit's tree,
unpacked with ``git archive`` into a gitignored directory, profiles that
commit's code), runs ``make_pretrain_step(graphed=False)`` on random
[batch, img, img, 3] images (two steps to warm up), then ``--steps``
steps under ``torch.profiler``. Each device kernel is put down to the
ATen operation that launched it and to the outermost autograd node that
ran that operation (``autograd::engine::evaluate_function: <node>``; a
node's own backward may run a nested autograd pass, whose kernels stay
with it), or to "forward / update" outside any node. Prints one JSON
line: the step's wall ms, the device busy ms a step, the ms a step of
each node, of each (node, operation) pair, and of the kernels by name
under B1's node (``_LayerNormBackward``), with their launches a step;
also written to FILE (default chiprun_out/profile_torch_train_step_<model>.json).
Defaults: mae_vit_base_patch16 at batch 16 (the pretrain-resident cell's
step) and mae_vit_huge_patch14 at batch 32 (pretrain-huge-resident's).
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
BATCH = {"mae_vit_base_patch16": 16, "mae_vit_huge_patch14": 32}
NODE = "autograd::engine::evaluate_function: "


def source(ev) -> tuple:
    """(outermost autograd node or "forward / update", the launching op)."""
    node, p = "forward / update", ev
    while p is not None:
        if p.name.startswith(NODE):
            node = p.name[len(NODE):]
        p = p.cpu_parent
    return node, ev.name


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--model", default="mae_vit_base_patch16", choices=sorted(BATCH))
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.tree).resolve()))

    import torch
    from torch.profiler import ProfilerActivity, profile

    from countr_tpu_torch.config import TrainConfig
    from countr_tpu_torch.engine import train as engine
    from countr_tpu_torch.models import build_mae

    dev = torch.device("cuda")
    batch = args.batch or BATCH[args.model]
    model = build_mae(args.model, seed=0, device=dev)
    cfg = TrainConfig(batch_size=batch, lr=1e-4, min_lr=1e-4, warmup_epochs=0)
    state = engine.init_train_state(model, cfg, steps_per_epoch=100, world_batch=batch)
    step = engine.make_pretrain_step(state, cfg, torch.Generator(device=dev).manual_seed(0),
                                     graphed=False)
    size = model.cfg.img_size
    rng = np.random.default_rng(0)
    imgs = torch.from_numpy(rng.uniform(0, 1, (batch, size, size, 3)).astype(np.float32)).to(dev)
    for _ in range(2):
        step(imgs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step(imgs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps

    by_node, by_pair = collections.Counter(), collections.Counter()
    ln_kernels, ln_launches = collections.Counter(), collections.Counter()
    busy_ms = 0.0
    for ev in prof.events():
        kernels = getattr(ev, "kernels", None) or ()
        if not kernels:
            continue
        node, op = source(ev)
        for k in kernels:
            ms = k.duration / 1e3 / args.steps
            busy_ms += ms
            by_node[node] += ms
            by_pair[f"{node} | {op}"] += ms
            if node == "_LayerNormBackward":
                ln_kernels[k.name[:100]] += ms
                ln_launches[k.name[:100]] += 1 / args.steps
    line = dict(
        tree=str(Path(args.tree).resolve()), model=args.model, batch=batch, steps=args.steps,
        device=torch.cuda.get_device_name(0), wall_ms=wall_ms, device_busy_ms=busy_ms,
        nodes=[[k, v] for k, v in by_node.most_common()],
        pairs=[[k, v] for k, v in by_pair.most_common(40)],
        ln_backward_ms=by_node.get("_LayerNormBackward", 0.0),
        ln_backward_kernels=[[k, v, ln_launches[k]] for k, v in ln_kernels.most_common()])
    print(json.dumps(line), flush=True)
    out = Path(args.out or ROOT / "chiprun_out" / f"profile_torch_train_step_{args.model}.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
