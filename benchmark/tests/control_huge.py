"""The controls of the pretrain-huge-resident cell (``mae_huge14``):
``control.py``'s pretraining control, run with this configuration's
reference (``drivers/pretrain_huge.py``: the crop resized to 378 px,
micro-batches), at the cell's own size. The float8 reference, or with
``--fault=half_batch`` the float32 one that leaves out half of each
batch, plays the program; it has to come out as not correct.

    python3 benchmark/tests/control_huge.py [--fault=half_batch] <seed> [<seed> ...]

prints one JSON line a seed, as ``control.py`` does. Needs a CUDA card."""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark.lib import common  # noqa: E402

CELL = "pretrain-huge-resident"


def main(argv) -> int:
    import torch

    from benchmark.drivers import pretrain_huge
    from benchmark.tests import control

    spec = common.load_json(common.ROOT / "BENCHMARK.json")
    wl = {w["name"]: w for w in spec["workloads"]}[CELL]
    cfg = common.load_json(common.ROOT / {c["name"]: c for c in spec["configs"]}
                           [wl["config"]]["file"])
    t = common.load_json(common.BENCH / "traffic" / f"{wl['traffic']}.json")
    common.set_cache_env()
    dev = torch.device("cuda")
    fault = None
    if argv and argv[0].startswith("--fault="):
        fault = argv.pop(0).split("=", 1)[1]
    for seed in argv:
        t0 = time.perf_counter()
        with pretrain_huge.sized(t):
            worst = control.pretrain_control(wl, cfg, t, int(seed), dev, fault)
        fails = [k for k, lim in t["limits"].items() if k in worst and not worst[k] <= lim]
        print(json.dumps({"cell": CELL, "seed": int(seed), "fault": fault, "control": worst,
                          "limits": t["limits"], "fails": fails,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
