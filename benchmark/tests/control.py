"""The controls of the benchmark's checks: the plain reference put in the
program's place and computed in float8 (e4m3) operands, the step below
the bfloat16 that the configurations state, judged by the same numbers
and limits as a run. A control has to come out as not correct.

    python3 benchmark/tests/control.py <cell> [--fault=<name>] <seed> [<seed> ...]

prints one JSON line a seed with the control's numbers beside the cell's
limits (with ``--fault=half_batch``, for the pretraining cell, that fault's
readings); ``test_control.py`` runs it on the card. It runs the reference
twice (float32 and float8) on what a run of the cell checks: the count
cells' sampled images at their own sizes, the pretraining cell's first
steps at its batch."""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark.lib import common  # noqa: E402


def count_control(wl: dict, cfg: dict, t: dict, seed: int, dev) -> dict:
    """Each number of a count-fewshot run (``answer_gaps``) over the
    images such a run would sample (its pool's grid images and others,
    drawn from the seed)."""
    from benchmark.lib import models
    from benchmark.lib.traffic import count_traffic
    from benchmark.reference import countr as ref
    from benchmark.reference.precision import mode

    tr = count_traffic(t, seed)
    state = models.countr_weights(cfg, common.torch_seed(seed, 0), dev)
    model = ref.build(cfg, state, dev)
    rng = common.seed_stream(seed, 3)
    grid = [k for k, r in enumerate(tr["rects"]) if r and r[0][2] - r[0][0] < 10]
    plain = [k for k in range(len(tr["images"])) if k not in grid]
    n_grid = min(len(grid), max(1, t["check_images"] // 8))
    pick = list(rng.choice(grid, n_grid, replace=False)) if grid else []
    pick += list(rng.choice(plain, min(len(plain), t["check_images"] - n_grid), replace=False))
    pairs = []
    for k in pick:
        out = {}
        for prec in ("fp32", "fp8"):
            with mode(prec):
                out[prec] = ref.count_image(model, tr["images"][k], tr["rects"][k], t["shot"],
                                            normalization=t["normalization"])
        pairs.append((out["fp8"], out["fp32"]))
    return ref.answer_gaps(pairs)


def pretrain_control(wl: dict, cfg: dict, t: dict, seed: int, dev, fault=None) -> dict:
    """The reference's first steps in float8 against float32, on crops
    drawn from the seed (RandomResizedCrop's ranges) over the cell's
    synthetic tree, with the same noise: the pretraining cell's numbers.
    With ``fault`` the float32 reference with that fault planted
    (``drivers/pretrain.py reference_steps``) plays the program."""
    import torch
    from PIL import Image

    from benchmark.drivers import pretrain as drv
    from benchmark.lib import models
    from benchmark.reference import mae as ref

    tree = drv.synthetic_tree(t, lambda m: print(m, file=sys.stderr))
    with open(Path(tree) / "Train_Test_Val_FSC_147.json") as f:
        ids = json.load(f)["train"]
    batch = int(drv.cli_value(t, "--batch_size"))
    rng = common.seed_stream(seed, 7)
    geometry = []
    for _ in range(t["check_steps"]):
        g = {k: [] for k in ("img_idx", "crop_top", "crop_left", "crop_h", "crop_w",
                             "transposed", "flip")}
        for _ in range(batch):
            i = int(rng.integers(0, len(ids)))
            w = Image.open(Path(tree) / "images_384_VarV2" / ids[i]).size[0]
            ch = int(rng.integers(172, 385))
            cw = int(min(w, max(8, round(ch * rng.uniform(0.75, 1.33)))))
            g["img_idx"].append(i)
            g["crop_top"].append(int(rng.integers(0, 384 - ch + 1)))
            g["crop_left"].append(int(rng.integers(0, w - cw + 1)))
            g["crop_h"].append(ch)
            g["crop_w"].append(cw)
            g["transposed"].append(0)
            g["flip"].append(int(rng.random() < 0.5))
        geometry.append({k: np.asarray(v) for k, v in g.items()})
    state = models.mae_weights(cfg, common.torch_seed(seed, 0), dev)
    noise_seed = common.torch_seed(seed, 1)
    opt = drv.optimizer_settings(t)
    # the float8 reference's steps play the program's part
    low = drv.reference_steps(cfg, opt, tree, state, geometry, noise_seed, dev,
                              "fp32" if fault else "fp8", fault)
    moment1 = {n: g * (1 - opt["beta1"]) for n, g in low["grad1"].items()}

    class _Quiet:
        def note(self, msg):
            print(msg, file=sys.stderr)

    checks = drv.check_steps(cfg, t["limits"], opt, tree, state, geometry, noise_seed,
                             low["losses"], moment1, low["params"], dev, _Quiet())
    torch.cuda.empty_cache()
    return {c.name: c.value for c in checks}


CONTROLS = {"count": count_control, "pretrain": pretrain_control}


def main(argv) -> int:
    import torch

    spec = common.load_json(common.ROOT / "BENCHMARK.json")
    wl = {w["name"]: w for w in spec["workloads"]}[argv[0]]
    cfg = common.load_json(common.ROOT / {c["name"]: c for c in spec["configs"]}
                           [wl["config"]]["file"])
    t = common.load_json(common.BENCH / "traffic" / f"{wl['traffic']}.json")
    common.set_cache_env()
    dev = torch.device("cuda")
    fault = None
    if argv[1].startswith("--fault="):
        fault = argv.pop(1).split("=", 1)[1]
    for seed in argv[1:]:
        t0 = time.perf_counter()
        kw = {"fault": fault} if fault else {}
        worst = CONTROLS[t["driver"]](wl, cfg, t, int(seed), dev, **kw)
        fails = [k for k, lim in t["limits"].items() if k in worst and not worst[k] <= lim]
        print(json.dumps({"cell": wl["name"], "seed": int(seed), "fault": fault, "control": worst,
                          "limits": t["limits"], "fails": fails,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
