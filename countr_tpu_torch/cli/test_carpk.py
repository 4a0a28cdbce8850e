"""CARPK evaluation on the port (counterpart of
``countr_tpu/cli/test_carpk.py``; reference: FSC_test_CARPK.py): two
exemplars, 384x683 resize, 384-wide sliding window without test-time
normalisation, then the 16x16 sum-pool post-processing with the >1.224
per-cell decrement and the e_cnt<=0.5 -> +2 correction
(``data/carpk.py carpk_postprocess``).

Usage:
  python -m countr_tpu_torch.cli.test_carpk --carpk_root /data/CARPK \\
      --resume carpk_finetuned.pth
"""

from __future__ import annotations

import argparse
import time

from countr_tpu_torch.cli import common
from countr_tpu_torch.utils.metrics import JsonlLogger


def get_args(argv=None):
    p = argparse.ArgumentParser("CARPK evaluation")
    common.add_model_args(p, default_model="mae_vit_base6_patch16")
    p.add_argument("--carpk_root", default="", type=str,
                   help="local CARPK directory (Images/ + Annotations/ [+ ImageSets/])")
    p.add_argument("--output_dir", default="./out_carpk_test", type=str)
    p.add_argument("--batch_images", default=8, type=int)
    p.add_argument("--batch_windows", default=32, type=int)
    p.add_argument("--limit", default=0, type=int)
    p.add_argument("--expect_mae", default=None, type=float,
                   help="acceptance gate: exit nonzero unless MAE is within "
                        "--expect_tol_pct of this value (reference released-weights "
                        "bar: MAE 5.75, README.md:117-120)")
    p.add_argument("--expect_rmse", default=None, type=float,
                   help="acceptance gate on RMSE (reference: 7.45)")
    p.add_argument("--expect_tol_pct", default=2.0, type=float)
    return p.parse_args(argv)


def main(args, engine=None):
    """Evaluate CARPK's test split; returns the logged stats. ``engine``:
    the CountingEngine to count with (default: built from args, without
    test-time normalisation)."""
    from countr_tpu_torch.cli.test import gate
    from countr_tpu_torch.data.carpk import carpk_postprocess, carpk_test_sample, load_carpk

    src = load_carpk("test", args.carpk_root)
    if engine is None:
        # CARPK has its own post-processing in place of TTN
        engine = common.build_engine(args, normalization=False)
    outdir = common.ensure_outdir(args)
    n = len(src) if args.limit <= 0 else min(args.limit, len(src))

    mae, mse = 0.0, 0.0
    t0 = time.perf_counter()
    for base in range(0, n, args.batch_images):
        samples = [carpk_test_sample(src[i])
                   for i in range(base, min(base + args.batch_images, n))]
        results = engine.count_batch(
            [s["image"] for s in samples],
            [s["boxes"] for s in samples],
            [[] for _ in samples],
            shot_num=2,
            return_density=True,
        )
        for s, r in zip(samples, results):
            pred = carpk_postprocess(r.density, s["pos"])
            err = abs(pred - s["count"])
            mae += err
            mse += err ** 2
            print(f"{s['name']}: pred {pred:.2f} gt {s['count']} err {err:.2f}", flush=True)

    stats = {
        "MAE": mae / max(n, 1),
        "RMSE": (mse / max(n, 1)) ** 0.5,
        "Mean time": (time.perf_counter() - t0) / max(n, 1),
    }
    print(f"CARPK: MAE {stats['MAE']:.2f} RMSE {stats['RMSE']:.2f}")
    if outdir:
        JsonlLogger(outdir).write(stats)
    gate(stats, args, code=3)
    return stats


def _entry():
    main(get_args())


if __name__ == "__main__":
    _entry()
