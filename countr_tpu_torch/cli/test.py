"""FSC147 counting evaluation (few-shot and zero-shot) on the port
(counterpart of ``countr_tpu/cli/test.py``).

Covers the reference's two test entry points in one CLI:
- few-shot: all annotated exemplars (reference:
  FSC_test_cross(few-shot).py);
- zero-shot: --box_bound 0 (reference: run_minimal.MD:92-95);
plus --external / --box_bound exemplar modes. Images are counted by
``CountingEngine.count_batch``, whose window forward replays from CUDA
graphs on the card.

Usage:
  python -m countr_tpu_torch.cli.test --data_path ./data/FSC147 \\
      --model mae_vit_base6_patch16 --resume weights.pth --split test
  (add --device cpu to run on the CPU)
"""

from __future__ import annotations

import argparse
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from countr_tpu_torch.cli import common
from countr_tpu_torch.utils import viz
from countr_tpu_torch.utils.metrics import CountingMetrics, JsonlLogger


def get_args(argv=None):
    p = argparse.ArgumentParser("FSC147 counting evaluation")
    common.add_data_args(p)
    common.add_model_args(p, default_model="mae_vit_base6_patch16")
    p.add_argument("--split", default="test", type=str)
    p.add_argument("--external", action="store_true",
                   help="use exemplars pooled from other images")
    p.add_argument("--box_bound", default=-1, type=int,
                   help="max exemplars (0 = zero-shot)")
    p.add_argument("--max_s_cnt", default=1, type=int,
                   help="tiny-exemplar count that triggers 3x3 grid mode")
    p.add_argument("--no_normalization", action="store_true",
                   help="disable test-time normalization")
    p.add_argument("--batch_images", default=16, type=int,
                   help="images pooled per count_batch call")
    p.add_argument("--batch_windows", default=16, type=int)
    p.add_argument("--n_devices", default=0, type=int,
                   help="split each window batch over the first N devices (0 or 1: "
                        "one; --batch_windows must be a multiple of N)")
    p.add_argument("--narrow_policy", default="pad", choices=["pad", "reference"])
    p.add_argument("--save_viz", action="store_true",
                   help="write per-image overlay panels")
    p.add_argument("--limit", default=0, type=int,
                   help="evaluate only the first N images (0 = all)")
    p.add_argument("--profile_dir", default="", type=str,
                   help="write a torch.profiler trace of the inference phase here")
    p.add_argument("--expect_mae", default=None, type=float,
                   help="acceptance gate: exit nonzero unless the split MAE is "
                        "within --expect_tol_pct of this value (reference "
                        "released-weights bar: MAE 11.95, README.md:117-119)")
    p.add_argument("--expect_rmse", default=None, type=float,
                   help="acceptance gate on RMSE (reference: 91.23)")
    p.add_argument("--expect_tol_pct", default=2.0, type=float,
                   help="tolerance as a percentage of the expected value")
    return p.parse_args(argv)


def check_expectations(stats: dict, args) -> list:
    """Acceptance-gate comparison; returns failure strings (empty =
    pass). Fails when a metric exceeds expected * (1 + tol%) — beating
    the expected number is never a failure."""
    failures = []
    tol = getattr(args, "expect_tol_pct", 2.0) / 100.0
    for key, flag in (("MAE", "expect_mae"), ("RMSE", "expect_rmse")):
        want = getattr(args, flag, None)
        if want is None:
            continue
        got = stats[key]
        if not np.isfinite(got) or got > want * (1.0 + tol):
            failures.append(
                f"{key} {got:.3f} exceeds expected {want:.3f} "
                f"(+{getattr(args, 'expect_tol_pct', 2.0):.1f}% tolerance)"
            )
    return failures


def gate(stats: dict, args, code: int) -> None:
    """Print the gate's outcome; exit with ``code`` when it fails."""
    failures = check_expectations(stats, args)
    for f in failures:
        print(f"ACCEPTANCE FAILURE: {f}", flush=True)
    if failures:
        raise SystemExit(code)
    if getattr(args, "expect_mae", None) is not None or \
            getattr(args, "expect_rmse", None) is not None:
        print("acceptance gate: PASS", flush=True)


def main(args, engine=None):
    """Evaluate the split; returns the logged stats. ``engine``: the
    CountingEngine to count with (default: ``common.build_engine``)."""
    from countr_tpu_torch.data.fsc147 import TestDataset
    from countr_tpu_torch.utils.profiling import trace

    meta = common.load_meta(args)
    if engine is None:
        engine = common.build_engine(args, normalization=not args.no_normalization)
    outdir = common.ensure_outdir(args)
    ds = TestDataset(meta, split=args.split, external=args.external, box_bound=args.box_bound)

    n = len(ds) if args.limit <= 0 else min(args.limit, len(ds))
    metrics = CountingMetrics()
    names, preds, gts, empties = [], [], [], []
    tot_load, tot_infer = 0.0, 0.0

    # Samples stream in from host threads (decode, resize, crop: PIL, cv2
    # and numpy only) while this thread counts, bucketed by shot count;
    # a bucket flushes through count_batch when it holds batch_images.
    samples, results, buckets = [], [], {}

    def flush(shot):
        nonlocal tot_infer
        idxs = buckets.pop(shot, [])
        if not idxs:
            return
        t0 = time.perf_counter()
        res = engine.count_batch(
            [samples[k]["image"] for k in idxs],
            [samples[k]["boxes"] if shot > 0 else None for k in idxs],
            [samples[k]["rects"] for k in idxs],
            shot_num=shot,
            return_density=args.save_viz,
        )
        tot_infer += time.perf_counter() - t0
        for k, r in zip(idxs, res):
            results[k] = r
            s = samples[k]
            gt_cnt = float(len(s["dots"]))
            print(
                f"{k}/{n}: pred_cnt: {r.count:5.3f},  gt_cnt: {gt_cnt:5.3f},  "
                f"error: {abs(r.count - gt_cnt):5.3f}, id: {s['name']}, "
                f"s_cnt: {r.grid_mode}",
                flush=True,
            )

    with trace(args.profile_dir or None):
        with ThreadPoolExecutor(max_workers=4) as pool:
            futures = [pool.submit(ds.__getitem__, i) for i in range(n)]
            for fut in futures:
                s = fut.result()
                tot_load += s["load_time"]
                samples.append(s)
                results.append(None)
                shot = int(s["boxes"].shape[0])
                buckets.setdefault(shot, []).append(len(samples) - 1)
                if len(buckets[shot]) >= args.batch_images:
                    flush(shot)
            for shot in list(buckets):
                flush(shot)

    for s, r in zip(samples, results):
        gt_cnt = float(len(s["dots"]))
        metrics.update(r.count, gt_cnt)
        names.append(s["name"])
        preds.append(r.count)
        gts.append(gt_cnt)
        if gt_cnt == 0:
            empties.append(s["name"])
        if args.save_viz and outdir:
            stem = s["name"].rsplit(".", 1)[0]
            viz.save_prediction_panel(
                f"{outdir}/full_{stem}__{round(r.count)}.png",
                s["image"].astype(np.float32) / 255.0, r.density, s["gt_map"], s["rects"],
                r.count, gt_cnt, external=args.external,
            )
            if s["boxes"].shape[0] > 0:
                viz.save_exemplar_strip(f"{outdir}/boxes_{stem}.png", s["boxes"])

    log_stats = {
        **metrics.summary(),
        "Mean load time": tot_load / max(len(samples), 1),
        "Mean infer time": tot_infer / max(len(samples), 1),
        "Mean overall time": (tot_load + tot_infer) / max(len(samples), 1),
    }
    print("\nAverage stats:")
    print(", ".join(f"{k}: {v:5.3f}" for k, v in log_stats.items()))
    print("empty images:", len(empties), empties if empties else "")

    if outdir:
        JsonlLogger(outdir).write(log_stats)
        viz.save_results(outdir, names, preds, gts)
    gate(log_stats, args, code=1)
    return log_stats


def _entry():
    main(get_args())


if __name__ == "__main__":
    _entry()
