"""Throughput benchmark of the port on one CUDA card: FSC147-style
sliding-window counting (the workload of the JAX package's ``bench.py``)
through ``CountingEngine.count_batch`` on ``mae_vit_base6_patch16`` in the
bf16 fast mode (B1, B2, tanh GELU, subpixel head), random weights from
seed 0.

    python -m countr_tpu_torch.bench [--mode few_shot|zero_shot]

The workload: 64 synthetic images at H=384 and FSC147-like widths
(multiples of 16), uint8 pixels, 3 exemplar crops each; every 10th image
carries tiny (<10x10) exemplar rects and so runs 3x3 grid mode (9x the
windows, reference: FSC_test_cross(few-shot).py:264-284); batches of 16
windows. Pixel content is synthetic: throughput does not depend on it.
``zero_shot`` prices the zero-shot route: shot_num 0 (the learned shot
token), no rects, so no TTN and no grid mode.

Prints ONE JSON line on stdout (progress goes to stderr):
- ``value``: images/s of the best of 8 ``count_batch`` passes over the
  64 images (host clock; a pass ends when the counts are on the host);
  ``detail`` has min / median / max over the passes and each pass's
  seconds;
- ``device_windows_per_sec``: the window forward replayed from its CUDA
  graph (inputs copied in, as ``count_batch`` does), 16 windows a call,
  timed between CUDA events; ``device_windows_per_sec_eager`` the same
  forward run eagerly;
- ``device_pipeline_windows_per_sec``: ``fused_set_program`` on the first
  set ``count_batch`` dispatches (exemplar CNN, window extraction, the
  graphed forwards, stitch, finalize, TTN from device-resident inputs),
  between CUDA events; ``detail.forward_slot_occupancy`` is that set's
  windows over its forward slots;
- ``h2d_bytes_per_image``: the pixel, exemplar and plan bytes
  ``count_batch`` uploads per image;
- ``device``: the card's name and ``nvidia-smi``'s name and power limit.

Needs a CUDA device (exits nonzero without one). Writes no file.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

BASELINE_IMAGES_PER_SEC = 2.0  # bench.py: the reference's estimated rate
N_IMAGES = 64
BATCH_WINDOWS = 16
GRID_EVERY = 10  # every 10th image gets tiny exemplars -> 3x3 grid mode
N_PASSES = 8
WIDTHS = [384, 448, 512, 512, 576, 640, 512, 688, 512, 464, 576, 512]
PLAIN_RECTS = [(40, 40, 110, 120), (150, 60, 230, 140), (250, 200, 330, 300)]
TINY_RECTS = [(12, 12, 17, 17), (60, 60, 65, 65), (100, 100, 105, 105)]


def note(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def workload(rng, zero_shot: bool):
    """(images, boxes, rects) of the benchmark, from ``rng``."""
    images = [rng.integers(0, 256, (384, WIDTHS[i % len(WIDTHS)], 3), dtype=np.uint8)
              for i in range(N_IMAGES)]
    boxes = [rng.uniform(0, 1, (3, 64, 64, 3)).astype(np.float32) for _ in images]
    if zero_shot:
        rects = [[] for _ in images]
    else:
        rects = [list(TINY_RECTS) if i % GRID_EVERY == GRID_EVERY - 1 else list(PLAIN_RECTS)
                 for i in range(N_IMAGES)]
    return images, boxes, rects


def events_ms(fn, iters: int) -> float:
    """Least mean ms per call of ``fn()`` over 3 runs of ``iters`` calls,
    each run between two CUDA events (after one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def run(mode: str = "few_shot", engine=None) -> dict:
    """The benchmark's result line as a dict. ``engine``: a
    CountingEngine on the card to measure (default: the benchmark's own
    model, built here)."""
    from countr_tpu_torch.config import fast_mode_overrides
    from countr_tpu_torch.engine.device_pipeline import chunk_plan, fused_set_program
    from countr_tpu_torch.engine.inference import CountingEngine
    from countr_tpu_torch.models import build_countr

    if not torch.cuda.is_available():
        raise RuntimeError("countr_tpu_torch.bench measures a CUDA device and none is available")
    zero_shot = mode == "zero_shot"
    shot_num = 0 if zero_shot else 3
    rng = np.random.default_rng(0)
    if engine is None:
        model = build_countr("mae_vit_base6_patch16", seed=0, **fast_mode_overrides("bf16"))
        engine = CountingEngine(model, batch_windows=BATCH_WINDOWS)
    model, dev = engine.model, engine.device
    graphed = engine._pipeline.forward

    ny = 1 if zero_shot else 3
    imgs = torch.from_numpy(rng.uniform(0, 1, (BATCH_WINDOWS, 384, 384, 3)).astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.uniform(-1, 1, (BATCH_WINDOWS, ny, model.cfg.decoder_embed_dim))
                         .astype(np.float32)).to(dev, torch.bfloat16)
    with torch.inference_mode():
        graph_ms = events_ms(lambda: graphed(imgs, y), iters=10)
        eager_ms = events_ms(lambda: model.forward_tokens(imgs, y), iters=10)
    dev_wps = BATCH_WINDOWS / graph_ms * 1e3
    note(f"forward: graphed {dev_wps:.0f} windows/s, eager "
         f"{BATCH_WINDOWS / eager_ms * 1e3:.0f} windows/s")

    images, boxes, rects = workload(rng, zero_shot)
    n_grid = sum(1 for r in rects if r and r[0] == TINY_RECTS[0])

    # the first set count_batch dispatches for this batch, through the
    # pipeline as one program on device-resident inputs
    idxs = engine.plan_batch_sets(images, rects)[0]
    sp = engine._plan_set(idxs, images, boxes, rects, shot_num)
    pipe_nwin = sp["plan"]["img_owner"].shape[0]
    pipe_slots = sum(bk for _, bk in chunk_plan(pipe_nwin, BATCH_WINDOWS))
    args, preds_fn = fused_set_program(engine, sp, shot_num)
    with torch.inference_mode():
        pipe_ms = events_ms(lambda: preds_fn(*args), iters=8)
    pipe_wps = pipe_nwin / pipe_ms * 1e3
    pipe_ips = len(idxs) / pipe_ms * 1e3
    note(f"device pipeline: {pipe_wps:.0f} windows/s, {pipe_ips:.1f} images/s "
         f"({pipe_nwin} windows / {len(idxs)} images a set, {pipe_nwin}/{pipe_slots} "
         f"forward slots)")

    t0 = time.perf_counter()
    engine.count_batch(images, boxes, rects, shot_num=shot_num, return_density=False)
    warmup_s = time.perf_counter() - t0
    engine.h2d_bytes = 0
    times = []
    for _ in range(N_PASSES):
        t0 = time.perf_counter()
        results = engine.count_batch(images, boxes, rects, shot_num=shot_num,
                                     return_density=False)
        times.append(time.perf_counter() - t0)
    if not all(np.isfinite(r.count) for r in results):
        raise AssertionError("count_batch gave a count that is not finite")
    n_windows = sum(r.n_windows for r in results)
    ips_all = sorted(len(images) / t for t in times)
    ips = ips_all[-1]
    h2d_per_img = engine.h2d_bytes / (N_PASSES * len(images))
    note(f"end to end: {ips:.1f} images/s (min {ips_all[0]:.1f}), "
         f"h2d {h2d_per_img / 1e3:.0f} KB/image")
    return {
        "metric": ("FSC147-geometry zero-shot sliding-window throughput" if zero_shot
                   else "FSC147-geometry few-shot sliding-window throughput"),
        "value": ips,
        "unit": "images/sec/chip",
        "vs_baseline": ips / BASELINE_IMAGES_PER_SEC,
        "device_windows_per_sec": dev_wps,
        "device_windows_per_sec_eager": BATCH_WINDOWS / eager_ms * 1e3,
        "device_pipeline_windows_per_sec": pipe_wps,
        "h2d_bytes_per_image": h2d_per_img,
        "device": {"kind": torch.cuda.get_device_name(0), "nvidia_smi": smi_line()},
        "detail": {
            "mode": mode,
            "n_images": len(images),
            "n_grid_images": n_grid,
            "n_windows": n_windows,
            "windows_per_sec": n_windows / min(times),
            "batch_windows": BATCH_WINDOWS,
            "images_bucket": engine.images_bucket,
            "forward_slot_occupancy": pipe_nwin / pipe_slots,
            "dtype": "bfloat16",
            "model": "mae_vit_base6_patch16",
            "warmup_s": warmup_s,
            "pass_times_s": times,
            "images_per_sec_min": ips_all[0],
            "images_per_sec_median": ips_all[len(ips_all) // 2],
            "images_per_sec_max": ips,
            "device_pipeline_images_per_sec": pipe_ips,
            "forward_ms": {"graphed": graph_ms, "eager": eager_ms},
            "graphs_captured": len(graphed.runner),
        },
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", default="few_shot", choices=("few_shot", "zero_shot"))
    args = ap.parse_args(argv)
    print(json.dumps(run(args.mode)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
