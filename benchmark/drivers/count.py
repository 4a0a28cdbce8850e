"""Offline counting, as ``cli.test`` does it: a closed loop of
``CountingEngine.count_batch`` calls of ``batch_images`` images each, the
counts back on the host at the end of each call. The exemplar crops are
the program's (``data/transforms.py crop_exemplars_u8``), cut at set-up
once a pool image, as ``cli.test``'s loader threads cut them beside the
counting.

Measured: ``images_per_s``, the images of the calls that ended inside the
window over the window's seconds (the window ends with the last call that
started in it). Checked: a sample of the window's images, drawn from the
seed with the grid-mode ones in it, against the plain reference
(``reference/countr.py``) in float32 with TF32 off: the normalisation's
statistic and the count before it, each answer's gap from the sample's
median gap (``answer_gaps``); the widest count gaps are shown beside them.
Traced (``--trace 1``): a stretch of whole calls from a third of the
window, with the forwards' buckets from the engine's own plan and the
kernels' launches from the graph runner's counters."""

from __future__ import annotations

import time

import numpy as np

from benchmark.lib.common import (
    Check, Outcome, free, peak_bytes, reset_peak, seed_stream, sync, torch_seed,
)
from benchmark.lib.trace import Profile, span, warm
from benchmark.lib.traffic import count_traffic
from benchmark.work.models import countr as countr_work

TRACE_SECONDS = 4.0


def kernel_launches(cfg: dict, buckets) -> dict:
    """The B1 and B2 launches of window forwards at the given batch
    buckets, by launch shape: per forward, B2 on every encoder and decoder
    block's attention branch, B1 on the other LayerNorms."""
    n = (cfg["img_size"] // cfg["patch_size"]) ** 2
    d, dd = cfg["embed_dim"], cfg["decoder_embed_dim"]
    out = {"B1": {}, "B2": {}}
    for bk in buckets:
        for key, shape, k in (
                ("B2", (bk, n, d), cfg["depth"]),
                ("B2", (bk, n, dd), cfg["decoder_depth"]),
                ("B1", (bk * n, d), cfg["depth"] + 1),
                ("B1", (bk * n, dd), 2 * cfg["decoder_depth"] + 1)):
            out[key][shape] = out[key].get(shape, 0) + k
    return out


def plan_of_call(engine, images, rects, batch_windows):
    """(windows, forward buckets) of one count_batch call, from the
    engine's own set packing and chunk plan."""
    from countr_tpu_torch.engine.device_pipeline import chunk_plan

    windows, buckets = 0, []
    for idxs in engine.plan_batch_sets(images, rects):
        n = sum(engine.windows_per_image(images[i].shape[1], rects[i])[1] for i in idxs)
        windows += n
        buckets += [bk for _, bk in chunk_plan(n, batch_windows)]
    return windows, buckets


def run(ctx) -> Outcome:
    import torch

    from benchmark.lib import models
    from benchmark.reference import countr as ref
    from benchmark.reference.precision import mode
    from countr_tpu_torch.data.transforms import crop_exemplars_u8
    from countr_tpu_torch.engine.inference import CountingEngine

    cfg, t = ctx.config, ctx.traffic
    dev = torch.device(ctx.device)
    shot, bw = t["shot"], t["batch_windows"]
    state = models.countr_weights(cfg, torch_seed(ctx.seed, 0), dev)
    model = models.program_countr(cfg, cfg["builds"]["count"], state, dev)
    engine = CountingEngine(model, batch_windows=bw, normalization=t["normalization"], device=dev)
    tr = count_traffic(t, ctx.seed)
    images, rects, calls = tr["images"], tr["rects"], tr["calls"]
    plans = [plan_of_call(engine, [images[k] for k in c], [rects[k] for k in c], bw)
             for c in calls]

    # the exemplar crops, cut once a pool image as cli.test's loader
    # threads cut them beside the counting: the window times count_batch
    crops = [crop_exemplars_u8(im, r) if shot else None for im, r in zip(images, rects)]

    def one_call(c):
        with span("count_batch"):
            return engine.count_batch([images[k] for k in c], [crops[k] for k in c],
                                      [rects[k] for k in c], shot_num=shot,
                                      return_density=False)

    engine.capture_forwards(shot_nums=(shot,))
    if ctx.trace:
        warm()
    for c in calls[:t["warm_calls"]]:
        one_call(c)
    reset_peak(dev)
    runner = getattr(engine._pipeline.forwards[0], "runner", None)
    setup_s = time.perf_counter() - ctx.t_start
    ctx.note(f"set-up {setup_s:.1f}s; window {ctx.seconds}s")

    done, ends = [], []  # (call index, results); untraced calls' ends
    traced, prof_calls, summary = False, [], None
    t0 = time.perf_counter()
    end = t0
    i = 0
    while end - t0 < ctx.seconds:
        if ctx.trace and not traced and end - t0 >= ctx.seconds / 3:
            traced = True
            before = dict(runner.launched) if runner else {}
            stretch_from, stretch = end, [len(done)]
            with Profile() as prof:
                ts = time.perf_counter()
                while True:
                    c = i % len(calls)
                    done.append((c, one_call(calls[c])))
                    prof_calls.append(c)
                    i += 1
                    if time.perf_counter() - ts >= min(TRACE_SECONDS, ctx.seconds / 3):
                        break
            summary = prof  # read after the window
            counted = ({k: runner.launched[k] - before[k] for k in ("B1", "B2")} if runner
                       else None)
            end = time.perf_counter()
            stretch_s = end - stretch_from
            stretch.append(len(done))
            continue
        c = i % len(calls)
        done.append((c, one_call(calls[c])))
        i += 1
        end = time.perf_counter()
        ends.append(end - t0)
    window = end - t0
    n_images = sum(len(r) for _, r in done)
    sync(dev)
    peak = peak_bytes(dev)
    ctx.note(f"{len(done)} calls, {n_images} images in {window:.2f}s")

    layer, extra_trace = {}, {}
    if ctx.trace and summary is not None:
        wins = sum(plans[c][0] for c in prof_calls)
        buckets = [bk for c in prof_calls for bk in plans[c][1]]
        launches = kernel_launches(cfg, buckets)
        expect = {k: sum(v.values()) for k, v in launches.items()}
        # the model's operations over the window's calls outside the traced
        # stretch, over their seconds: the profiler's host overhead stays out
        outside = [c for k, (c, _) in enumerate(done) if not stretch[0] <= k < stretch[1]]
        flops = sum(plans[c][0] * countr_work.window(cfg, shot)
                    + len(calls[c]) * countr_work.exemplars(cfg, shot) for c in outside)
        rates = {"traced_images_per_s": sum(len(calls[c]) for c in prof_calls)
                 / summary.summary["window_s"],
                 "untraced_images_per_s": sum(len(calls[c]) for c in outside)
                 / (window - stretch_s)}
        layer = {"trace": summary.summary, "windows": wins, "slots": sum(buckets),
                 "untraced_flops": flops, "untraced_s": window - stretch_s,
                 "launches": launches, "launches_counted": counted, "launches_expected": expect}
        # the stretch with the profiler's start and stop, its traced window without
        extra_trace = dict(rates, stretch_s=stretch_s, traced_s=summary.summary["window_s"])
        ctx.note(f"traced {len(prof_calls)} calls: launches {counted} (expected {expect})")

    # the check, after the window: a sample of the window's images
    rng = seed_stream(ctx.seed, 3)
    occ = [(j, p) for j, (c, res) in enumerate(done) for p in range(len(res))]
    grid = [o for o in occ if done[o[0]][1][o[1]].grid_mode]
    plain = [o for o in occ if not done[o[0]][1][o[1]].grid_mode]
    n_grid = min(len(grid), max(1, t["check_images"] // 8))
    pick = [grid[k] for k in rng.choice(len(grid), n_grid, replace=False)] if grid else []
    pick += [plain[k] for k in rng.choice(len(plain), min(len(plain), t["check_images"] - n_grid),
                                          replace=False)]
    del engine, model, runner
    free(dev)
    t_ref = time.perf_counter()
    refm = ref.build(cfg, state, dev)
    cache, pairs = {}, []
    with mode("fp32"):
        for j, p in pick:
            c, res = done[j]
            k = calls[c][p]
            if k not in cache:
                cache[k] = ref.count_image(refm, images[k], rects[k], shot,
                                           normalization=t["normalization"])
            got = res[p]
            pairs.append(({"raw": got.raw_count, "e_cnt": got.e_cnt, "count": got.count},
                          cache[k]))
    ctx.note(f"reference: {len(pick)} images ({len(cache)} distinct, {n_grid} grid) in "
             f"{time.perf_counter() - t_ref:.1f}s; e_cnt "
             f"{min(v['e_cnt'] for v in cache.values()):.3g}.."
             f"{max(v['e_cnt'] for v in cache.values()):.3g}")
    # the numbers with a limit are compared (one not read fails); the others are shown
    numbers, limits = ref.answer_gaps(pairs), t["limits"]
    checks = [Check(name, numbers.get(name, float("nan")), limit)
              for name, limit in limits.items()]
    shown = {name: v for name, v in numbers.items() if name not in limits}
    ctx.note(f"not compared: {shown}")
    return Outcome(attempted=n_images, failed=0,
                   e2e={"images_per_s": n_images / window, "setup_s": setup_s},
                   memory_peak_bytes=peak, checks=checks, layer=layer,
                   extra={"calls": len(done), "window_s": window, **extra_trace,
                          "fifths_calls": np.histogram(ends, 5, (0, window))[0].tolist(),
                          "not_compared": shown})
