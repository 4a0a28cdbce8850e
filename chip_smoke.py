"""Drive the PyTorch/CUDA port (countr_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, one line each on stdout:
  1. environment: the card and its power limit, and which image decoders
     import (torchvision, torchvision.io with a JPEG decoded on the CPU
     and on the card, PIL, cv2); it raises when PIL or cv2 does not
     import (the CLIs decode and resize with them);
  2. build: the CUDA libraries from countr_tpu_torch/csrc (nvcc, sm_90a;
     attn_block.cu for B2, attn.cu for B3/B4, mlp_block.cu for B5 and
     cross_block.cu for B6, one nvcc each, started together) and the
     Triton kernel's first compile;
  3. gemm: the GEMM that B2 and B5 share (csrc/gemm.cuh, through
     ops/gemm.py) at every product of the paths at 16 windows, against
     its plain version (max|d|), its graph-replayed ms and TFLOP/s
     beside torch.matmul's for the same epilogue-free product;
     kernels: each hand-written kernel (B1-B6) and B2's backward against
     its plain PyTorch version on the card, at the main paths' shapes
     (B5 and B6, which no model path runs, at the A/B scripts' shapes;
     their checked calls, one per shape, are the "ab" path, counted with
     the counters set to 0 just before each and read just after),
     bf16 — max|d| (B2's backward: each gradient's cosine and max|d| over
     max|ref|), and device times (calls replayed from a CUDA graph,
     between CUDA events) of the kernel, its plain version and one
     PyTorch library call or composition as a yardstick, beside the
     card's bound for the same work; B3/B4 also at the MAE encoder's
     N = 288 and the MAE decoder's [16, 576, 512], B3 also at B2's
     encoder shape [16, 576, 768], B6 also at C 768, 1024, 1280 and 2048
     with its launch plan per width (B4's yardstick: SDPA forward +
     backward graph-replayed, less SDPA's forward; B4's line also gives
     each of its two passes' device ms, from torch.profiler), with a
     `core` line per shape: how the attention core runs there (route,
     blocks launched, blocks per SM, shared bytes per block); B1's
     backward (B1bwd, ops/fused_ln.py; measured last, beside ViT-H/14's
     kernel lines) at the training steps' LayerNorm shapes ([4608, 768],
     [9216, 512], [11648, 1280], [23328, 512])
     against layer_norm_bwd_plain, the same bits on two calls, beside
     the bytes bound, the plain version and ATen's
     native_layer_norm_backward. Every training replay and eager step
     below launches B1bwd once a LayerNorm whose gradient is asked,
     besides the counts it names: 19 a finetune train step (the frozen
     encoder's 25 LayerNorms run under no_grad), 44 unfrozen, 42 a
     pretrain step (22 with B2 on), 82 a ViT-H/14 one; none on the
     counting and eval paths;
  3a. hgn: HGN, the density head's bias + GroupNorm + ReLU in two Triton
     passes (ops/fused_gn.py), at the count build's four head shapes at
     16 windows ([16, 24, 24, 256], [16, 48, 48, 256], [16, 96, 96, 256]
     and stage 3's phase tensor [16, 96, 96, 1024] with the pred conv
     folded in), bf16, against its plain version (within a rounding), the
     same bits on two calls, one HGN a call; graph-replayed ms of the
     kernels beside the bytes bound (the input read twice, the output
     written once), of the plain version, of the ATen chain it replaced
     and of F.group_norm + ReLU on the channels-last view as the library's
     yardstick. Every counting forward, eval and panel replay and eager
     forward below launches HGN 4 times (a density-head stage each)
     besides the counts it names; no training step launches it;
  3b. adamw: the training state's fused AdamW update (ops/fused_adamw.py)
     at mae_base's 251 trainable tensors (111,654,912 fp32): three
     updates of the kernel against its plain version from the same state,
     one eager update's launches (AdamW 1, nothing else), the kernels of
     a whole update (the step count's add and the kernel), and the
     graph-replayed ms of the kernel, its plain version, torch's
     AdamW(fused=True, capturable=True) and the capturable foreach AdamW
     the port ran before, beside the 28-byte-a-parameter bound. Every
     training replay and eager step below that updates launches AdamW
     once besides the counts it names;
  4. forward: full-width mae_vit_base6_patch16 in the bf16 fast mode,
     random weights from torch.Generator seed 0, 16 windows — the kernel
     path against the same model with every kernel swapped for its
     plain version, and windows/s; then a torch.profiler pass: device ms
     by kernel and the device's idle share;
  5. count: CountingEngine(batch_windows=16).count on four synthetic
     images (three plain widths, one in 3x3 grid mode), with the launch
     counters set to 0 just before and read just after: each window
     batch must launch B1 26 times and B2 18 times;
  6. graphed_forward: the same model's window forward replayed from its
     CUDA graph (engine/graphs.py, through CountingEngine's pipeline)
     against the eager forward at 16 windows — the same bits on two
     inputs, and after a weight change (load_state_dict) the new eager
     output's bits — and graphed and eager windows/s (CUDA events);
  7. count_batch: CountingEngine.count_batch, the main counting path, on
     19 synthetic images (plain, 3x3 grid mode and narrow), with the
     counters and the graph runner's counts set to 0 just before and read
     just after: no eager launch, and B1 26 and B2 18 per window batch
     (graph replay); count on each image beside it (equal grid_mode and
     n_windows, counts within COUNT_BATCH_REL_TOL); a torch.profiler pass
     of count_batch and one of count over the same images (device busy
     and idle share);
  8b. parallel: data parallelism on the one card. torchrun's environment
     set here for a world of 1, parallel.dist.init_distributed on NCCL;
     the finetune step (batch 8) and the pretrain step (batch 16) with the
     group (their gradient and metric all-reduces captured in the graphs:
     two issued in each capture, none by a replay) against the same steps
     without one: 4 steps each from the same start to the bit; B1 44, B3
     18, B4 6 and B1 42, B3 20, B4 20 per replay with the counters at 0,
     no eager launch, no capture after the first step; step ms with and
     without the group, the all-reduce's bytes and device ms in the replay
     (profiler); the group destroyed and the environment restored; then
     count_batch through a pipeline over two replicas on cuda:0 against the
     one-device pipeline on the count_batch phase's 19 images: counts
     within COUNT_BATCH_REL_TOL (and whether bitwise), B1 26 and B2 18 per
     replica forward, no eager launch, images/s of both; --n_devices 2
     refused, naming the visible count;
  9. cli_test: countr_tpu_torch.cli.test on a synthetic FSC147 tree of 24
     images (scripts/make_synthetic_fsc.py, in a temporary out_smoke_*
     directory): as a subprocess in the bf16 fast mode (exit code, stats,
     results.csv), then its main in this process on the CLI's own engine,
     with the graphs captured first and the counters and the graph
     runner's counts set to 0 just before and read just after (no eager
     launch; B1 26 and B2 18 per replay), each image's count against
     count on the same decoded arrays (COUNT_BATCH_REL_TOL), zero-shot
     (--box_bound 0), the gate (--expect_mae 0 exits 1); the same for
     --dtype mixed_fast and mixed_bal, with the fp32 head against the
     same head in float64 on one window batch's token grid
     (HEAD_FP64_REL_TOL); images/s per mode and the head's device ms in
     bf16 (subpixel) against fp32 (the `head` line);
  10. serve: countr_tpu_torch.cli.serve in this process on 127.0.0.1,
     port 0, warmed up at two sizes with the grid path; 16 POSTs of JPEG
     bytes from 8 client threads (few-shot, zero-shot, one with boxes
     under 10 px that must answer grid_mode) with the counters set to 0:
     no eager launch, B1 26 and B2 18 per replay, no graph captured
     during traffic; each count against count_image on the same bytes;
     then SERVE_TIMED_REQUESTS more of the same bytes, timed, each count
     against its first answer; /healthz and a 404; requests/s, p50, p99
     and max ms of the timed requests;
  11. demo: countr_tpu_torch.cli.demo on a directory of 3 JPEGs: each
     panel written, each count against count_image;
  12. test_carpk: countr_tpu_torch.cli.test_carpk on a local CARPK tree of
     4 PNGs at 720x1280: B1 26 and B2 18 per replay, no eager launch, a
     finite MAE;
  13. train: full-width mae_vit_base6_patch16 in the bf16 training build
     (B1, B3/B4, B2 off, encoder frozen), random weights from seed 0,
     batch 8 of synthetic images, densities and exemplar crops — one
     step's loss and gradients against the same step with every kernel
     swapped for its plain version; 8 finetune steps (shots 3, 2, 1, 0
     twice) on one repeated batch and loss mask at a constant learning
     rate, replayed from the CUDA graphs of the four shots (captured
     first; engine/train.py on engine/graphs.py), with the counters and
     the graph runner's counts set to 0 just before and read just after
     (no eager launch; B1 44, B3 18, B4 6, B2 0 per replay), against the
     same 8 steps run eagerly on a twin built from the same seed (B1 44,
     B3 18, B4 6 per step): step 1's loss to the bit, every loss, weight
     and Adam tensor within GRAPHED_TOL; graphed and eager ms per step
     and images/s, device memory (the graphs' pool, the eager step's
     peak above the weights), a torch.profiler pass of each (the
     device's idle share); the eval step replayed from its graph against
     eager eval before and after the 8 steps (B1 44, B3 18, B4 0 per
     replay); one graphed step with the encoder unfrozen (B4 18);
  14. accum: the same build at accum_iter 2, 4 mini-steps (shots 3, 3,
     1, 1) replayed from the accumulate and update graphs against the
     eager mini-steps from the same start; the weights keep their bits on
     the mini-steps that accumulate;
  15. checkpoint: 4 graphed steps from seed 0, save_checkpoint, a fresh
     state from seed 1 with its graphs captured, restore_checkpoint in
     place (no live tensor replaced, no graph captured again), 4 more
     graphed steps: the losses and weights of the train phase's 8;
  16. pretrain: full-width mae_vit_base_patch16 (12x768 encoder on the
     288 visible tokens, 8x512 decoder), bf16, batch 16, mask ratio 0.5,
     random weights from seed 0, for both builds — the pretrain CLI's (B1,
     B3/B4, B2 off) and the config's default (B2, its backward through
     B3/B4) — one step's loss and gradients against the all-plain step on
     the same weights, images and noise; 8 steps on one repeated batch at
     a constant learning rate, the masking noise drawn inside each step
     from a generator reseeded before it, replayed from the step's CUDA
     graph (B1 42, B3 20, B4 20, B2 0 per replay; with B2 on: B2 20, B1
     22, B3 20, B4 20), against 8 eager steps from the same start, as in
     the train phase;
  17. finetune_cli: countr_tpu_torch.cli.finetune on a synthetic FSC147 tree
     (scripts/make_synthetic_fsc.py, 96 train and 16 val images, in a
     temporary out_smoke_* directory) at the full width of
     mae_vit_base6_patch16 in the bf16 training build, batch 8: as a
     subprocess for 2 epochs of 12 steps (exit code, both epochs' records
     finite, ckpt_last and ckpt_minMAE written), then --do_resume --epochs 3
     (starts at epoch 2); then in this process, the host path and
     --device_aug, each with its graphs captured first and the counters set
     to 0 (B1 44, B3 18, B4 6 per train replay, B1 44, B3 18 per eval
     replay, no eager launch, no graph captured during the epochs), the
     loader-fed images/s of a timed epoch beside the graphed step's on a
     batch already on the card, a profiled epoch (the device's idle share),
     the host augmentation's ms per sample on one thread and at the
     loader's thread count, os.cpu_count(); for --device_aug the
     augmentation's device ms and the branchless jitter's against one
     sequential pass of its four ops; four graphed CLI steps against four
     eager ones (graphed=False; the same losses to the bit); a run stopped
     after epoch 0 and resumed (--do_resume) against the uninterrupted run
     (the same stats and weights, to the bit);
  17b. surfaces: on the same tree, the finetune CLI in this process for 2
     epochs of 12 steps with --log_every 4 --panel_every 1, TensorBoard
     under its output directory and common.make_wandb swapped for a
     recording sink, graphs captured first (the panel forward's among
     them): B1 44, B3 18, B4 6 per train replay, B1 44, B3 18 per eval and
     per panel replay, no eager launch, no capture during the epochs; the
     event files read back and the W&B calls against the tags and steps
     the JAX CLI writes; the panel replay's densities against an eager
     forward of the same samples, to the bit; the panel and eval replays'
     ms; train epochs with the step scalars on against off, and one
     epoch's panels alone (and one TensorBoard image); --debug_nans (no
     graph, 2 eager steps and their launches, a batch with one NaN pixel
     raising FloatingPointError naming its step, then the CLI without the
     flag capturing and replaying its graphs); countr_tpu_torch.entry.entry()
     against the model's own eager forward, to the bit (B1 26 and B2 18).
     cli.aggregate runs inside the cli_test phase, over its run
     directories: each row against the mean of its run's log.txt;
  18. resident_cli: the same CLI with --resident_data on the same tree
     (the train and validation splits resident on the card,
     engine/train_store.py), in this process, graphs captured first: B1 44,
     B3 18, B4 6 per train replay, B1 44, B3 18 per eval replay, no eager
     launch, no capture during the epochs; loader-fed images/s, the idle
     share of a profiled epoch, the graphed step's ms on a batch already on
     the card, the materialisation's ms alone (graphed, bitwise against
     eager; the pixels alone, eager), the host's ms per sample of
     _store_item (one thread, the loader's 8), the stores' bytes; four
     graphed steps against four eager ones, a resumed run against the
     uninterrupted one, then --resident_pipeline (its materialise, pipelined
     and train-phase graphs: 0, and 44 / 18 / 6 per replay) against the
     serial run, each to the bit, with its step ms beside the serial one's;
  19. pretrain_cli: countr_tpu_torch.cli.pretrain on the same tree at the
     full width of mae_vit_base_patch16 in the bf16 build (B1, B3/B4, B2
     off), batch 16, 6 steps an epoch: as a subprocess for one epoch of 2
     steps (exit code, a finite loss), then in this process on the host
     path (PIL's RandomResizedCrop on the loader's 8 threads) and with
     --resident_data (the column-major uint8 pool on the card, crop scalars
     from the host), each with its graph captured first and the counters at
     0 for 2 epochs (B1 42, B3 20, B4 20 per replay, no eager launch, no
     capture during the epochs); loader-fed images/s of a timed epoch, the
     idle share of a profiled epoch, the graphed step's ms on a batch
     already on the card, the host's ms a sample (one thread, the loader's
     8), the upload's bytes a batch; four graphed steps against four eager
     ones (the same losses to the bit); a run stopped after epoch 0 and
     resumed against the uninterrupted one (the same stats and weights, to
     the bit; the seconds and bytes of epoch 0's ckpt_last and ckpt_params
     saves); on the host path the reconstruction panel (shape, range, ms)
     and whether TensorBoard imports; on the resident path the
     materialisation replayed from a graph and eager with the process's
     TF32 flags on against eager with them off (the same bits), its ms and
     the store's bytes;
  19b. pretrain_huge: the same CLI in this process with
     --model mae_vit_huge_patch14 (ViT-H/14 at 378 px, 32 x 1280, 16 heads
     of 80), batch 32, one epoch of 3 steps on --resident_data and on the
     host path: B1 82, B3 40 and B4 40 per replay, of them B3h80 32 and
     B4h80 32 (head dim 80), AdamW 1, no eager launch, no capture during
     the epoch; finite losses, crops of 378 px, the step's ms on the card
     and the peak memory; one AdamW update over 656.6 M parameters
     against its plain version on a copy of the state (adamw's bound),
     and the ms of each beside the bound;
  20. store_pool: materialize_batch alone on a pool of FSC147's size made
     on the card (3659 random images at 384x512, ~2.2 GB uint8), batches of
     8 with 2 mosaics, eager and graph-replayed ms beside the bytes bound;
     then (the pretrain_pool line) materialize_pretrain_batch on the same
     pixels as a pretrain store (max_w 512), batches of 16 crops, eager and
     graph-replayed ms beside its fp32 operations bound and bytes bound;
  21. carpk_cli: countr_tpu_torch.cli.finetune_carpk on a local CARPK tree
     of 8 PNGs at 720x1280, batch 1, on the host path and with
     --resident_data (engine/carpk_store.py): B1 44, B3 18, B4 6 per
     replay, no eager launch, no capture during 2 epochs; loader-fed
     images/s, the idle share, the step's ms on the card, the host's ms per
     sample; four graphed steps against four eager ones, to the bit.
  22. the kernel lines of B1, B3 and B4 at ViT-H/14's shapes
     (mae_vit_huge_patch14, batch 32): B1 at [11648, 1280] and [23328,
     512], B3/B4 at [32, 364, 1280] with 16 heads of 80 and [32, 729,
     512] with 16 of 32, as phase 3 measures the others; last, since a
     one-kernel torch.profiler window after their profiled passes lost
     its only record (B6's check in phase 3 read none);
Then a {"kernels": [...]} line, the nvidia-smi line, and as the last
line {"ok": true, "device": {...}}. Any failed check raises: nonzero
exit code and no result line. Needs a CUDA device; uses no JAX.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import subprocess
import sys
import time

import numpy as np

# The peaks and the kernels' operation and byte counts are the
# benchmark's, so the smoke's bounds and the ledger's rooflines agree.
from benchmark.lib.peaks import BF16_FLOPS, HBM_BYTES_PER_S
from benchmark.work.kernels import b1, b1bwd, b2, b3, b3h80, b4, b4h80

LN_TOL = 2.0 ** -6  # docs/PARITY.md:228 (1.56e-2)
BLOCK_TOL = 2.0 ** -5  # docs/PARITY.md:231 (3.1e-2)
# docs/PARITY.md:229-230 (3.9e-3, the JAX kernel's own bf16 bound, fwd and
# grads, at N(0, 1) inputs): one bf16 ulp of outputs in [0.5, 1). B3/B4
# and their plain versions round at the same points, so they differ by
# one ulp of an output at most: the limit is one ulp of the largest
# reference value, and not below 3.9e-3.
ATTN_TOL = 3.9e-3
FORWARD_REL_TOL = 2.2e-2  # docs/PARITY.md:235, times max(1, max|ref|)
# The train step, kernels against plain versions on the same weights,
# batch and mask: the loss within 2.2e-2 relative (the forward's bound),
# and each trainable gradient's cosine at least 0.99.
TRAIN_LOSS_REL_TOL = 2.2e-2
GRAD_COSINE_MIN = 0.99
# A training step replayed from its CUDA graph against the same step run
# eagerly from the same start (the same fused AdamW, the same kernels
# in the same order): the same bits in every loss, weight and Adam tensor.
GRAPHED_TOL = 0.0
WINDOWS = 16
TRAIN_BATCH = 8  # cli/finetune.py:35
# The train phase's learning rate, held constant (min_lr = lr, no
# warmup): the finetune CLI's peak rate at batch 8, blr 2e-4 * 8 / 256.
# On an H100 (700 W) the random full-width model's shot-3 loss rose over
# four steps at 1e-4 (0.097 to 0.152) and stayed level at 1e-5 (0.0969 to
# 0.0973), each step with its own mask: Adam's
# first steps move every weight by about lr, which the real recipe's
# warmup avoids.
TRAIN_LR = 2e-4 * TRAIN_BATCH / 256
PRETRAIN_BATCH = 16  # cli/pretrain.py:38
# The pretrain phase's learning rate, held constant: the pretrain CLI's
# peak rate at batch 16, blr 1.5e-4 * 16 / 256 (cli/pretrain.py:41,
# FSC_pretrain.py's scaling). The real recipe reaches it after a 10-epoch
# warmup; eight Adam steps at it move every weight by about 1e-5.
PRETRAIN_LR = 1.5e-4 * PRETRAIN_BATCH / 256
# mae_vit_huge_patch14's batch (the pretrain-huge-resident cell's, MAE's
# 4096 over 128 TPU cores) and its attention shapes: the encoder's 364
# kept tokens of a 27 x 27 grid at 16 heads of 80, the decoder's 729 at 16
# of 32.
HUGE_BATCH = 32
HUGE_ATTN_SHAPES = ((HUGE_BATCH, 364, 1280, 16), (HUGE_BATCH, 729, 512, 16))
HUGE_LN_SHAPES = ((HUGE_BATCH * 364, 1280), (HUGE_BATCH * 729, 512))


def say(phase: str, **kv) -> None:
    print(json.dumps({"phase": phase, **kv}), flush=True)


def time_ms(torch, fn, arg_sets, iters: int = 30, warmup: int = 3) -> float:
    """Mean ms per eager call from CUDA events, cycling through
    ``arg_sets`` (distinct inputs, together larger than the 50 MB L2, so
    each call reads its operands from device memory as the model's
    would). Includes the host's launch cost wherever it exceeds the
    device time."""
    for i in range(warmup):
        fn(*arg_sets[i % len(arg_sets)])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, arg_sets, iters: int = 16, replays: int = 3) -> float:
    """Mean device ms per call: ``iters`` calls (cycling through
    ``arg_sets``) captured in one CUDA graph, replayed ``replays`` times
    between CUDA events. The host's launch cost is out of the reading."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(*arg_sets[i % len(arg_sets)])
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    # relaxed: the first launch of each kernel instantiation calls
    # cudaFuncSetAttribute, not a stream operation (the warm-up calls
    # above make those first launches).
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (iters * replays)
    del graph
    torch.cuda.empty_cache()
    return ms


def events_ms(fn, iters: int) -> float:
    """Least mean ms per call of ``fn()`` over 3 runs of ``iters`` calls,
    each run between two CUDA events (after one warm-up call)."""
    import torch

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


def bound(flops: float, moved: float):
    """The least time the card could take for ``flops`` bf16 tensor-core
    operations moving ``moved`` bytes: (ms, "operations" or "bytes")."""
    tf, tb = flops / BF16_FLOPS, moved / HBM_BYTES_PER_S
    return max(tf, tb) * 1e3, "operations" if tf > tb else "bytes"


def max_abs(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def attn_limit(ref) -> float:
    """One bf16 ulp of the largest |ref|, and not below ATTN_TOL."""
    top = float(ref.float().abs().max())
    return max(ATTN_TOL, 2.0 ** (np.floor(np.log2(top)) - 7)) if top > 0 else ATTN_TOL


def phase_build():
    from countr_tpu_torch.ops import fused_attn, fused_block, fused_cross, fused_mlp
    from countr_tpu_torch.ops.cuda_build import build_libraries

    libs = (("attn_block", ("B2", fused_block)), ("attn", ("B3 B4", fused_attn)),
            ("mlp_block", ("B5", fused_mlp)), ("cross_block", ("B6", fused_cross)))
    t0 = time.perf_counter()
    built = build_libraries([name for name, _ in libs])
    wall = time.perf_counter() - t0
    for name, (kernels, module) in libs:
        rec = module.build()  # binds the library built above (B6's refuses a C7515)
        extra = {}
        if module is fused_cross:
            # the one kernel's registers, spills and C7515 warnings per
            # instantiation, and its dynamic shared memory at the decoder
            report = fused_cross.ptxas_report(rec["log"])
            if not report:
                raise AssertionError("B6: no cross_block_kernel in the ptxas report")
            spilled = [f["function"] for f in report
                       if f.get("spill_stores", 0) or f.get("spill_loads", 0) or f["c7515"]]
            if spilled:
                raise AssertionError(f"B6: spills or C7515 in {spilled}")
            extra = dict(kernel_ptxas=report,
                         decoder_plan=fused_cross.plan(WINDOWS * 576, 512, 16))
        say("build", kernel=kernels, source=f"countr_tpu_torch/csrc/{name}.cu",
            nvcc_s=built[name][1]["seconds"], wall_s=wall, library=rec["path"],
            ptxas=[ln.strip() for ln in rec["log"].splitlines() if "Used" in ln], **extra)


def ln_phase(torch, dev, sizes=((WINDOWS * 576, 768), (WINDOWS * 576, 512))):
    import torch.nn.functional as F
    from countr_tpu_torch.ops.fused_ln import fused_layer_norm, layer_norm_plain

    rng = np.random.default_rng(0)
    shapes = []
    for rows, c in sizes:
        xs = [torch.from_numpy(rng.standard_normal((rows, c), np.float32)).to(dev, torch.bfloat16)
              for _ in range(8)]
        s = torch.from_numpy(1 + 0.05 * rng.standard_normal(c, np.float32)).to(dev)
        b = torch.from_numpy(0.05 * rng.standard_normal(c, np.float32)).to(dev)
        t0 = time.perf_counter()
        got = fused_layer_norm(xs[0], s, b, 1e-6)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        err = max_abs(got, layer_norm_plain(xs[0], s, b, 1e-6))
        if not err <= LN_TOL:
            raise AssertionError(f"B1 [{rows},{c}] max|d| {err} > {LN_TOL}")
        sb, bb = s.to(torch.bfloat16), b.to(torch.bfloat16)
        args = [(x,) for x in xs]
        bound_ms, bound_by = bound(b1.flops(rows, c), b1.nbytes(rows, c))
        kernel = lambda x: fused_layer_norm(x, s, b, 1e-6)  # noqa: E731
        shapes.append(dict(
            shape=[rows, c], max_abs_err=err, first_call_s=first_s,
            ms=graph_ms(torch, kernel, args),
            plain_ms=graph_ms(torch, lambda x: layer_norm_plain(x, s, b, 1e-6), args),
            library_ms=graph_ms(torch, lambda x: F.layer_norm(x, (c,), sb, bb, 1e-6), args),
            bound_ms=bound_ms, bound_by=bound_by, eager_ms=time_ms(torch, kernel, args),
        ))
        say("kernel", name="B1 fused_layer_norm", **shapes[-1])
    return shapes


# B1's backward (B1bwd) at the training steps' LayerNorm shapes: mae_base's
# pretrain encoder and decoder, ViT-H/14's encoder and decoder. dx within
# one bf16 ulp of max|ref|; dscale and dbias within 1e-5 of max|ref| (fp32
# sums over up to 23,328 rows in another order).
LN_BWD_SHAPES = ((PRETRAIN_BATCH * 288, 768), (PRETRAIN_BATCH * 576, 512)) + HUGE_LN_SHAPES


def ln_bwd_phase(torch, dev, sizes=LN_BWD_SHAPES):
    """B1bwd against ``layer_norm_bwd_plain`` at each shape, the same bits
    on two calls, one B1bwd a call; its graph-replayed ms beside the bytes
    bound (x and g read, dx written in bf16; the two fp32 gradients), the
    plain version's and the library's (ATen's ``native_layer_norm_backward``,
    the kernel behind ``F.layer_norm``'s autograd backward, with bf16
    weights as the forward's library line)."""
    from countr_tpu_torch.ops.fused_ln import fused_layer_norm, fused_layer_norm_bwd, \
        layer_norm_bwd_plain

    rng = np.random.default_rng(3)
    shapes = []
    for rows, c in sizes:
        sets = [tuple(randn_on(torch, rng, dev, (rows, c)) for _ in range(2)) for _ in range(4)]
        s = randn_on(torch, rng, dev, (c,), 0.05, 1.0, torch.float32)
        b = randn_on(torch, rng, dev, (c,), 0.05, 0.0, torch.float32)
        x, g = sets[0]
        n0 = fused_layer_norm.bwd_launches
        t0 = time.perf_counter()
        got = fused_layer_norm_bwd(x, s, b, g, 1e-6)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        again = fused_layer_norm_bwd(x, s, b, g, 1e-6)
        torch.cuda.synchronize()
        want = layer_norm_bwd_plain(x, s, b, g, 1e-6)
        dx_lim = 2.0 ** (np.floor(np.log2(float(want[0].float().abs().max()))) - 7)
        errs = [max_abs(a, w) for a, w in zip(got, want)]
        lims = [dx_lim] + [1e-5 * float(w.abs().max()) for w in want[1:]]
        if not all(e <= lim for e, lim in zip(errs, lims)):
            raise AssertionError(f"B1bwd [{rows},{c}] max|d| {errs} > {lims}")
        if not all(torch.equal(p, q) for p, q in zip(got, again)):
            raise AssertionError(f"B1bwd [{rows},{c}]: two calls gave other bits")
        if fused_layer_norm.bwd_launches != n0 + 2:
            raise AssertionError(f"B1bwd [{rows},{c}]: {fused_layer_norm.bwd_launches - n0} "
                                 "launches counted for 2 calls")
        sb, bb = s.to(torch.bfloat16), b.to(torch.bfloat16)
        lib = [(gg, xx, *torch.ops.aten.native_layer_norm(xx, (c,), sb, bb, 1e-6)[1:])
               for xx, gg in sets]
        bound_ms, bound_by = bound(b1bwd.flops(rows, c), b1bwd.nbytes(rows, c))
        shapes.append(dict(
            shape=[rows, c], max_abs_err=errs[0], weight_grad_errs=errs[1:], limits=lims,
            first_call_s=first_s,
            ms=graph_ms(torch, lambda x, g: fused_layer_norm_bwd(x, s, b, g, 1e-6), sets),
            plain_ms=graph_ms(torch, lambda x, g: layer_norm_bwd_plain(x, s, b, g, 1e-6), sets),
            library_ms=graph_ms(torch, lambda g, x, mean, rstd: torch.ops.aten.
                                native_layer_norm_backward(g, x, (c,), mean, rstd, sb, bb,
                                                           [True, True, True]), lib),
            bound_ms=bound_ms, bound_by=bound_by,
        ))
        say("kernel", name="B1bwd fused_layer_norm backward", **shapes[-1])
    return shapes


# Every GEMM of the paths at 16 windows (M = 9216): (product, N, K,
# epilogue) for B2's qkv and proj and B5's fc1 and fc2, encoder and
# decoder. (B6 runs its two 512 x 512 products in its own kernel.)
GEMM_SHAPES = (
    ("B2 qkv, encoder", 2304, 768, "bias"), ("B2 proj, encoder", 768, 768, "residual"),
    ("B2 qkv, decoder", 1536, 512, "bias"), ("B2 proj, decoder", 512, 512, "residual"),
    ("B5 fc1, encoder", 3072, 768, "gelu_tanh"), ("B5 fc2, encoder", 768, 3072, "residual"),
    ("B5 fc1, decoder", 2048, 512, "gelu_tanh"), ("B5 fc2, decoder", 512, 2048, "residual"),
)


def gemm_phase(torch, dev):
    """The shared GEMM at each product of GEMM_SHAPES: max|d| against
    ``gemm_nt_plain`` (limit 2^-5·max(1, max|ref|), B5's), the
    kernel's graph-replayed ms and TFLOP/s beside ``torch.matmul`` of the
    same operands (no bias, no epilogue), and the card's bound."""
    from countr_tpu_torch.ops.gemm import gemm_nt, gemm_nt_plain

    rng = np.random.default_rng(12)
    m = WINDOWS * 576
    lines = []
    for product, n, k, epi in GEMM_SHAPES:
        a_sets = [randn_on(torch, rng, dev, (m, k)) for _ in range(4)]
        w = randn_on(torch, rng, dev, (n, k), 0.05)
        bias = randn_on(torch, rng, dev, (n,), 0.05)
        r = randn_on(torch, rng, dev, (m, n))
        got = gemm_nt(a_sets[0], w, bias, r, epi)
        torch.cuda.synchronize()
        want = gemm_nt_plain(a_sets[0], w, bias, r, epi)
        err = max_abs(got, want)
        lim = BLOCK_TOL * max(1.0, float(want.float().abs().max()))
        if not err <= lim:
            raise AssertionError(f"gemm {product} [{m}, {n}, {k}] {epi}: max|d| {err} > {lim}")
        flops = 2 * m * n * k
        # a, w and the bias in, the output out (and the residual in), bf16
        moved = (m * k + n * k + m * n * (2 if epi == "residual" else 1) + n) * 2
        args = [(x,) for x in a_sets]
        ms = graph_ms(torch, lambda x: gemm_nt(x, w, bias, r, epi), args)
        mm_ms = graph_ms(torch, lambda x: torch.matmul(x, w.t()), args)
        bm, bb = bound(flops, moved)
        lines.append(dict(product=product, shape=[m, n, k], epilogue=epi, max_abs_err=err,
                          limit=lim, ms=ms, tflops=flops / ms / 1e9, matmul_ms=mm_ms,
                          matmul_tflops=flops / mm_ms / 1e9, bound_ms=bm, bound_by=bb))
        say("gemm", **lines[-1])
        del a_sets, r, got, want
    return lines


def block_phase(torch, dev):
    import torch.nn.functional as F
    from countr_tpu_torch.ops.fused_block import attention_block_plain, fused_attention_block

    rng = np.random.default_rng(1)
    bf = torch.bfloat16
    shapes = []
    for b, n, c, h in ((WINDOWS, 576, 768, 12), (WINDOWS, 576, 512, 16)):
        def t(shape, scale=1.0, off=0.0, dtype=bf):
            a = rng.standard_normal(shape).astype(np.float32) * scale + off
            return torch.from_numpy(a).to(dev, dtype)

        xs = [t((b, n, c)) for _ in range(4)]
        lns, lnb = t((c,), 0.05, 1.0, torch.float32), t((c,), 0.05, 0.0, torch.float32)
        w = [t(s, 0.05) for s in ((3 * c, c), (3 * c,), (c, c), (c,))]
        got = fused_attention_block(xs[0], lns, lnb, *w, h, 1e-6)
        torch.cuda.synchronize()
        err = max_abs(got, attention_block_plain(xs[0], lns, lnb, *w, h, 1e-6))
        if not err <= BLOCK_TOL:
            raise AssertionError(f"B2 [{b},{n},{c}]x{h} max|d| {err} > {BLOCK_TOL}")
        lns_b, lnb_b = lns.to(bf), lnb.to(bf)
        hd = c // h

        def library(x):
            xn = F.layer_norm(x, (c,), lns_b, lnb_b, 1e-6)
            q, k, v = F.linear(xn, w[0], w[1]).view(b, n, 3, h, hd).permute(2, 0, 3, 1, 4)
            att = F.scaled_dot_product_attention(q, k, v)
            return x + F.linear(att.transpose(1, 2).reshape(b, n, c), w[2], w[3])

        flops = b2.flops(b, n, c)
        args = [(x,) for x in xs]
        kernel = lambda x: fused_attention_block(x, lns, lnb, *w, h, 1e-6)  # noqa: E731
        bm, bb = bound(flops, b2.nbytes(b, n, c))
        shapes.append(dict(
            shape=[b, n, c, h], max_abs_err=err,
            ms=graph_ms(torch, kernel, args),
            plain_ms=graph_ms(torch, lambda x: attention_block_plain(x, lns, lnb, *w, h, 1e-6),
                              args, iters=4),
            library_ms=graph_ms(torch, library, args),
            bound_ms=bm, bound_by=bb, gflop=flops / 1e9,
            eager_ms=time_ms(torch, kernel, args),
        ))
        say("kernel", name="B2 fused_attention_block", **shapes[-1])
    return shapes


def attn_phase(torch, dev, shapes=((TRAIN_BATCH, 576, 512, 16), (TRAIN_BATCH, 576, 768, 12),
                                   (PRETRAIN_BATCH, 288, 768, 12),
                                   (PRETRAIN_BATCH, 576, 512, 16), (WINDOWS, 576, 768, 12))):
    """B3 and B4 at the train step's shapes: [8, 576, 512] with 16 heads
    (decoder) and [8, 576, 768] with 12 (encoder), and at the pretrain
    step's: the encoder's [16, 288, 768] with 12 (the 288 visible tokens
    of a 0.5 mask) and the decoder's [16, 576, 512] with 16; B3 also at
    B2's encoder shape [16, 576, 768] with 12, the core of B2's step 3;
    packed qkv (``shapes``; the smoke's last phase passes ViT-H/14's,
    HUGE_ATTN_SHAPES). Each shape's ``core`` line gives the attention
    core's plan (``fused_attn.core_plan``)."""
    import torch.nn.functional as F
    from countr_tpu_torch.ops.fused_attn import (
        attention_bwd_plain, attention_exp2, core_plan, fused_attention_bwd, fused_attention_qkv,
    )

    rng = np.random.default_rng(5)
    bf = torch.bfloat16
    fwd, bwd = [], []
    for b, n, c, h in shapes:
        hd = c // h
        k3, k4 = (b3h80, b4h80) if hd == 80 else (b3, b4)
        with_b4 = (b, n, c, h) != (WINDOWS, 576, 768, 12)
        say("core", shape=[b, n, c, h], **core_plan(b, n, c, h))

        def t(*shape):
            return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(dev, bf)

        qkvs = [t(b, n, 3 * c) for _ in range(4)]  # 4 sets > the 50 MB L2
        gs = [t(b, n, c) for _ in range(4)] if with_b4 else []
        qkv = qkvs[0]
        with torch.no_grad():
            got = fused_attention_qkv(qkv, h)
            torch.cuda.synchronize()
            want = attention_exp2(*qkv.chunk(3, dim=-1), h)
        err, lim = max_abs(got, want), attn_limit(want)
        if not err <= lim:
            raise AssertionError(f"B3 [{b},{n},{c}]x{h} max|d| {err} > {lim}")

        def heads(x):
            return x.view(b, n, 3, h, hd).permute(2, 0, 3, 1, 4)

        def sdpa(x):
            return F.scaled_dot_product_attention(*heads(x))

        with torch.no_grad():
            args = [(x,) for x in qkvs]
            b3_ms = graph_ms(torch, lambda x: fused_attention_qkv(x, h), args)
            b3_plain = graph_ms(torch, lambda x: attention_exp2(*x.chunk(3, dim=-1), h), args,
                                iters=4)
            b3_lib = graph_ms(torch, sdpa, args)
        bm, bb = bound(k3.flops(b, n, c), k3.nbytes(b, n, c))
        fwd.append(dict(shape=[b, n, c, h], max_abs_err=err, limit=lim, ms=b3_ms, plain_ms=b3_plain,
                        library_ms=b3_lib, library="scaled_dot_product_attention",
                        bound_ms=bm, bound_by=bb, gflop=k3.flops(b, n, c) / 1e9))
        say("kernel", name="B3 fused_attention", **fwd[-1])
        if not with_b4:
            continue

        g = gs[0]
        with torch.no_grad():
            dgot = fused_attention_bwd(qkv, g, h)
            torch.cuda.synchronize()
            dwant = torch.cat(attention_bwd_plain(*qkv.chunk(3, dim=-1), g, h), dim=-1)
        derr, dlim = max_abs(dgot, dwant), attn_limit(dwant)
        if not derr <= dlim:
            raise AssertionError(f"B4 [{b},{n},{c}]x{h} max|d| {derr} > {dlim}")

        # The library's backward: SDPA forward + backward under autograd,
        # less SDPA's forward alone, both graph-replayed on leaves that no
        # eager autograd graph holds (a captured backward cannot feed a
        # gradient node made on another stream); then, for comparison,
        # autograd through SDPA from its saved forward, eager.
        ghs = [gg.view(b, n, h, hd).transpose(1, 2).contiguous() for gg in gs[:2]]
        gleaves = [heads(x).contiguous().requires_grad_(True) for x in qkvs[:2]]

        def sdpa_fwd_grad(i):
            return F.scaled_dot_product_attention(*gleaves[i])

        def sdpa_fwd_bwd(i):
            return torch.autograd.grad(F.scaled_dot_product_attention(*gleaves[i]), gleaves[i],
                                       ghs[i])

        lib_fwd = graph_ms(torch, sdpa_fwd_grad, [(0,), (1,)])
        lib_fwd_bwd = graph_ms(torch, sdpa_fwd_bwd, [(0,), (1,)])
        b4_lib = lib_fwd_bwd - lib_fwd
        leaves = [heads(x).contiguous().requires_grad_(True) for x in qkvs[:2]]
        outs = [F.scaled_dot_product_attention(*lv) for lv in leaves]

        def sdpa_bwd(i):
            return torch.autograd.grad(outs[i], leaves[i], ghs[i], retain_graph=True)

        f10 = k4.flops(b, n, c)
        with torch.no_grad():
            bargs = list(zip(qkvs, gs))
            b4_ms = graph_ms(torch, lambda x, gg: fused_attention_bwd(x, gg, h), bargs)
            b4_plain = graph_ms(torch, lambda x, gg: attention_bwd_plain(
                *x.chunk(3, dim=-1), gg, h), bargs, iters=4)
        b4_lib_eager = time_ms(torch, sdpa_bwd, [(0,), (1,)], iters=20)
        with torch.no_grad():
            cycle = itertools.cycle(bargs)
            passes = profile_run(torch, lambda: fused_attention_bwd(*next(cycle), h),
                                 12)["port_kernels"]
        bm, bb = bound(f10, k4.nbytes(b, n, c))
        bwd.append(dict(shape=[b, n, c, h], max_abs_err=derr, limit=dlim, ms=b4_ms,
                        plain_ms=b4_plain, library_ms=b4_lib,
                        library="SDPA forward + backward (torch.autograd.grad) less SDPA "
                                "forward, each graph-replayed",
                        library_fwd_bwd_ms=lib_fwd_bwd, library_fwd_ms=lib_fwd,
                        library_eager_ms=b4_lib_eager, passes=passes,
                        bound_ms=bm, bound_by=bb, gflop=f10 / 1e9))
        say("kernel", name="B4 fused_attention backward", **bwd[-1])
        del leaves, outs, gleaves
    return fwd, bwd


def randn_on(torch, rng, dev, shape, scale=1.0, off=0.0, dtype=None):
    """scale * N(0, 1) + off from numpy, on ``dev`` in ``dtype`` (bf16)."""
    a = rng.standard_normal(shape).astype(np.float32) * scale + off
    return torch.from_numpy(a).to(dev, dtype or torch.bfloat16)


def ab_call(torch, fn, key: str, ab: dict):
    """One call ``fn()`` of a fused branch's public entry, as the A/B
    scripts make it, with the launch counters set to 0 just before and
    read just after: it must launch kernel ``key`` once and nothing else.
    Adds the counts to ``ab``, the "ab" path's, and returns the output."""
    reset_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = launch_counts()
    if counts != {k: int(k == key) for k in counts}:
        raise AssertionError(f"ab path: one {key} call launched {counts}")
    for k, v in counts.items():
        ab[k] = ab.get(k, 0) + v
    return out


def mlp_phase(torch, dev, ab: dict):
    """B5 at scripts/ab_fused_block.py's shapes, 16 windows: the encoder's
    [16, 576, 768] with hidden 3072 (tanh and erf GELU) and the MAE
    decoder's [16, 576, 512] with hidden 2048 (tanh). No model path runs
    it (as in the JAX package): the checked call of each shape is the "ab"
    path's, counted into ``ab``."""
    import torch.nn.functional as F
    from countr_tpu_torch.ops.fused_mlp import fused_mlp_block, mlp_block_plain

    rng = np.random.default_rng(7)
    f32 = torch.float32
    shapes = []
    for b, n, c, hid, approx in ((WINDOWS, 576, 768, 3072, True), (WINDOWS, 576, 768, 3072, False),
                                 (WINDOWS, 576, 512, 2048, True)):
        xs = [randn_on(torch, rng, dev, (b, n, c)) for _ in range(4)]
        lns = randn_on(torch, rng, dev, (c,), 0.05, 1.0, f32)
        lnb = randn_on(torch, rng, dev, (c,), 0.05, 0.0, f32)
        w = [randn_on(torch, rng, dev, s, 0.05) for s in ((hid, c), (hid,), (c, hid), (c,))]
        got = ab_call(torch, lambda: fused_mlp_block(xs[0], lns, lnb, *w, 1e-6, approx),
                      "B5", ab)
        want = mlp_block_plain(xs[0], lns, lnb, *w, 1e-6, approx)
        err = max_abs(got, want)
        lim = BLOCK_TOL * max(1.0, float(want.float().abs().max()))
        if not err <= lim:
            raise AssertionError(f"B5 [{b},{n},{c}] hidden {hid} max|d| {err} > {lim}")
        lns_b, lnb_b = lns.to(torch.bfloat16), lnb.to(torch.bfloat16)
        gelu = "tanh" if approx else "none"

        def library(x):
            h = F.gelu(F.linear(F.layer_norm(x, (c,), lns_b, lnb_b, 1e-6), w[0], w[1]),
                       approximate=gelu)
            return x + F.linear(h, w[2], w[3])

        m = b * n
        bm, bb = bound(4 * m * c * hid, 2 * m * c * 2 + 2 * c * hid * 2 + (hid + c) * 2 + 2 * c * 4)
        args = [(x,) for x in xs]
        shapes.append(dict(
            shape=[b, n, c, hid], gelu="tanh" if approx else "erf", max_abs_err=err, limit=lim,
            ms=graph_ms(torch, lambda x: fused_mlp_block(x, lns, lnb, *w, 1e-6, approx), args),
            plain_ms=graph_ms(torch, lambda x: mlp_block_plain(x, lns, lnb, *w, 1e-6, approx),
                              args, iters=4),
            library_ms=graph_ms(torch, library, args),
            library="F.layer_norm + F.linear + F.gelu + F.linear + add",
            bound_ms=bm, bound_by=bb, gflop=4 * m * c * hid / 1e9))
        say("kernel", name="B5 fused_mlp_block", **shapes[-1])
    return shapes


AB_CROSS_NY = (3, 1)  # scripts/ab_cross_block.py's token counts: the "ab" path's B6 calls


def kernels_per_call(torch, fn) -> list:
    """The device kernels that one call of ``fn`` runs, by name, from a
    torch.profiler window around that call (after one call unprofiled)."""
    rows = profile_run(torch, fn, 1)["top"]
    return [{"kernel": r["kernel"], "calls": r["calls"]} for r in rows]


# B6's wider rows, 16 windows of 576 tokens at ny 3: C 768 (12 heads of
# 64), 1024 (16 of 64), 1280 (5 of 256: a cluster splits them 3 / 2) and
# 2048 (16 of 128), the widths past the decoder's that B2 and B5 take
CROSS_WIDE = ((768, 12), (1024, 16), (1280, 5), (2048, 16))


def cross_phase(torch, dev, ab: dict):
    """B6 at scripts/ab_cross_block.py's decoder geometry, 16 windows:
    [16, 576, 512], 16 heads, over ny 3 (three exemplars), ny 1 (zero
    shot: the shot token) and ny 8 (the most the kernel takes); then at
    ny 3 at each width of ``CROSS_WIDE``. No model path runs it (as in
    the JAX package): the checked calls at the A/B geometries (ny 3 and
    1) are the "ab" path's, counted into ``ab``; the others are checked
    beside them. Each line gives the launch plan (``fused_cross.plan``:
    tile rows, ring stages, LN(x) resident or streamed, blocks per
    cluster), the device kernels of one call (torch.profiler: 1, where
    the earlier four-launch design ran 4) and, under ``bytes_estimate``,
    the device-memory bytes the design and the bound count from the
    shapes (arithmetic, not a counter reading: the profiler here reads no
    DRAM counter). Those counts stay on this line, out of the shapes the
    kernels entry carries."""
    import torch.nn.functional as F
    from countr_tpu_torch.ops.fused_cross import (cross_block_plain, fused_cross_attention_block,
                                                  plan)

    rng = np.random.default_rng(8)
    f32 = torch.float32
    b, n = WINDOWS, 576
    shapes = []
    for c, h, ny in ((512, 16, 3), (512, 16, 1), (512, 16, 8),
                     *((c, h, 3) for c, h in CROSS_WIDE)):
        hd = c // h
        xs = [randn_on(torch, rng, dev, (b, n, c)) for _ in range(4)]
        k, v = (randn_on(torch, rng, dev, (b, ny, c)) for _ in range(2))
        lns = randn_on(torch, rng, dev, (c,), 0.05, 1.0, f32)
        lnb = randn_on(torch, rng, dev, (c,), 0.05, 0.0, f32)
        wq, bq, wp, bp = (randn_on(torch, rng, dev, s, 0.05) for s in ((c, c), (c,), (c, c), (c,)))

        def kernel(x):
            return fused_cross_attention_block(x, lns, lnb, wq, bq, k, v, wp, bp, h, 1e-6)

        def plain(x):
            return cross_block_plain(x, lns, lnb, wq, bq, k, v, wp, bp, h, 1e-6)

        lns_b, lnb_b = lns.to(torch.bfloat16), lnb.to(torch.bfloat16)
        kh, vh = k.view(b, ny, h, hd), v.view(b, ny, h, hd)

        def library(x):
            q = F.linear(F.layer_norm(x, (c,), lns_b, lnb_b, 1e-6), wq, bq).view(b, n, h, hd)
            p = torch.softmax(torch.einsum("bqhd,bkhd->bqhk", q, kh) * hd ** -0.5, dim=-1)
            att = torch.einsum("bqhk,bkhd->bqhd", p, vh).reshape(b, n, c)
            return x + F.linear(att, wp, bp)

        if c == 512 and ny in AB_CROSS_NY:
            got = ab_call(torch, lambda: kernel(xs[0]), "B6", ab)
        else:
            n0 = fused_cross_attention_block.launches
            got = kernel(xs[0])
            if fused_cross_attention_block.launches != n0 + 1:
                raise AssertionError(f"B6 C {c} ny {ny}: the call did not launch the kernel")
        want = plain(xs[0])
        err = max_abs(got, want)
        lim = BLOCK_TOL * max(1.0, float(want.float().abs().max()))
        if not err <= lim:
            raise AssertionError(f"B6 [{b},{n},{c}]x{h} ny {ny} max|d| {err} > {lim}")
        launched = kernels_per_call(torch, lambda: kernel(xs[0]))
        if sum(r["calls"] for r in launched) != 1:
            raise AssertionError(f"B6 C {c} ny {ny}: one call ran {launched}, not one kernel")
        m = b * n
        flops = 4 * m * c * c + 4 * m * ny * c
        # the bound's bytes: x in, y out, k and v, the weights, biases, LN
        params = 2 * c * c * 2 + 2 * c * 2 + 2 * c * 4
        bound_bytes = 2 * m * c * 2 + 2 * b * ny * c * 2 + params
        bm, bb = bound(flops, bound_bytes)
        args = [(x,) for x in xs]
        shapes.append(dict(
            shape=[b, n, c, h], ny=ny, max_abs_err=err, limit=lim,
            ms=graph_ms(torch, kernel, args), plain_ms=graph_ms(torch, plain, args, iters=4),
            library_ms=graph_ms(torch, library, args),
            library="F.layer_norm + F.linear + einsum softmax einsum + F.linear + add",
            bound_ms=bm, bound_by=bb, gflop=flops / 1e9, device_kernels_per_call=launched))
        # Counted from the shapes, not measured. The design reads x twice
        # (LN, then the residual, which is likely still in L2; counted here
        # as a second read) and each weight once (every tile streams both
        # weights, 2·C² bf16, so the rest of that traffic is L2's; in a
        # cluster each block streams its half); with LN(x) streamed each
        # block also reads its tile's x again for every 128-column N-slice
        # of the q product (L2's, counted apart); the four-launch design
        # also wrote and read back LN(x), q and att.
        pl = plan(m, c, h)
        tiles = pl["blocks"] // pl["cluster"]
        cs = pl["split_col"]
        slices = -(-cs // 128) + (-(-(c - cs) // 128) if pl["cluster"] == 2 else 0)
        estimate = dict(source="arithmetic from the shapes; no counter read",
                        bound=bound_bytes, design=bound_bytes + m * c * 2,
                        four_launch_design=bound_bytes + 6 * m * c * 2,
                        l2_weight_stream=tiles * 2 * c * c * 2,
                        l2_x_restream=m * c * 2 * slices if pl["ln"] == "streamed" else 0)
        shapes[-1]["plan"] = pl
        say("kernel", name="B6 fused_cross_attention_block", **shapes[-1],
            bytes_estimate=estimate)
    return shapes


def cosine(a, b) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm()))


def block_bwd_phase(torch, dev):
    """B2's backward at B2's shapes: the gradients of the kernel path (B2
    forward; LN and qkv recomputed, B3, B4) against autograd through the
    plain version, from fp32 weights; the backward alone
    (``attention_block_bwd``, which the Function's backward calls) timed by
    replaying it from a CUDA graph; forward and
    backward together timed for the kernel path, the plain version and a
    library composition (LN + linear + SDPA + linear), each graph-replayed."""
    import torch.nn.functional as F
    from countr_tpu_torch.ops.fused_block import (
        attention_block_bwd, attention_block_plain, fused_attention_block,
    )

    rng = np.random.default_rng(9)
    f32, bf = torch.float32, torch.bfloat16
    names = ("x", "ln_scale", "ln_bias", "w_qkv", "b_qkv", "w_proj", "b_proj")
    shapes = []
    for b, n, c, h in ((WINDOWS, 576, 768, 12), (WINDOWS, 576, 512, 16)):
        hd = c // h
        xs = [randn_on(torch, rng, dev, (b, n, c)).requires_grad_(True) for _ in range(2)]
        gs = [randn_on(torch, rng, dev, (b, n, c)) for _ in range(2)]
        w = [randn_on(torch, rng, dev, (c,), 0.05, 1.0, f32),
             randn_on(torch, rng, dev, (c,), 0.05, 0.0, f32)]
        w += [randn_on(torch, rng, dev, s, 0.05, 0.0, f32)
              for s in ((3 * c, c), (3 * c,), (c, c), (c,))]
        leaves = [t.detach().clone().requires_grad_(True) for t in (xs[0], *w)]

        def grads_of(fn):
            for t in leaves:
                t.grad = None
            fn(*leaves, h, 1e-6).backward(gs[0])
            return [t.grad.clone() for t in leaves]

        got = grads_of(fused_attention_block)
        torch.cuda.synchronize()
        want = grads_of(attention_block_plain)
        cos = {k: cosine(a, r) for k, a, r in zip(names, got, want)}
        rel = {k: max_abs(a, r) / float(r.float().abs().max())
               for k, a, r in zip(names, got, want)}
        worst = min(cos, key=cos.get)
        if not cos[worst] >= GRAD_COSINE_MIN:
            raise AssertionError(f"B2 backward [{b},{n},{c}]x{h}: cosine {cos[worst]} ({worst})")

        # the backward alone, every gradient, on the kernel path
        bwd_ms = graph_ms(torch, lambda i: attention_block_bwd(gs[i], xs[i], *w, h, 1e-6, True),
                          [(0,), (1,)])

        for t in w:
            t.requires_grad_(True)

        def fwd_bwd(fn):
            return lambda i: torch.autograd.grad(fn(xs[i], *w, h, 1e-6), (xs[i], *w), gs[i])

        def library(x, lns, lnb, wqkv, bqkv, wproj, bproj, heads, eps):
            xn = F.layer_norm(x, (c,), lns.to(bf), lnb.to(bf), eps)
            q, k, v = F.linear(xn, wqkv.to(bf), bqkv.to(bf)).view(b, n, 3, heads, hd) \
                .permute(2, 0, 3, 1, 4)
            att = F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(b, n, c)
            return x + F.linear(att, wproj.to(bf), bproj.to(bf))

        args = [(0,), (1,)]
        m = b * n
        # The work the gradients need: the qkv recompute, datt, dWproj,
        # dWqkv and dxn (22·M·C²); QK^T once, PV for the attention output
        # (dWproj = g^T att) and B4's dP, dV, dK, dQ (12·B·N²·C). B3's
        # recompute of QK^T beside B4's own is the design's overhead, not
        # counted.
        flops = 22 * m * c * c + 12 * b * n * n * c
        # x and g in, dx out (bf16); fp32 weights in, fp32 gradients out
        moved = 3 * m * c * 2 + (4 * c * c + 4 * c + 2 * c) * 8
        bm, bb = bound(flops, moved)
        shapes.append(dict(
            shape=[b, n, c, h], min_cosine=cos[worst], min_cosine_tensor=worst,
            cosines=cos, max_rel_err=max(rel.values()), rel_errs=rel, ms=bwd_ms,
            fwd_bwd_ms=graph_ms(torch, fwd_bwd(fused_attention_block), args, iters=4),
            plain_fwd_bwd_ms=graph_ms(torch, fwd_bwd(attention_block_plain), args, iters=2),
            library_fwd_bwd_ms=graph_ms(torch, fwd_bwd(library), args, iters=4),
            library="autograd through F.layer_norm + F.linear + SDPA + F.linear, forward and "
                    "backward",
            bound_ms=bm, bound_by=bb, gflop=flops / 1e9))
        say("kernel", name="B2 fused_attention_block backward", **shapes[-1])
    return shapes


@contextlib.contextmanager
def plain_kernels():
    """Swap the model's kernel calls for their plain versions (the
    comparison paths of the forward and train phases only)."""
    from countr_tpu_torch.models import countr, vit
    from countr_tpu_torch.ops.fused_attn import attention_qkv_plain
    from countr_tpu_torch.ops.fused_block import attention_block_plain
    from countr_tpu_torch.ops.fused_gn import group_norm_phase_plain, group_norm_relu_plain
    from countr_tpu_torch.ops.fused_ln import layer_norm_plain

    swaps = ((vit, "fused_layer_norm", layer_norm_plain),
             (vit, "fused_attention_block", attention_block_plain),
             (vit, "fused_attention_qkv", attention_qkv_plain),
             (countr, "fused_group_norm", group_norm_relu_plain),
             (countr, "fused_group_norm_phase", group_norm_phase_plain))
    saved = [getattr(mod, k) for mod, k, _ in swaps]
    for mod, k, fn in swaps:
        setattr(mod, k, fn)
    try:
        yield
    finally:
        for (mod, k, _), fn in zip(swaps, saved):
            setattr(mod, k, fn)


def forward_phase(torch, dev, model):
    rng = np.random.default_rng(2)
    imgs = torch.from_numpy(rng.uniform(0, 1, (WINDOWS, 384, 384, 3)).astype(np.float32)).to(dev)
    boxes = torch.from_numpy(rng.uniform(0, 1, (1, 3, 64, 64, 3)).astype(np.float32)).to(dev)
    with torch.inference_mode():
        y = model.encode_exemplars(boxes.to(torch.bfloat16), 3).expand(WINDOWS, 3, -1)
        got = model.forward_tokens(imgs, y)
        with plain_kernels():
            want = model.forward_tokens(imgs, y)
            plain_ms = time_ms(torch, model.forward_tokens, [(imgs, y)], iters=3, warmup=1)
        ms = time_ms(torch, model.forward_tokens, [(imgs, y)], iters=10, warmup=2)
    if tuple(got.shape) != (WINDOWS, 384, 384) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"forward output bad: {tuple(got.shape)}")
    err = max_abs(got, want)
    lim = FORWARD_REL_TOL * max(1.0, float(want.abs().max()))
    if not err <= lim:
        raise AssertionError(f"forward kernel vs plain max|d| {err} > {lim}")
    say("forward", windows=WINDOWS, max_abs_err=err, limit=lim, ms=ms,
        windows_per_s=WINDOWS / ms * 1e3, plain_ms=plain_ms,
        plain_windows_per_s=WINDOWS / plain_ms * 1e3)


def profile_run(torch, run, steps: int):
    """Device time by kernel over ``steps`` calls of ``run`` (after one
    unprofiled call), from torch.profiler, and the wall ms per call."""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "cuda_time_total", 0.0)
        if getattr(ev, "device_type", None) is not None and "CUDA" not in str(ev.device_type):
            continue
        if dev_us > 0 and ev.count > 0:
            rows.append((ev.key, dev_us / 1e3 / steps, ev.count // steps))
    # device rows only: ops and annotations (aten::..., Optimizer.step#...)
    # carry their kernels' time again
    kernels = [r for r in rows if not r[0].startswith(("aten::", "Optimizer.", "autograd::"))]
    kernels.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in kernels)
    ours = ("_ln_fwd", "_ln_bwd", "_hgn_", "ln_rows_kernel", "gemm_nt_kernel", "cross_block_kernel",
            "attn_resident_kernel", "attn_twopass_kernel", "bwd_stats_kernel", "bwd_main_kernel")
    return dict(
        wall_ms=wall_ms, device_busy_ms=busy, idle_share=max(0.0, 1 - busy / wall_ms),
        port_kernels=[{"kernel": k[:90], "ms": ms, "calls": n} for k, ms, n in kernels
                      if any(t in k for t in ours)],
        collectives=[{"kernel": k[:90], "ms": ms, "calls": n} for k, ms, n in kernels
                     if "nccl" in k.lower()],
        top=[{"kernel": k[:90], "ms": ms, "calls": n} for k, ms, n in kernels[:14]])


def profile_phase(torch, dev, model, steps: int = 3):
    """The forward's device time by kernel and idle share."""
    rng = np.random.default_rng(4)
    imgs = torch.from_numpy(rng.uniform(0, 1, (WINDOWS, 384, 384, 3)).astype(np.float32)).to(dev)
    y = torch.zeros((WINDOWS, 3, model.cfg.decoder_embed_dim), device=dev, dtype=torch.bfloat16)
    with torch.inference_mode():
        say("profile", path="forward", **profile_run(
            torch, lambda: model.forward_tokens(imgs, y), steps))


def synthetic_image(rng, w: int, rect_size):
    """A uint8 [384, w, 3] image of bright blobs on noise, three exemplar
    rects (y1, x1, y2, x2) of ``rect_size`` px and their 64x64 crops."""
    img = rng.integers(0, 60, (384, w, 3)).astype(np.uint8)
    for _ in range(max(8, w // 16)):
        cy, cx = rng.integers(0, 384), rng.integers(0, w)
        r = int(rng.integers(4, 12))
        img[max(cy - r, 0):cy + r, max(cx - r, 0):cx + r] = rng.integers(150, 255, 3)
    rects, boxes = [], []
    for k in range(3):
        s = int(rect_size[k % len(rect_size)])
        y1, x1 = int(rng.integers(0, 384 - s)), int(rng.integers(0, w - s))
        rects.append((y1, x1, y1 + s, x1 + s))
        ys = y1 + (np.arange(64) * s // 64)
        xs = x1 + (np.arange(64) * s // 64)
        boxes.append(img[ys][:, xs])
    return img, np.stack(boxes), rects


def count_phase(torch, model):
    from countr_tpu_torch.engine.inference import CountingEngine

    engine = CountingEngine(model, batch_windows=WINDOWS)
    rng = np.random.default_rng(3)
    cases = [(384, (60, 70, 80)), (640, (60, 70, 80)), (1152, (60, 70, 80)), (768, (6, 7, 8))]
    images = [synthetic_image(rng, w, sizes) for w, sizes in cases]
    reset_counts()
    batches0 = engine.forward_batches
    results = []
    for (img, boxes, rects), (w, _) in zip(images, cases):
        t0 = time.perf_counter()
        r = engine.count(img, boxes, rects)
        ms = (time.perf_counter() - t0) * 1e3
        if not np.isfinite(r.count):
            raise AssertionError(f"count not finite at width {w}: {r.count}")
        results.append(r)
        say("count", width=w, count=r.count, raw_count=r.raw_count, e_cnt=r.e_cnt,
            n_windows=r.n_windows, grid_mode=r.grid_mode, ms=ms)
    launches = launch_counts()
    batches = engine.forward_batches - batches0
    if [r.grid_mode for r in results] != [False, False, False, True]:
        raise AssertionError("grid mode must trigger on the tiny-rect image only")
    if results[-1].n_windows != 36:
        raise AssertionError(f"grid image ran {results[-1].n_windows} windows, not 36")
    if launches != {"B1": 26 * batches, "B2": 18 * batches, "B3": 0, "B4": 0, "B5": 0,
                    "B6": 0, "AdamW": 0, "B3h80": 0, "B4h80": 0, "B1bwd": 0,
                    "HGN": 4 * batches} or batches == 0:
        raise AssertionError(f"launches {launches} for {batches} window batches")
    say("count_launches", window_batches=batches, **launches)
    return launches


# count_batch against count on the same images: each count is a sum over
# ~150k density values of a bf16 forward. The two paths differ in the
# window batches' neighbours and sizes (count pads each image's windows to
# 16, count_batch packs windows of several images into 16 and tails of 4
# or 8, so cuBLAS may pick other GEMM kernels) and in the stitch (float64
# on the host against float32 on the card). Each density value may move by
# bf16 rounding (the forward's own limit is 2.2e-2·max(1, |ref|)), but a
# count averages those moves over the whole map: 1e-2 of it.
COUNT_BATCH_REL_TOL = 1e-2
# count_batch's images: plain FSC147-like widths, three more in 3x3 grid
# mode (exemplars under 10 px), two narrower than a window (one of them in
# grid mode). They pack into two sets of 76 and 49 windows, so the forward
# runs at two buckets: 16 windows, and a tail of 4.
COUNT_BATCH_CASES = (
    [(w, (60, 70, 80)) for w in (384, 448, 512, 512, 576, 640, 688, 768, 1152, 464, 576, 512)]
    + [(w, (6, 7, 8)) for w in (512, 768, 464)] + [(300, (40, 50, 60)), (368, (6, 7, 8))]
    + [(w, (60, 70, 80)) for w in (1024, 416)])


def graph_phase(torch, engine):
    """The window forward replayed from its CUDA graph against the eager
    forward at 16 windows: the same bits on two inputs; graphed and eager
    windows/s (CUDA events, inputs copied into the graph's buffers as
    count_batch does); then a weight change (load_state_dict), after
    which the replay must give the new eager output's bits."""
    model, graphed = engine.model, engine._pipeline.forward
    rng = np.random.default_rng(13)

    def inputs():
        imgs = rng.uniform(0, 1, (WINDOWS, 384, 384, 3)).astype(np.float32)
        boxes = rng.uniform(0, 1, (1, 3, 64, 64, 3)).astype(np.float32)
        with torch.inference_mode():
            y = model.encode_exemplars(torch.from_numpy(boxes).to(engine.device, torch.bfloat16), 3)
        return torch.from_numpy(imgs).to(engine.device), y.expand(WINDOWS, 3, -1).contiguous()

    def same_bits(imgs, y, what):
        with torch.inference_mode():
            want = model.forward_tokens(imgs, y)
            got = graphed(imgs, y).clone()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"graphed forward ({what}) differs from the eager one: "
                                 f"max|d| {max_abs(got, want)}")
        return want

    sets = [inputs() for _ in range(2)]
    t0 = time.perf_counter()
    for imgs, y in sets:
        same_bits(imgs, y, "first capture")
    capture_s = time.perf_counter() - t0
    imgs, y = sets[0]
    graphed.runner.zero_counts()
    with torch.inference_mode():
        g_ms = events_ms(lambda: graphed(imgs, y), iters=10)
        e_ms = events_ms(lambda: model.forward_tokens(imgs, y), iters=10)
    replays = graphed.runner.replays
    per_replay = {k: v / replays for k, v in graphed.runner.launched.items()}
    if per_replay != {"B1": 26, "B2": 18, "B3": 0, "B4": 0, "B5": 0, "B6": 0, "AdamW": 0,
                      "B3h80": 0, "B4h80": 0, "B1bwd": 0, "HGN": 4}:
        raise AssertionError(f"graphed forward: launches per replay {per_replay}")

    saved = {k: v.clone() for k, v in model.state_dict().items()}
    old = same_bits(imgs, y, "before the weight change")
    changed = dict(saved)
    for k in ("blocks.0.attn.qkv.weight", "decoder_blocks.0.norm0.weight", "decode_head3.3.weight"):
        changed[k] = saved[k] * 1.25
    model.load_state_dict(changed)
    new = same_bits(imgs, y, "after load_state_dict")
    if torch.equal(new, old):
        raise AssertionError("the weight change did not change the forward's output")
    model.load_state_dict(saved)
    same_bits(imgs, y, "after the weights were restored")
    say("graphed_forward", windows=WINDOWS, bitwise_equal_to_eager=True, inputs_checked=len(sets),
        first_captures_s=capture_s, graphed_ms=g_ms, eager_ms=e_ms,
        graphed_windows_per_s=WINDOWS / g_ms * 1e3, eager_windows_per_s=WINDOWS / e_ms * 1e3,
        launches_per_replay=per_replay, replays=replays,
        weight_change="recaptured; the replay equals the new eager output bitwise")


def count_batch_phase(torch, engine):
    """CountingEngine.count_batch on the images of COUNT_BATCH_CASES
    (synthetic_image, uint8) through the graphed forward, with the launch
    counters and the graph runner's counts set to 0 just before and read
    just after: no wrapper may launch eagerly, and each window batch (one
    graph replay) must launch B1 26 times and B2 18 times. Then count on
    each image: equal grid_mode and n_windows, counts within
    COUNT_BATCH_REL_TOL. Then profile_run of count_batch and of count over
    the same images."""
    from countr_tpu_torch.engine.device_pipeline import chunk_plan

    rng = np.random.default_rng(14)
    cases = [synthetic_image(rng, w, sizes) for w, sizes in COUNT_BATCH_CASES]
    images, boxes, rects = (list(x) for x in zip(*cases))
    runner = engine._pipeline.forward.runner

    def batch():
        return engine.count_batch(images, boxes, rects, 3, return_density=False)

    batch()  # captures the graphs of this batch's buckets
    torch.cuda.synchronize()
    reset_counts()
    runner.zero_counts()
    t0 = time.perf_counter()
    results = batch()
    batch_ms = (time.perf_counter() - t0) * 1e3
    eager = launch_counts()
    graphed, replays = dict(runner.launched), runner.replays
    sets = engine.plan_batch_sets(images, rects)
    expect_replays = sum(
        len(chunk_plan(sum(engine.windows_per_image(images[i].shape[1], rects[i])[1]
                           for i in idxs), engine.batch_windows)) for idxs in sets)
    want = {"B1": 26 * replays, "B2": 18 * replays, "B3": 0, "B4": 0, "B5": 0, "B6": 0,
            "AdamW": 0, "B3h80": 0, "B4h80": 0, "B1bwd": 0, "HGN": 4 * replays}
    if any(eager.values()) or graphed != want or replays != expect_replays or replays == 0:
        raise AssertionError(f"count_batch: eager launches {eager}, graph launches {graphed} "
                             f"over {replays} replays (expected {expect_replays})")

    t0 = time.perf_counter()
    singles = [engine.count(img, bx, rc) for img, bx, rc in zip(images, boxes, rects)]
    count_ms = (time.perf_counter() - t0) * 1e3
    worst = 0.0
    for i, (b, c) in enumerate(zip(results, singles)):
        if b.grid_mode != c.grid_mode or b.n_windows != c.n_windows:
            raise AssertionError(f"count_batch image {i}: grid {b.grid_mode}/{c.grid_mode}, "
                                 f"windows {b.n_windows}/{c.n_windows}")
        for field in ("count", "raw_count", "e_cnt"):
            x, r = getattr(b, field), getattr(c, field)
            if not np.isfinite(x):
                raise AssertionError(f"count_batch image {i}: {field} {x}")
            rel = abs(x - r) / max(abs(r), 1e-6)
            worst = max(worst, rel)
            if not rel <= COUNT_BATCH_REL_TOL:
                raise AssertionError(f"count_batch image {i}: {field} {x} against count's {r} "
                                     f"(rel {rel} > {COUNT_BATCH_REL_TOL})")
    n_windows = sum(r.n_windows for r in results)
    say("count_batch", images=len(images), grid_images=sum(r.grid_mode for r in results),
        narrow_images=sum(img.shape[1] < 384 for img in images), sets=len(sets),
        windows=n_windows, window_batches=replays, ms=batch_ms,
        images_per_s=len(images) / batch_ms * 1e3, windows_per_s=n_windows / batch_ms * 1e3,
        count_ms=count_ms, count_images_per_s=len(images) / count_ms * 1e3,
        max_rel_diff_vs_count=worst, rel_limit=COUNT_BATCH_REL_TOL,
        graph_launches=graphed, eager_launches=eager, graphs_captured=len(runner))
    say("profile", path="count_batch", images=len(images),
        **profile_run(torch, batch, 2))
    say("profile", path="count (eager, per image)", images=len(images),
        **profile_run(torch, lambda: [engine.count(img, bx, rc) for img, bx, rc
                                      in zip(images, boxes, rects)], 1))
    return graphed


# count_image and count on the same image against count_batch (the CLIs'
# path) is COUNT_BATCH_REL_TOL (above); the mixed modes' fp32 head against
# the same head in float64 on the same token grid: max|d| over max|ref| at
# most 1e-5 (a full-fp32 head reads ~1e-7; one in TF32, 10-bit mantissas,
# ~1e-3).
HEAD_FP64_REL_TOL = 1e-5
CLI_TEST_IMAGES = 24
SERVE_SIZES = "640x480,1280x720"  # original pixels: widths 512 and 672 at H=384
SERVE_TIMED_REQUESTS = 256  # enough samples that p99 is not simply the maximum


def smoke_dir(prefix: str):
    """A temporary directory inside the checkout (``out_*`` is
    gitignored), removed with its contents on exit."""
    import os
    import tempfile

    root = os.path.dirname(os.path.abspath(__file__))
    return tempfile.TemporaryDirectory(prefix=prefix, dir=root)


def per_replay(runner, what: str):
    """(graph launches, eager launches, replays) since the counters were
    set to 0: no eager launch, and B1 26 and B2 18 per replay (the window
    forward)."""
    eager = launch_counts()
    per = {k: v / max(runner.replays, 1) for k, v in runner.launched.items()}
    if any(eager.values()) or runner.replays == 0 or per != {
            "B1": 26, "B2": 18, "B3": 0, "B4": 0, "B5": 0, "B6": 0, "AdamW": 0,
            "B3h80": 0, "B4h80": 0, "B1bwd": 0, "HGN": 4}:
        raise AssertionError(f"{what}: eager launches {eager}, {runner.replays} replays, "
                             f"launches per replay {per}")
    return dict(runner.launched), eager, runner.replays


def zero_counts(runner) -> None:
    reset_counts()
    runner.zero_counts()


def recorded(engine) -> list:
    """Every count_batch call of ``engine`` from now on, as (images, boxes,
    rects, shot, results)."""
    calls = []
    orig = engine.count_batch

    def spy(images, boxes_list, rects_list, shot_num, return_density=True):
        res = orig(images, boxes_list, rects_list, shot_num=shot_num,
                   return_density=return_density)
        calls.append((images, boxes_list, rects_list, shot_num, res))
        return res

    engine.count_batch = spy
    return calls


def rel_diff(x: float, ref: float) -> float:
    return abs(x - ref) / max(abs(ref), 1e-6)


def check_rel(what: str, x: float, ref: float) -> float:
    rel = rel_diff(x, ref)
    if not (np.isfinite(x) and rel <= COUNT_BATCH_REL_TOL):
        raise AssertionError(f"{what}: {x} against {ref} (rel {rel} > {COUNT_BATCH_REL_TOL})")
    return rel


def head_check(torch, engine, windows, y):
    """The fp32 head of a mixed mode against the same head in float64 on
    the same token grid (one window batch): max|d| / max|ref|."""
    model = engine.model
    with torch.inference_mode():
        grid = model.decode_grid(model.encode(windows), y)
        got = model.head(grid)
        ref = model.head(grid, tuple(torch.float64 if d == torch.float32 else d
                                     for d in model.cfg.head_dtypes))
    rel = float((got.double() - ref).abs().max() / ref.abs().max())
    if not rel <= HEAD_FP64_REL_TOL:
        raise AssertionError(f"fp32 head against float64: rel {rel} > {HEAD_FP64_REL_TOL}")
    return rel, grid


def cli_test_phase(torch):
    """countr_tpu_torch.cli.test on a synthetic FSC147 tree of
    CLI_TEST_IMAGES images (scripts/make_synthetic_fsc.py): as a
    subprocess (the real entry point; exit code and stats), then its main
    in-process on the CLI's own engine with its graphs captured first and
    the counters set to 0 (no eager launch; B1 26 and B2 18 per replay),
    each image's count against ``count`` on the same decoded arrays;
    zero-shot; the gate's exit code; the mixed_fast and mixed_bal modes
    (images/s each, the fp32 head against float64); the head's device ms
    in bf16 (subpixel) against fp32. Returns (graph launches, engine)."""
    import os
    import subprocess

    from countr_tpu_torch.cli import common
    from countr_tpu_torch.cli import test as cli

    root = os.path.dirname(os.path.abspath(__file__))
    with smoke_dir("out_smoke_fsc_") as d:
        subprocess.run([sys.executable, os.path.join(root, "scripts", "make_synthetic_fsc.py"),
                        "--out", d, "--n_train", "0", "--n_val", "0",
                        "--n_test", str(CLI_TEST_IMAGES)], check=True, capture_output=True)
        base = ["--data_path", d, "--model", "mae_vit_base6_patch16"]
        t0 = time.perf_counter()
        sub = subprocess.run(
            [sys.executable, "-m", "countr_tpu_torch.cli.test", *base, "--dtype", "bf16",
             "--output_dir", os.path.join(d, "out_sub")],
            cwd=root, capture_output=True, text=True, timeout=600)
        sub_s = time.perf_counter() - t0
        if sub.returncode != 0:
            raise AssertionError(f"cli.test exited {sub.returncode}: {sub.stderr[-2000:]}")
        with open(os.path.join(d, "out_sub", "log.txt")) as f:
            sub_stats = json.loads(f.read().splitlines()[-1])
        with open(os.path.join(d, "out_sub", "results.csv")) as f:
            rows = len(f.read().splitlines()) - 1
        if rows != CLI_TEST_IMAGES or not np.isfinite(sub_stats["MAE"]):
            raise AssertionError(f"cli.test subprocess: {rows} rows, stats {sub_stats}")
        say("cli_test", run="subprocess", seconds=sub_s, images=rows, **sub_stats)

        def args_for(dtype, *extra):
            return cli.get_args([*base, "--dtype", dtype, "--output_dir", os.path.join(d, dtype),
                                 *extra])

        out = {}
        heads = {}
        rng = np.random.default_rng(21)
        windows = torch.from_numpy(rng.uniform(0, 1, (WINDOWS, 384, 384, 3)).astype(np.float32))
        for dtype in ("bf16", "mixed_fast", "mixed_bal"):
            args = args_for(dtype)
            engine = common.build_engine(args, normalization=True)
            t0 = time.perf_counter()
            graphs = engine.capture_forwards((3, 0))
            capture_s = time.perf_counter() - t0
            runner = engine._pipeline.forward.runner
            cli.main(args, engine=engine)  # warms the host path; images/s from the next run
            calls = recorded(engine)
            zero_counts(runner)
            stats = cli.main(args, engine=engine)
            launches, eager, replays = per_replay(runner, f"cli.test --dtype {dtype}")
            worst = 0.0
            for images, boxes, rects, shot, res in calls:
                for k, r in enumerate(res):
                    c = engine.count(images[k], boxes[k], rects[k], shot_num=shot)
                    worst = max(worst, check_rel(f"cli.test {dtype} image {k}", r.count, c.count))
            del engine.count_batch  # the spy
            line = dict(run="in-process", dtype=dtype, images=sum(len(c[4]) for c in calls),
                        window_batches=replays, graphs=graphs, capture_s=capture_s,
                        images_per_s=1.0 / stats["Mean infer time"],
                        max_rel_diff_vs_count=worst, rel_limit=COUNT_BATCH_REL_TOL,
                        graph_launches=launches, eager_launches=eager,
                        MAE=stats["MAE"], RMSE=stats["RMSE"])
            y = torch.zeros((WINDOWS, 3, engine.model.cfg.decoder_embed_dim),
                            device=engine.device, dtype=engine.model.dec_dtype)
            wins = windows.to(engine.device)
            if dtype == "bf16":
                out["launches"], out["engine"] = launches, engine
                zero = cli.main(args_for(dtype, "--box_bound", "0"), engine=engine)
                try:
                    cli.main(args_for(dtype, "--limit", "2", "--expect_mae", "0"), engine=engine)
                except SystemExit as e:
                    gate_code = e.code
                else:
                    gate_code = 0
                if gate_code != 1 or not np.isfinite(zero["MAE"]):
                    raise AssertionError(f"gate exit {gate_code}; zero-shot stats {zero}")
                line.update(zero_shot_MAE=zero["MAE"], gate_exit_code=gate_code)
                with torch.inference_mode():
                    grid = engine.model.decode_grid(engine.model.encode(wins), y)
            else:
                line["head_fp64_rel_diff"], grid = head_check(torch, engine, wins, y)
                line["head_fp64_rel_limit"] = HEAD_FP64_REL_TOL
            with torch.inference_mode():
                heads[dtype] = events_ms(lambda: engine.model.head(grid), iters=10)
            line["head_ms"] = heads[dtype]
            say("cli_test", **line)
            if dtype != "bf16":
                del engine, runner, calls
                torch.cuda.empty_cache()
        aggregate_check(d)
    say("head", windows=WINDOWS, ms=heads, subpixel_bf16_ms=heads["bf16"],
        fp32_ms=heads["mixed_fast"], mixed_bal_ms=heads["mixed_bal"])
    return out["launches"], out["engine"]


def jpeg_bytes(rng, h: int, w: int) -> bytes:
    """A JPEG of bright blobs on noise, h x w."""
    import io

    from PIL import Image

    img = rng.integers(0, 60, (h, w, 3)).astype(np.uint8)
    for _ in range(max(8, w // 16)):
        cy, cx, r = int(rng.integers(0, h)), int(rng.integers(0, w)), int(rng.integers(4, 12))
        img[max(cy - r, 0):cy + r, max(cx - r, 0):cx + r] = rng.integers(150, 255, 3)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG")
    return buf.getvalue()


def serve_phase(torch, engine):
    """countr_tpu_torch.cli.serve in this process on 127.0.0.1, port 0: the
    warm-up at two sizes with the grid path, then 16 POSTs of JPEG bytes
    from 8 client threads (few-shot, zero-shot, one with 6 px boxes that
    must answer grid_mode), with the counters set to 0: no eager launch,
    B1 26 and B2 18 per replay, no graph captured during traffic; each
    count against count_image on the same bytes. Then the timed run:
    SERVE_TIMED_REQUESTS POSTs cycling over the same 16 payloads, each
    count against that payload's first answer; requests/s and p50 / p99 /
    max ms come from it. /healthz and a 404."""
    import io
    import threading
    import urllib.error
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    from countr_tpu_torch.cli import serve as srv
    from countr_tpu_torch.engine.inference import count_image

    args = srv.get_args(["--port", "0"])
    t0 = time.perf_counter()
    graphs = srv.warmup(engine, SERVE_SIZES, args.max_batch_images, grid=True)
    warmup_s = time.perf_counter() - t0
    runner = engine._pipeline.forward.runner
    server = srv.serve(args, engine)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    rng = np.random.default_rng(23)
    few = "?boxes=40,50,110,120;200,100,270,170;400,200,470,270"
    reqs = []
    for i in range(16):
        h, w = ((480, 640), (720, 1280))[i % 2]
        query = few if i % 3 else ""
        if i == 5:
            query = "?boxes=40,50,46,56;200,100,206,106;400,200,406,206"
        reqs.append((jpeg_bytes(rng, h, w), query))

    def post(req):
        data, query = req
        t = time.perf_counter()
        r = urllib.request.Request(f"{url}/count{query}", data=data, method="POST")
        with urllib.request.urlopen(r, timeout=120) as resp:
            body = json.load(resp)
        return body, (time.perf_counter() - t) * 1e3

    try:
        zero_counts(runner)
        before = len(runner)
        with ThreadPoolExecutor(max_workers=8) as pool:
            answers = list(pool.map(post, reqs))
            timed_reqs = [reqs[i % len(reqs)] for i in range(SERVE_TIMED_REQUESTS)]
            t0 = time.perf_counter()
            timed = list(pool.map(post, timed_reqs))
            wall_s = time.perf_counter() - t0
        if len(runner) != before:
            raise AssertionError(f"serve: {len(runner) - before} graphs captured during traffic")
        launches, eager, replays = per_replay(runner, "serve")
        with urllib.request.urlopen(f"{url}/healthz", timeout=30) as resp:
            health = json.load(resp)
        try:
            urllib.request.urlopen(f"{url}/nope", timeout=30)
            code = 200
        except urllib.error.HTTPError as e:
            code = e.code
        if health != {"ok": True} or code != 404:
            raise AssertionError(f"serve: /healthz {health}, /nope {code}")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(30)
    worst = 0.0
    for i, ((data, query), (body, _)) in enumerate(zip(reqs, answers)):
        boxes = [[float(v) for v in p.split(",")] for p in query[7:].split(";")] if query else []
        want = count_image(engine, Image.open(io.BytesIO(data)), boxes)
        if body["grid_mode"] != want.grid_mode or body["grid_mode"] != (i == 5):
            raise AssertionError(f"serve request {i}: grid_mode {body['grid_mode']}")
        worst = max(worst, check_rel(f"serve request {i}", body["count"], want.count))
    worst_timed = 0.0
    for i, (body, _) in enumerate(timed):
        first = answers[i % len(reqs)][0]
        if body["grid_mode"] != first["grid_mode"]:
            raise AssertionError(f"serve timed request {i}: grid_mode {body['grid_mode']}")
        worst_timed = max(worst_timed, check_rel(f"serve timed request {i}", body["count"],
                                                 first["count"]))
    ms = sorted(m for _, m in timed)
    say("serve", requests=len(reqs), timed_requests=len(timed), clients=8, warmup_s=warmup_s,
        graphs=graphs, graphs_captured_during_traffic=0, wall_s=wall_s,
        requests_per_s=len(timed) / wall_s, p50_ms=ms[len(ms) // 2],
        p99_ms=ms[int(0.99 * len(ms))], max_ms=ms[-1],
        max_rel_diff_timed_vs_first=worst_timed,
        window_batches=replays, graph_launches=launches, eager_launches=eager,
        max_rel_diff_vs_count_image=worst, rel_limit=COUNT_BATCH_REL_TOL,
        healthz=True, not_found=404)
    return launches


def demo_phase(engine):
    """countr_tpu_torch.cli.demo on a directory of 3 JPEGs with 3 exemplar
    boxes: each panel written, each count against count_image."""
    import os

    from countr_tpu_torch.cli import demo
    from countr_tpu_torch.engine.inference import count_image

    rng = np.random.default_rng(25)
    boxes = "40,50,110,120;200,100,270,170;400,200,470,270"
    with smoke_dir("out_smoke_demo_") as d:
        src = os.path.join(d, "in")
        os.makedirs(src)
        for i, (h, w) in enumerate(((480, 640), (720, 1280), (600, 800))):
            with open(os.path.join(src, f"img_{i}.jpg"), "wb") as f:
                f.write(jpeg_bytes(rng, h, w))
        args = demo.get_args(["--input_path", src, "--output_path", os.path.join(d, "out"),
                              "--boxes", boxes])
        t0 = time.perf_counter()
        res = demo.main(args, engine=engine)
        demo_ms = (time.perf_counter() - t0) * 1e3
        worst = 0.0
        for name, r in res:
            panel = os.path.join(d, "out", f"{name.rsplit('.', 1)[0]}__{round(r.count)}.png")
            if not os.path.exists(panel):
                raise AssertionError(f"demo: no panel {panel}")
            want = count_image(engine, os.path.join(src, name), demo.parse_boxes(boxes))
            worst = max(worst, check_rel(f"demo {name}", r.count, want.count))
    if len(res) != 3:
        raise AssertionError(f"demo counted {len(res)} images, not 3")
    say("demo", images=len(res), ms=demo_ms, counts=[r.count for _, r in res],
        max_rel_diff_vs_count_image=worst, rel_limit=COUNT_BATCH_REL_TOL)


def carpk_tree(d: str, n: int, seed: int) -> None:
    """A local CARPK tree in ``d``: n PNGs at 720x1280 (Images/) of bright
    boxes on dark noise, and their boxes (Annotations/*.txt)."""
    import os

    from PIL import Image

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(d, "Images"))
    os.makedirs(os.path.join(d, "Annotations"))
    for i in range(n):
        img = rng.integers(0, 80, (720, 1280, 3)).astype(np.uint8)
        lines = []
        for _ in range(int(rng.integers(30, 80))):
            x, y = int(rng.integers(0, 1240)), int(rng.integers(0, 690))
            bw, bh = (int(v) for v in rng.integers(24, 40, 2))
            img[y:y + bh, x:x + bw] = rng.integers(150, 255, 3)
            lines.append(f"{x} {y} {x + bw} {y + bh} 1")
        Image.fromarray(img).save(os.path.join(d, "Images", f"car_{i}.png"))
        with open(os.path.join(d, "Annotations", f"car_{i}.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")


def carpk_phase(torch, cli_engine):
    """countr_tpu_torch.cli.test_carpk on a local CARPK tree of 4 PNGs at
    720x1280 (Images/, Annotations/*.txt): without TTN, 2 shots, the
    postprocess; graphs captured first and the counters set to 0, B1 26
    and B2 18 per replay and no eager launch; the MAE finite."""
    import os

    from countr_tpu_torch.cli import test_carpk
    from countr_tpu_torch.engine.inference import CountingEngine

    with smoke_dir("out_smoke_carpk_") as d:
        carpk_tree(d, 4, seed=27)
        args = test_carpk.get_args(["--carpk_root", d, "--output_dir", os.path.join(d, "out"),
                                    "--batch_windows", str(WINDOWS)])
        engine = CountingEngine(cli_engine.model, batch_windows=WINDOWS, normalization=False,
                                device=cli_engine.device)
        engine.capture_forwards((2,))
        runner = engine._pipeline.forward.runner
        zero_counts(runner)
        t0 = time.perf_counter()
        stats = test_carpk.main(args, engine=engine)
        ms = (time.perf_counter() - t0) * 1e3
        launches, eager, replays = per_replay(runner, "cli.test_carpk")
    if not (np.isfinite(stats["MAE"]) and np.isfinite(stats["RMSE"])):
        raise AssertionError(f"test_carpk stats {stats}")
    say("test_carpk", images=4, ms=ms, window_batches=replays, graph_launches=launches,
        eager_launches=eager, MAE=stats["MAE"], RMSE=stats["RMSE"])
    return launches


def train_batch(rng, b: int):
    """A synthetic finetune batch of numpy arrays: [b, 384, 384, 3] images
    of bright blobs on noise in [0, 1], their densities (a unit dot at
    each blob's centre, Gaussian-smoothed with sigma 1 as the reference's
    gaussian_filter, times DENSITY_SCALE 60) and three 64x64 exemplar
    crops of blobs."""
    imgs = rng.uniform(0, 0.25, (b, 384, 384, 3)).astype(np.float32)
    dots = np.zeros((b, 384, 384), np.float32)
    boxes = np.zeros((b, 3, 64, 64, 3), np.float32)
    for i in range(b):
        n = int(rng.integers(20, 60))
        cy, cx = rng.integers(12, 372, n), rng.integers(12, 372, n)
        for k in range(n):
            r = int(rng.integers(4, 10))
            imgs[i, cy[k] - r:cy[k] + r, cx[k] - r:cx[k] + r] = rng.uniform(0.6, 1.0, 3)
            dots[i, cy[k], cx[k]] = 1.0
        for k in range(3):
            y0, x0 = max(cy[k] - 32, 0), max(cx[k] - 32, 0)
            y0, x0 = min(y0, 320), min(x0, 320)
            boxes[i, k] = imgs[i, y0:y0 + 64, x0:x0 + 64]
    radius = 4  # scipy's truncate 4.0 at sigma 1
    ker = np.exp(-0.5 * np.arange(-radius, radius + 1) ** 2)
    ker /= ker.sum()
    pad = np.pad(dots, ((0, 0), (radius, radius), (radius, radius)), mode="symmetric")
    rows = sum(ker[j] * pad[:, j:j + 384] for j in range(2 * radius + 1))
    dens = sum(ker[j] * rows[:, :, j:j + 384] for j in range(2 * radius + 1))
    return {"image": imgs, "gt_density": (dens * 60.0).astype(np.float32), "boxes": boxes}


def launch_counts():
    from countr_tpu_torch.ops.launches import launch_counts as counts

    return counts()


def reset_counts():
    from countr_tpu_torch.ops.launches import reset_launch_counts

    reset_launch_counts()


def decoders() -> dict:
    """Which image decoders import here (the CLIs' input path): the
    package's version (True where it has none), or the error. With
    torchvision, a JPEG that it encodes is decoded on the CPU and on the
    card."""
    import importlib

    out = {}
    for name in ("torchvision", "torchvision.io", "PIL.Image", "cv2"):
        try:
            importlib.import_module(name)
            out[name] = getattr(sys.modules[name.split(".")[0]], "__version__", True)
        except Exception as e:  # ImportError, or an install that fails at import
            out[name] = f"{type(e).__name__}: {e}"[:160]
    if not isinstance(out["torchvision.io"], str):
        try:
            import torch
            from torchvision.io import decode_jpeg, encode_jpeg

            img = torch.full((3, 16, 16), 128, dtype=torch.uint8)
            data = encode_jpeg(img)
            out["decode_jpeg_cpu"] = tuple(decode_jpeg(data).shape) == (3, 16, 16)
            out["decode_jpeg_cuda"] = tuple(decode_jpeg(data, device="cuda").shape) == (3, 16, 16)
        except Exception as e:
            out["decode_jpeg"] = f"{type(e).__name__}: {e}"[:160]
    return out


def step_events(torch, step, args, before=None):
    """``step(*args)`` between CUDA events (after ``before()``, not
    timed); the host then reads the loss, so each step starts on an idle
    card. Returns (loss, ms)."""
    if before is not None:
        before()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    m = step(*args)
    end.record()
    loss = float(m["loss"])
    return loss, start.elapsed_time(end)


def run_steps(torch, step, calls, before=None):
    """Each call's loss and ms (``step_events``), the device memory
    allocated before the run (the weights and optimizer state of every
    model alive) and the most the steps allocated above it (an eager
    step's activations; a replay's are in its graph's pool)."""
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    losses, ms = zip(*(step_events(torch, step, args, before) for args in calls))
    return dict(losses=list(losses), step_ms=list(ms), resident_gb=resident / 2 ** 30,
                step_peak_gb=(torch.cuda.max_memory_allocated() - resident) / 2 ** 30)


def captured(torch, capture):
    """Run ``capture()`` (graph captures); returns its seconds and the
    device memory it left reserved, in GB: the graphs' pool."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    capture()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return seconds, (torch.cuda.memory_reserved() - before) / 2 ** 30


def compare_states(torch, what: str, graphed, eager, losses_g, losses_e) -> dict:
    """The graphed run against the eager one from the same start: step 1's
    loss equal to the bit, and every loss, parameter and Adam tensor
    within GRAPHED_TOL (0: the same bits). Raises otherwise."""
    loss_d = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(losses_g, losses_e))
    params = max(max_abs(p.detach(), q.detach())
                 for p, q in zip(graphed.model.parameters(), eager.model.parameters()))
    moments = max(max_abs(x, y) for p, q in zip(graphed.params, eager.params)
                  for x, y in zip(graphed.moments(p), eager.moments(q)))
    out = dict(first_loss_bitwise=losses_g[0] == losses_e[0], max_loss_rel_diff=loss_d,
               max_param_abs_diff=params, max_moment_abs_diff=moments, limit=GRAPHED_TOL)
    if not out["first_loss_bitwise"] or max(loss_d, params, moments) > GRAPHED_TOL:
        raise AssertionError(f"{what}: graphed against eager {out}")
    return out


def graph_launches(runner, per_step, steps: int, what: str) -> dict:
    """The runner's launches over ``steps`` replays against ``per_step``,
    and no wrapper launching outside the graphs. Raises otherwise."""
    eager = launch_counts()
    if any(eager.values()) or runner.replays != steps \
            or runner.launched != {k: v * steps for k, v in per_step.items()}:
        raise AssertionError(f"{what}: {runner.replays} replays launched {runner.launched}, "
                             f"eager launches {eager}; expected {per_step} per replay")
    return {k: v / steps for k, v in runner.launched.items()}


def finetune_setup(torch, dev, seed: int = 0, accum: int = 1, graphed=None, mesh=None, **over):
    """(state, step, mask generator, cfg) of the bf16 training build at
    full width, random weights from ``seed``; a data-parallel rank's with
    ``mesh``."""
    from countr_tpu_torch.config import TrainConfig, fast_mode_overrides
    from countr_tpu_torch.engine import train as engine
    from countr_tpu_torch.models import build_countr

    model = build_countr("mae_vit_base6_patch16", seed=seed, training=True,
                         **{**fast_mode_overrides("bf16", training=True), **over})
    cfg = TrainConfig(batch_size=TRAIN_BATCH, lr=TRAIN_LR, min_lr=TRAIN_LR, warmup_epochs=0,
                      accum_iter=accum)
    state = engine.init_train_state(model, cfg, steps_per_epoch=100, world_batch=TRAIN_BATCH,
                                    mesh=mesh)
    if {state.schedule(i) for i in range(8)} != {TRAIN_LR}:
        raise AssertionError("the train phase's learning rate is not constant")
    gen = torch.Generator(device=dev)
    return state, engine.make_finetune_step(state, cfg, gen, graphed=graphed), gen, cfg


def train_phase(torch, dev):
    """The finetune step of the bf16 training build at full width: one
    step against the plain kernels; 8 steps replayed from CUDA graphs (the
    main path) against 8 eager steps from the same start; the eval step,
    graphed against eager before and after them; one unfrozen step.
    Returns (launches, the graphed run's losses and final weights)."""
    from countr_tpu_torch.engine import train as engine

    state, step, gen, cfg = finetune_setup(torch, dev)
    model = state.model
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in train_batch(np.random.default_rng(6), TRAIN_BATCH).items()}
    labels = engine.frozen_labels(model)
    trainable = [n for n, _ in model.named_parameters() if labels[n] == "train"]

    # One step's loss and gradients, kernels against plain versions, on
    # the same weights, batch and mask. The exemplar convs' biases and the
    # cross-attention key biases have an exact gradient of 0 (an
    # affine-free InstanceNorm, a softmax follow) and hold fp32 noise.
    mask = engine.loss_mask(384, cfg.loss_mask_p, torch.Generator(device=dev).manual_seed(1))

    def loss_and_grads():
        state.zero_grads()
        loss, _ = engine.finetune_loss(model, batch["image"], batch["gt_density"],
                                       batch["boxes"], 3, mask)
        loss.backward()
        params = dict(model.named_parameters())
        return loss.item(), {n: params[n].grad.clone() for n in trainable}

    loss_k, grads_k = loss_and_grads()
    with plain_kernels():
        loss_p, grads_p = loss_and_grads()
    state.zero_grads()
    cosines = {}
    for n in trainable:
        a, b = grads_k[n], grads_p[n]
        if n.startswith("decoder_proj") and n.endswith(".bias") or n.endswith("attn.wk.bias"):
            continue
        if n == "shot_token":  # no gradient at shot 3: zeros on both paths
            if a.any() or b.any():
                raise AssertionError("train: the shot token has a gradient at shot 3")
            continue
        cosines[n] = cosine(a, b)
    rel = abs(loss_k - loss_p) / abs(loss_p)
    worst = min(cosines, key=cosines.get)
    if not rel <= TRAIN_LOSS_REL_TOL or not cosines[worst] >= GRAD_COSINE_MIN:
        raise AssertionError(f"train: kernel vs plain loss rel {rel}, min cosine "
                             f"{cosines[worst]} ({worst})")
    say("train_vs_plain", loss=loss_k, plain_loss=loss_p, loss_rel_diff=rel,
        loss_rel_limit=TRAIN_LOSS_REL_TOL, min_grad_cosine=cosines[worst],
        min_cosine_tensor=worst, cosine_limit=GRAD_COSINE_MIN, tensors_compared=len(cosines))
    del grads_k, grads_p

    # The eager twin, from the same seed; the eval step on the graphed
    # model, graphed (captured now, at the first weights) and eager.
    twin, twin_step, twin_gen, _ = finetune_setup(torch, dev, graphed=False)
    eval_batch = {**batch, "valid": torch.ones(TRAIN_BATCH, device=dev)}
    eval_g, eval_e = engine.make_eval_step(model), engine.make_eval_step(model, graphed=False)

    def eval_check(when: str) -> dict:
        want = eval_e(eval_batch, 3)
        reset_counts()
        eval_g.runner.zero_counts()
        got = eval_g(eval_batch, 3)
        if not all(torch.equal(got[k], want[k]) for k in want):
            raise AssertionError(f"eval ({when}): graphed {got} against eager {want}")
        return {k: float(v) for k, v in got.items()}

    eval_check("first capture")
    eval_before = eval_check("before training")
    eval_launches = graph_launches(eval_g.runner, {"B1": 44, "B2": 0, "B3": 18, "B4": 0,
                                                   "B5": 0, "B6": 0, "AdamW": 0,
                                                   "B3h80": 0, "B4h80": 0, "B1bwd": 0,
                                                   "HGN": 4}, 1,
                                   "eval")

    # The path itself: 8 steps on the repeated batch and loss mask, shots
    # 3, 2, 1, 0 twice; the graphs of the four shots captured first.
    shots = [3, 2, 1, 0] * 2
    capture_s, pool_gb = captured(torch, lambda: [step.capture(batch, s) for s in (3, 2, 1, 0)])
    reset_counts()
    eager = run_steps(torch, twin_step, [(batch, s) for s in shots],
                      lambda: twin_gen.manual_seed(2))
    eager_launches = launch_counts()
    reset_counts()
    step.runner.zero_counts()
    graphed = run_steps(torch, step, [(batch, s) for s in shots], lambda: gen.manual_seed(2))
    per_step = {"B1": 44, "B2": 0, "B3": 18, "B4": 6, "B5": 0, "B6": 0, "AdamW": 1,
                "B3h80": 0, "B4h80": 0, "B1bwd": 19, "HGN": 0}
    per_replay = graph_launches(step.runner, per_step, len(shots), "train")
    if eager_launches != {k: v * len(shots) for k, v in per_step.items()}:
        raise AssertionError(f"train (eager): launches {eager_launches} over {len(shots)} "
                             f"steps, expected {per_step} per step")
    launches = dict(step.runner.launched)
    same = compare_states(torch, "train", state, twin, graphed["losses"], eager["losses"])
    losses = graphed["losses"]
    ref = dict(losses=losses, weights={k: v.cpu() for k, v in model.state_dict().items()})
    if not all(np.isfinite(losses)) or not losses[4] < losses[0]:
        raise AssertionError(f"train: shot-3 loss did not fall: {losses}")
    eval_after = eval_check("after 8 steps")
    if eval_after == eval_before:
        raise AssertionError("eval: the 8 steps did not change the eval metrics")
    ms_g, ms_e = float(np.mean(graphed["step_ms"][1:])), float(np.mean(eager["step_ms"][1:]))
    say("train", steps=len(shots), shots=shots, lr=TRAIN_LR, graphs=len(step.runner),
        capture_s=capture_s, graph_pool_gb=pool_gb, ms_per_step=ms_g, images_per_s=TRAIN_BATCH / ms_g * 1e3,
        eager_ms_per_step=ms_e, eager_images_per_s=TRAIN_BATCH / ms_e * 1e3,
        graphed=graphed, eager=eager, launches=launches, launches_per_replay=per_replay,
        eager_launches=eager_launches, graphed_vs_eager=same)
    say("eval", shot=3, batch=TRAIN_BATCH, graphed_equals_eager=True,
        before_training=eval_before, after_8_steps=eval_after, launches_per_replay=eval_launches,
        ms=events_ms(lambda: eval_g(eval_batch, 3), iters=10),
        eager_ms=events_ms(lambda: eval_e(eval_batch, 3), iters=10))
    say("profile", path="train step (graphed)", **profile_run(torch, lambda: step(batch, 3), 2))
    say("profile", path="train step (eager)",
        **profile_run(torch, lambda: twin_step(batch, 3), 2))
    del state, step, twin, twin_step, model, eval_g, eval_e
    torch.cuda.empty_cache()

    # One step with the encoder trained too: B4 runs in all 18 blocks.
    state, step, gen, _ = finetune_setup(torch, dev, freeze_encoder=False)
    gen.manual_seed(3)
    step.capture(batch, 3)
    reset_counts()
    step.runner.zero_counts()
    loss, ms = step_events(torch, step, (batch, 3))
    unfrozen = graph_launches(step.runner, {"B1": 44, "B2": 0, "B3": 18, "B4": 18, "B5": 0,
                                            "B6": 0, "AdamW": 1, "B3h80": 0, "B4h80": 0,
                                            "B1bwd": 44, "HGN": 0},
                              1, "train, encoder unfrozen")
    if not np.isfinite(loss):
        raise AssertionError(f"train, encoder unfrozen: loss {loss}")
    say("train_unfrozen", loss=loss, ms=ms, launches_per_replay=unfrozen)
    del state, step
    torch.cuda.empty_cache()
    return launches, ref


def accum_phase(torch, dev):
    """Finetune at accum_iter 2 at full width: 4 mini-steps (shots 3, 3,
    1, 1) replayed from the accumulate and update graphs against the same
    eager mini-steps from the same start; the weights keep their bits on
    the mini-steps that accumulate."""
    state, step, gen, _ = finetune_setup(torch, dev, accum=2)
    twin, twin_step, twin_gen, _ = finetune_setup(torch, dev, accum=2, graphed=False)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in train_batch(np.random.default_rng(8), TRAIN_BATCH).items()}
    shots = [3, 3, 1, 1]
    for s in (3, 1):
        step.capture(batch, s)
    reset_counts()
    step.runner.zero_counts()
    losses = {"graphed": [], "eager": []}
    kept = []
    for i, s in enumerate(shots):
        before = [p.clone() for p in state.params]
        for kind, st, fn, g in (("graphed", state, step, gen), ("eager", twin, twin_step,
                                                                  twin_gen)):
            g.manual_seed(20 + i)
            losses[kind].append(float(fn(batch, s)["loss"]))
        kept.append(all(torch.equal(p, q) for p, q in zip(state.params, before)))
        del before
    if kept != [True, False, True, False] or (state.step, state.updates) != (4, 2):
        raise AssertionError(f"accum: weights unchanged per mini-step {kept}, "
                             f"step/updates {state.step}/{state.updates}")
    # the eager twin's launches are all the wrappers counted: the graphed
    # mini-steps launched nothing outside their graphs
    per_step = {"B1": 44, "B2": 0, "B3": 18, "B4": 6, "B5": 0, "B6": 0, "AdamW": 0,
                "B3h80": 0, "B4h80": 0, "B1bwd": 19, "HGN": 0}
    want = {**{k: v * len(shots) for k, v in per_step.items()}, "AdamW": len(shots) // 2,
            "B3h80": 0, "B4h80": 0}
    if launch_counts() != want or step.runner.launched != want \
            or step.runner.replays != len(shots):
        raise AssertionError(f"accum: wrappers {launch_counts()}, graphs {step.runner.launched} "
                             f"over {step.runner.replays} replays; {per_step} per step, an "
                             "AdamW launch per update")
    per_replay = {k: v / len(shots) for k, v in step.runner.launched.items()}
    same = compare_states(torch, "accum", state, twin, losses["graphed"], losses["eager"])
    say("accum", accum_iter=2, shots=shots, graphs=len(step.runner), losses=losses,
        weights_unchanged=kept, updates=state.updates, launches_per_replay=per_replay,
        graphed_vs_eager=same)
    del state, step, twin, twin_step
    torch.cuda.empty_cache()


def checkpoint_phase(torch, dev, ref):
    """Save and resume at full width: 4 graphed steps from seed 0 (the
    train phase's first 4), save; a fresh state from another seed, its
    graphs captured, restored in place; 4 more graphed steps. Every loss
    and the final weights equal the train phase's uninterrupted 8."""
    import os
    import tempfile

    from countr_tpu_torch.engine import checkpoint as ckpt

    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in train_batch(np.random.default_rng(6), TRAIN_BATCH).items()}
    shots = [3, 2, 1, 0] * 2
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(prefix="out_ckpt_", dir=root) as d:
        state, step, gen, _ = finetune_setup(torch, dev)
        losses = [step_events(torch, step, (batch, s), lambda: gen.manual_seed(2))[0]
                  for s in shots[:4]]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = ckpt.save_checkpoint(d, 4, state, keep=1)
        save_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        del state, step
        torch.cuda.empty_cache()

        state, step, gen, _ = finetune_setup(torch, dev, seed=1)
        for s in (3, 2, 1, 0):
            step.capture(batch, s)
        ptrs = [t.data_ptr() for t in state.mutable()]
        t0 = time.perf_counter()
        restored = ckpt.restore_checkpoint(d, state)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        if restored != 4 or [t.data_ptr() for t in state.mutable()] != ptrs:
            raise AssertionError("checkpoint: the restore replaced live tensors")
        losses += [step_events(torch, step, (batch, s), lambda: gen.manual_seed(2))[0]
                   for s in shots[4:]]
    weights = max(max_abs(v.cpu(), ref["weights"][k])
                  for k, v in state.model.state_dict().items())
    loss_d = max(abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"]))
    if max(weights, loss_d) > GRAPHED_TOL or len(step.runner) != 4:
        raise AssertionError(f"checkpoint: resumed losses {losses} against {ref['losses']}, "
                             f"weights max|d| {weights}, {len(step.runner)} graphs")
    say("checkpoint", steps=len(shots), saved_at=4, file_mb=size / 2 ** 20, save_s=save_s,
        restore_s=restore_s, losses=losses, max_loss_rel_diff=loss_d,
        max_weight_abs_diff=weights, limit=GRAPHED_TOL, graphs_recaptured=0)
    del state, step
    torch.cuda.empty_cache()


# Launches per MAE pretrain step (12 encoder and 8 decoder blocks): the
# CLI's build runs B1 for both LayerNorms of every block and the two final
# norms and B3/B4 in every block; with B2 on, B2 takes each block's
# attention branch (its LayerNorm too), and its backward runs B3 (the
# recompute) and B4.
PRETRAIN_LAUNCHES = {
    False: {"B1": 42, "B2": 0, "B3": 20, "B4": 20, "B5": 0, "B6": 0, "AdamW": 1,
            "B3h80": 0, "B4h80": 0, "B1bwd": 42, "HGN": 0},
    True: {"B1": 22, "B2": 20, "B3": 20, "B4": 20, "B5": 0, "B6": 0, "AdamW": 1,
           "B3h80": 0, "B4h80": 0, "B1bwd": 22, "HGN": 0},
}


def pretrain_setup(torch, dev, fused: bool, graphed=None, mesh=None):
    from countr_tpu_torch.config import TrainConfig
    from countr_tpu_torch.engine import train as engine
    from countr_tpu_torch.models import build_mae

    model = build_mae("mae_vit_base_patch16", seed=0, fused_attn_block=fused, device=dev)
    cfg = TrainConfig(batch_size=PRETRAIN_BATCH, lr=PRETRAIN_LR, min_lr=PRETRAIN_LR,
                      warmup_epochs=0)
    state = engine.init_train_state(model, cfg, steps_per_epoch=100, world_batch=PRETRAIN_BATCH,
                                    mesh=mesh)
    if {state.schedule(i) for i in range(8)} != {PRETRAIN_LR}:
        raise AssertionError("the pretrain phase's learning rate is not constant")
    gen = torch.Generator(device=dev)
    return state, engine.make_pretrain_step(state, cfg, gen, graphed=graphed), gen


def pretrain_phase(torch, dev, fused: bool):
    """The MAE pretrain step of one build at full width: the pretrain
    CLI's (``fused`` False: B1, B3/B4) or the config's default (``fused``
    True: B2 with its backward through B3/B4, B1). One step against the
    plain kernels; 8 steps replayed from the CUDA graph (the main path)
    against 8 eager steps from the same start, the masking noise drawn
    inside each step from a generator reseeded before it."""
    build = "config_default" if fused else "cli"
    state, step, gen = pretrain_setup(torch, dev, fused)
    model = state.model
    imgs = torch.from_numpy(train_batch(np.random.default_rng(10), PRETRAIN_BATCH)["image"]).to(dev)
    noise = torch.rand((PRETRAIN_BATCH, model.cfg.num_patches),
                       generator=torch.Generator(device=dev).manual_seed(11), device=dev)

    # One step's loss and gradients, kernels against plain versions, on the
    # same weights, images and noise. The key biases (the middle third of
    # every qkv bias) have an exact gradient of 0 and hold fp32 noise.
    def loss_and_grads():
        state.zero_grads()
        loss, pred, _ = model(imgs, noise=noise)
        loss.backward()
        return loss.item(), pred.shape, {n: p.grad.clone() for n, p in model.named_parameters()}

    loss_k, pred_shape, grads_k = loss_and_grads()
    with plain_kernels():
        loss_p, _, grads_p = loss_and_grads()
    state.zero_grads()
    cosines = {}
    for n, a in grads_k.items():
        b = grads_p[n]
        if n.endswith("attn.qkv.bias"):
            c = a.numel() // 3
            a, b = torch.cat([a[:c], a[2 * c:]]), torch.cat([b[:c], b[2 * c:]])
        cosines[n] = cosine(a, b)
    rel = abs(loss_k - loss_p) / abs(loss_p)
    worst = min(cosines, key=cosines.get)
    if tuple(pred_shape) != (PRETRAIN_BATCH, 576, 768) or not np.isfinite(loss_k):
        raise AssertionError(f"pretrain ({build}): pred {tuple(pred_shape)}, loss {loss_k}")
    if not rel <= TRAIN_LOSS_REL_TOL or not cosines[worst] >= GRAD_COSINE_MIN:
        raise AssertionError(f"pretrain ({build}): kernel vs plain loss rel {rel}, min cosine "
                             f"{cosines[worst]} ({worst})")
    say("pretrain_vs_plain", build=build, loss=loss_k, plain_loss=loss_p, loss_rel_diff=rel,
        loss_rel_limit=TRAIN_LOSS_REL_TOL, min_grad_cosine=cosines[worst],
        min_cosine_tensor=worst, cosine_limit=GRAD_COSINE_MIN, tensors_compared=len(cosines))
    del grads_k, grads_p

    # The path itself: 8 steps on the repeated images and noise.
    twin, twin_step, twin_gen = pretrain_setup(torch, dev, fused, graphed=False)
    capture_s, pool_gb = captured(torch, lambda: step.capture(imgs))
    reset_counts()
    eager = run_steps(torch, twin_step, [(imgs,)] * 8, lambda: twin_gen.manual_seed(11))
    eager_launches = launch_counts()
    reset_counts()
    step.runner.zero_counts()
    graphed = run_steps(torch, step, [(imgs,)] * 8, lambda: gen.manual_seed(11))
    per_step = PRETRAIN_LAUNCHES[fused]
    per_replay = graph_launches(step.runner, per_step, 8, f"pretrain ({build})")
    if eager_launches != {k: v * 8 for k, v in per_step.items()}:
        raise AssertionError(f"pretrain ({build}, eager): launches {eager_launches} over 8 "
                             f"steps, expected {per_step} per step")
    launches = dict(step.runner.launched)
    same = compare_states(torch, f"pretrain ({build})", state, twin, graphed["losses"],
                          eager["losses"])
    losses = graphed["losses"]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"pretrain ({build}): losses {losses}")
    ms_g, ms_e = float(np.mean(graphed["step_ms"][1:])), float(np.mean(eager["step_ms"][1:]))
    say("pretrain", build=build, steps=8, lr=PRETRAIN_LR, capture_s=capture_s,
        graph_pool_gb=pool_gb, ms_per_step=ms_g, images_per_s=PRETRAIN_BATCH / ms_g * 1e3, eager_ms_per_step=ms_e,
        eager_images_per_s=PRETRAIN_BATCH / ms_e * 1e3, graphed=graphed, eager=eager,
        launches=launches, launches_per_replay=per_replay, eager_launches=eager_launches,
        graphed_vs_eager=same)
    say("profile", path=f"pretrain step ({build}, graphed)",
        **profile_run(torch, lambda: step(imgs), 2))
    say("profile", path=f"pretrain step ({build}, eager)",
        **profile_run(torch, lambda: twin_step(imgs), 2))
    del state, step, twin, twin_step, model
    torch.cuda.empty_cache()
    return launches



# The fused AdamW update against its plain version over three updates
# from the same state: the same operations in the same order, but the
# kernel's fp32 bias corrections (pow on the card) and its contractions
# (p - s * q in one fma) round apart from torch's: each parameter within
# ADAMW_TOL of |ref| + lr * updates, each moment within ADAMW_TOL of the
# tensor's largest |ref|.
ADAMW_TOL = 1e-6


def adamw_update(state, fn) -> None:
    """One update of ``state``'s AdamW by ``fn`` (``fused_adamw`` or
    ``adamw_plain``) from its flat gradient, at the group's settings."""
    group = state.optimizer.param_groups[0]
    beta1, beta2 = group["betas"]
    fn(state.segments, state.flat, state.exp_avg, state.exp_avg_sq, state.adam_step,
       group["lr"], beta1=beta1, beta2=beta2, eps=group["eps"],
       weight_decay=group["weight_decay"])


def adamw_gaps(torch, what: str, kernel, plain, lr_updates: float):
    """The kernel's parameters and moments (``kernel``, a state or any
    object with ``segments``, ``exp_avg`` and ``exp_avg_sq``) against the
    plain version's (``plain``) after the same updates: each parameter
    within ADAMW_TOL of |ref| + ``lr_updates`` (lr times the updates),
    each moment within ADAMW_TOL of its buffer's largest |ref|; raises
    past them. Returns (parameters' relative gap, moments', max|d| of the
    parameters)."""
    torch.cuda.synchronize()
    pk, pp = kernel.segments.params, plain.segments.params
    with torch.no_grad():
        param_d = max(float(((p - q).abs() / (q.abs() + lr_updates)).max())
                      for p, q in zip(pk, pp))
        moment_d = max(float((a - b).abs().max() / b.abs().max())
                       for a, b in ((kernel.exp_avg, plain.exp_avg),
                                    (kernel.exp_avg_sq, plain.exp_avg_sq)))
        worst = max(max_abs(p, q) for p, q in zip(pk, pp))
    if not max(param_d, moment_d) <= ADAMW_TOL:
        raise AssertionError(f"{what}: kernel against plain, parameters {param_d}, moments "
                             f"{moment_d} (relative) > {ADAMW_TOL}")
    return param_d, moment_d, worst


# HGN at the count build's window batch: stages 0-2 and stage 3's flat
# phase tensor, where the pred conv is folded in, each in the memory order
# its conv returns in the model (stage 0's input is the decoder's NHWC
# token grid; the upsamples' einsums hand the later convs NCHW order).
HGN_SHAPES = (((WINDOWS, 24, 24, 256), "nhwc"), ((WINDOWS, 48, 48, 256), "nchw"),
              ((WINDOWS, 96, 96, 256), "nchw"), ((WINDOWS, 96, 96, 1024), "nchw"))


def hgn_phase(torch, dev):
    """HGN (ops/fused_gn.py) against its plain version at HGN_SHAPES in
    bf16: each output within one rounding of the plain one (2^-7 * |ref|
    + 1e-5 elementwise; the pred fold's [16, 96, 96, 4] within 2^-6 of
    max|ref|), the same bits on two calls, one HGN a call. Device ms
    (graph-replayed, inputs cycled past the 50 MB L2) of the kernels, the
    plain version, the ATen chain it replaced (the conv's bias add,
    ``ops/norms.py group_norm`` or ``gn_phase_stats`` + ``gn_phase_apply``,
    ReLU, ``pred_phase_flat``) and, as the library's yardstick,
    F.group_norm + ReLU on the channels-last NCHW view (at the phase
    shape over its 1024 channels in 8 groups: other groups, the same
    bytes), beside the bytes bound: the input read twice and the output
    written once (at the phase shape the [16, 96, 96, 4] pred output)."""
    import torch.nn.functional as F

    from countr_tpu_torch.ops import subpixel as sp
    from countr_tpu_torch.ops.fused_gn import (
        fused_group_norm, fused_group_norm_phase, group_norm_phase_plain, group_norm_relu_plain,
    )
    from countr_tpu_torch.ops.norms import group_norm

    rng = np.random.default_rng(7)
    bf = torch.bfloat16

    def conv_out(shape, order):
        x = randn_on(torch, rng, dev, shape, 1.5, 0.3, bf)
        return x if order == "nhwc" else x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)

    shapes = []
    for shape, order in HGN_SHAPES:
        n, h, w, c4 = shape
        phase = c4 == 1024
        c = 256
        nbytes = n * h * w * c4 * 2
        sets = max(2, -(-120_000_000 // nbytes))
        cb = randn_on(torch, rng, dev, (c,), 0.3, dtype=torch.float32)
        s = randn_on(torch, rng, dev, (c,), 0.1, 1.0, torch.float32)
        b = randn_on(torch, rng, dev, (c,), 0.1, dtype=torch.float32)
        if phase:
            pk = randn_on(torch, rng, dev, (c,), 0.05, dtype=bf)
            pb = randn_on(torch, rng, dev, (1,), 0.1, dtype=torch.float32)
            args = [(conv_out(shape, order),
                     tuple(randn_on(torch, rng, dev, sh, 1.5, 0.3, bf) for sh in
                           ((n, 2, 2 * w, c), (n, 2, 2 * w, c), (n, 2 * h, 2, c),
                            (n, 2 * h, 2, c))))
                    for _ in range(sets)]

            def kernel(x, strips):
                return fused_group_norm_phase(x, strips, cb, s, b, 8, pk, pb)[0]

            def plain(x, strips):
                return group_norm_phase_plain(x, strips, cb, s, b, 8, pk, pb)[0]

            def chain(x, strips):
                phb = x + cb.repeat(4).to(bf)
                mean, rstd = sp.gn_phase_stats(phb, strips, 8, c_real=c)
                yb = F.relu(sp.gn_phase_apply(phb, mean, rstd, s, b, c_real=c))
                return sp.pred_phase_flat(yb, pk.reshape(c, 1), pb)

            def library(x, strips):
                return F.relu(F.group_norm(x.permute(0, 3, 1, 2), 8, s.repeat(4).to(bf),
                                           b.repeat(4).to(bf), 1e-5))
            moved = 2 * nbytes + n * h * w * 4 * 2
        else:
            args = [(conv_out(shape, order),) for _ in range(sets)]

            def kernel(x):
                return fused_group_norm(x, cb, s, b, 8)

            def plain(x):
                return group_norm_relu_plain(x, cb, s, b, 8)

            def chain(x):
                return F.relu(group_norm(x + cb.to(bf), s, b, 8))

            def library(x):
                return F.relu(F.group_norm(x.permute(0, 3, 1, 2), 8, s.to(bf), b.to(bf), 1e-5))
            moved = 3 * nbytes
        t0 = time.perf_counter()
        n0 = launch_counts()["HGN"]
        got = kernel(*args[0])
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        if launch_counts()["HGN"] != n0 + 1:
            raise AssertionError(f"HGN {list(shape)}: one call counted "
                                 f"{launch_counts()['HGN'] - n0} launches")
        want = plain(*args[0])
        d = (got.float() - want.float()).abs()
        top = float(want.float().abs().max())
        if phase:
            ok = float(d.max()) <= 2.0 ** -6 * top
        else:
            ok = bool((d <= 2.0 ** -7 * want.float().abs() + 1e-5).all())
        if not ok:
            raise AssertionError(f"HGN {list(shape)}: max|d| {float(d.max())} (max|ref| {top})")
        if not torch.equal(kernel(*args[0]), got):
            raise AssertionError(f"HGN {list(shape)}: two calls gave other bits")
        chain_d = max_abs(chain(*args[0]), want)
        bound_ms, bound_by = bound(0.0, moved)
        shapes.append(dict(
            shape=list(shape), order=order, pred_fold=phase, max_abs_err=float(d.max()),
            max_abs_ref=top,
            chain_max_abs_diff=chain_d, first_call_s=first_s,
            ms=graph_ms(torch, kernel, args), plain_ms=graph_ms(torch, plain, args),
            chain_ms=graph_ms(torch, chain, args), library_ms=graph_ms(torch, library, args),
            bound_ms=bound_ms, bound_by=bound_by, eager_ms=time_ms(torch, kernel, args),
        ))
        say("kernel", name="HGN fused_group_norm", **shapes[-1])
        del args
        torch.cuda.empty_cache()
    return shapes


def adamw_phase(torch, dev):
    """The fused AdamW update (ops/fused_adamw.py) at mae_base's trainable
    parameters (the pretrain phase's state: 251 tensors, 111,654,912
    fp32), the gradient N(0, 1e-3) drawn once: three updates of the
    kernel against three of its plain version from the same state; one
    eager update's launches; device ms (graph-replayed) of the kernel, the
    plain version, and as the library's yardsticks torch's
    AdamW(fused=True, capturable=True) and the capturable foreach AdamW
    the port ran before, beside the 28-byte-a-parameter bound."""
    from countr_tpu_torch.ops.fused_adamw import adamw_plain, fused_adamw

    states = [pretrain_setup(torch, dev, False, graphed=False)[0] for _ in range(2)]
    gen = torch.Generator(device=dev).manual_seed(0)
    for st in states:
        gen.manual_seed(0)
        for g in st.grads:
            g.normal_(0.0, 1e-3, generator=gen)
        st.begin_step()  # the learning rate onto the device
    kernel, plain = states
    n = sum(p.numel() for p in kernel.params)
    for _ in range(3):
        for st, fn in ((kernel, fused_adamw), (plain, adamw_plain)):
            st.adam_step.add_(1)
            adamw_update(st, fn)
    param_d, moment_d, worst = adamw_gaps(torch, "AdamW", kernel, plain, 3 * PRETRAIN_LR)
    reset_counts()
    adamw_update(kernel, fused_adamw)
    torch.cuda.synchronize()
    eager = launch_counts()
    if eager != {k: int(k == "AdamW") for k in eager}:
        raise AssertionError(f"AdamW: one eager update launched {eager}")
    group = plain.optimizer.param_groups[0]
    library = {}
    for name, kw in (("fused", dict(fused=True)), ("foreach", dict(foreach=True))):
        # fresh group dicts: an optimizer writes its defaults into those it is given
        groups = [{"params": g["params"], "weight_decay": g["weight_decay"], "lr": g["lr"]}
                  for g in plain.optimizer.param_groups]
        opt = torch.optim.AdamW(groups, lr=group["lr"], betas=group["betas"], eps=group["eps"],
                                capturable=True, **kw)
        library[name] = graph_ms(torch, opt.step, [()])
        del opt
        torch.cuda.empty_cache()
    row = dict(shape=[n, len(kernel.params)], max_abs_err=worst, max_param_rel_diff=param_d,
               max_moment_rel_diff=moment_d, limit=ADAMW_TOL,
               chunks=int(kernel.segments.table.shape[0]), align=kernel.segments.align,
               ms=graph_ms(torch, lambda: adamw_update(kernel, fused_adamw), [()]),
               plain_ms=graph_ms(torch, lambda: adamw_update(plain, adamw_plain), [()]),
               library_ms=library["fused"], foreach_capturable_ms=library["foreach"],
               bound_ms=28 * n / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
               eager_launches=eager)
    # the state's whole update (the step count, then the kernel): its kernels
    row["update_kernels"] = profile_run(torch, lambda: kernel.apply_gradients(True), 2)["top"]
    say("kernel", name="AdamW fused_adamw", **row)
    del states, kernel, plain
    torch.cuda.empty_cache()
    return [row]

FT_TRAIN, FT_VAL = 96, 16  # the synthetic tree of the finetune_cli phase
FT_STEPS = 12  # --limit_steps: the steps of an epoch of the phase
# B1bwd 19 a train replay: the frozen encoder's 25 LayerNorms run under
# no_grad, so only the decoder's 19 have a backward
FT_TRAIN_LAUNCHES = {"B1": 44, "B2": 0, "B3": 18, "B4": 6, "B5": 0, "B6": 0, "AdamW": 1,
                     "B3h80": 0, "B4h80": 0, "B1bwd": 19, "HGN": 0}
# HGN 4 an eval or panel replay: the density head's stages under inference mode
FT_EVAL_LAUNCHES = {"B1": 44, "B2": 0, "B3": 18, "B4": 0, "B5": 0, "B6": 0, "AdamW": 0,
                    "B3h80": 0, "B4h80": 0, "B1bwd": 0, "HGN": 4}


def finetune_args(d: str, out: str, *extra):
    from countr_tpu_torch.cli import finetune as cli

    return cli.get_args(["--data_path", d, "--model", "mae_vit_base6_patch16", "--dtype", "bf16",
                         "--batch_size", str(TRAIN_BATCH), "--epochs", "2", "--limit_steps",
                         str(FT_STEPS), "--num_workers", "8", "--log_every", "0",
                         "--output_dir", out, *extra])


def recorded_losses(ft) -> list:
    """Every step's loss (a device tensor) of ``ft``'s epochs from now on,
    on every path (the pipelined one too)."""
    losses, steps = [], ft.step_metrics

    def spy(*args):
        for m in steps(*args):
            losses.append(m["loss"])
            yield m

    ft.step_metrics = spy
    return losses


def finetune_subprocess(d: str) -> dict:
    """The CLI as a user runs it: 2 epochs, then --do_resume --epochs 3."""
    import os
    import subprocess

    root = os.path.dirname(os.path.abspath(__file__))
    out = os.path.join(d, "out_sub")
    base = [sys.executable, "-m", "countr_tpu_torch.cli.finetune", "--data_path", d,
            "--model", "mae_vit_base6_patch16", "--dtype", "bf16", "--batch_size",
            str(TRAIN_BATCH), "--limit_steps", str(FT_STEPS), "--output_dir", out]
    t0 = time.perf_counter()
    sub = subprocess.run([*base, "--epochs", "2"], cwd=root, capture_output=True, text=True,
                         timeout=600)
    sub_s = time.perf_counter() - t0
    if sub.returncode != 0:
        raise AssertionError(f"cli.finetune exited {sub.returncode}: {sub.stderr[-3000:]}")
    with open(os.path.join(out, "log.txt")) as f:
        recs = [json.loads(line) for line in f]
    numbers = [v for r in recs for k, v in r.items() if k != "epoch"]
    kept = {k: sorted(os.listdir(os.path.join(out, k))) for k in ("ckpt_last", "ckpt_minMAE")}
    if [r["epoch"] for r in recs] != [0, 1] or not np.all(np.isfinite(numbers)) \
            or not all(kept.values()):
        raise AssertionError(f"cli.finetune subprocess: records {recs}, checkpoints {kept}")
    t0 = time.perf_counter()
    res = subprocess.run([*base[:-4], "--limit_steps", "2", "--output_dir", out, "--epochs", "3",
                          "--do_resume"], cwd=root, capture_output=True, text=True, timeout=600)
    res_s = time.perf_counter() - t0
    with open(os.path.join(out, "log.txt")) as f:
        after = [json.loads(line) for line in f]
    if res.returncode != 0 or "resumed epoch 2" not in res.stdout \
            or [r["epoch"] for r in after] != [0, 1, 2]:
        raise AssertionError(f"cli.finetune --do_resume exited {res.returncode}: "
                             f"{res.stdout[-1500:]} {res.stderr[-1500:]}")
    return dict(seconds=sub_s, records=recs, checkpoints=kept, resume_seconds=res_s,
                resumed_record=after[-1])


def host_rates(ft) -> dict:
    """The host augmentation's ms per sample on this thread, and at the
    loader's thread count (an epoch of the loader alone, no card)."""
    import os

    n = 16
    t0 = time.perf_counter()
    for i in range(n):
        ft.train_ds[i]
    one = (time.perf_counter() - t0) * 1e3 / n
    t0 = time.perf_counter()
    samples = sum(len(b["name"]) for b in ft.train_dl.epoch(100))
    loader = (time.perf_counter() - t0) * 1e3 / samples
    return dict(cpu_count=os.cpu_count(), loader_threads=ft.train_dl.num_workers,
                host_ms_per_sample_1_thread=one, host_ms_per_sample_loader=loader,
                host_samples_per_s_loader=1e3 / loader)


def finetune_inprocess(torch, d: str, device_aug: bool):
    """The CLI's run in this process, its graphs captured first and the
    counters at 0: the launches per replay, no eager launch, no capture
    during the epochs; the loader-fed rate of a timed epoch, a profiled
    epoch, the graphed step's rate on a batch already on the card, the
    host's rates. Returns (its stats, its losses and weights at the end
    of the run, the graphs' launches, the line)."""
    import random

    from countr_tpu_torch.cli import finetune as cli
    from countr_tpu_torch.data.loader import device_prefetch

    path = "device_aug" if device_aug else "host"
    extra = ("--device_aug",) if device_aug else ()
    t0 = time.perf_counter()
    ft = cli.Finetune(finetune_args(d, "", *extra))  # no output: no log, no checkpoints
    build_s = time.perf_counter() - t0
    graphs = ft.graphs()
    losses = recorded_losses(ft)
    runners = {"train": ft.train_step.runner, "eval": ft.eval_step.runner}
    reset_counts()
    for r in runners.values():
        r.zero_counts()
    stats = ft.run()
    eager = launch_counts()
    replays = {k: r.replays for k, r in runners.items()}
    per = {k: {n: v / max(r.replays, 1) for n, v in r.launched.items()} for k, r in runners.items()}
    val_batches = -(-FT_VAL // TRAIN_BATCH)
    if any(eager.values()) or ft.graphs() != graphs \
            or runners["train"].replays != 2 * FT_STEPS or per["train"] != FT_TRAIN_LAUNCHES \
            or runners["eval"].replays != 2 * val_batches or per["eval"] != FT_EVAL_LAUNCHES:
        raise AssertionError(f"finetune_cli ({path}): eager launches {eager}, graphs "
                             f"{graphs} -> {ft.graphs()}, replays {replays}, per replay {per}")
    numbers = [v for r in stats for k, v in r.items() if k != "epoch"]
    if not np.all(np.isfinite(numbers)):
        raise AssertionError(f"finetune_cli ({path}): stats {stats}")
    weights = [p.detach().clone() for p in ft.model.parameters()]  # the measurements train on
    launches = {k: runners["train"].launched[k] + runners["eval"].launched[k]
                for k in FT_TRAIN_LAUNCHES}

    rng = random.Random(7)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr = ft.train_epoch(2, rng)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    prof = profile_run(torch, lambda: ft.train_epoch(3, rng), 1)
    batch = next(device_prefetch(ft.train_dl.epoch(4), ft.device, ft.batch_keys))
    step_ms = events_ms(lambda: ft.train_step(batch, 3), iters=8)
    line = dict(path=path, graphs=graphs, capture_s=ft.capture_s, build_s=build_s,
                epochs=stats, replays=replays,
                launches_per_replay=per, eager_launches=eager, graphs_after=ft.graphs(),
                timed_epoch_steps=tr["steps"], timed_epoch_s=epoch_s,
                loader_fed_images_per_s=tr["steps"] * TRAIN_BATCH / epoch_s,
                step_ms_on_card=step_ms, step_images_per_s_on_card=TRAIN_BATCH / step_ms * 1e3,
                idle_share=prof["idle_share"], profile=prof, **host_rates(ft))
    if device_aug:
        line.update(augment_costs(torch, ft, batch))
    ft.close()
    return stats, losses, weights, launches, line


def augment_costs(torch, ft, batch) -> dict:
    """The device augmentation's ms on a loader batch (batch 8), and the
    branchless jitter's against one sequential pass of its four ops on the
    same images and factors: the price of the one-hot selection."""
    from countr_tpu_torch.ops import augment as aug

    gen = torch.Generator(device=ft.device).manual_seed(5)
    ins = [batch[k] for k in ("image_u8", "dots", "n_dots", "apply_photo")]
    img = ins[0].float() / 255.0
    draws = aug.draw_photometric(img.shape[0], img.shape[1], img.shape[2], gen)
    f, perm = draws["factors"], draws["perm"]

    def sequential():
        x = img
        for k, op in enumerate(aug.OPS):
            x = op(x, f[:, k])
        return x

    return dict(augment_ms=events_ms(lambda: aug.augment_batch(*ins, gen), iters=10),
                jitter_branchless_ms=events_ms(lambda: aug.color_jitter(img, f, perm), iters=10),
                jitter_sequential_ms=events_ms(sequential, iters=10),
                density_ms=events_ms(lambda: aug.density_from_dots(ins[1], ins[2]), iters=10),
                blur_ms=events_ms(lambda: aug.gaussian_blur(img, draws["sigma"]), iters=10))


def synthetic_fsc(d: str) -> None:
    """The finetune phases' synthetic FSC147 tree in ``d``."""
    import os
    import subprocess

    root = os.path.dirname(os.path.abspath(__file__))
    subprocess.run([sys.executable, os.path.join(root, "scripts", "make_synthetic_fsc.py"),
                    "--out", d, "--n_train", str(FT_TRAIN), "--n_val", str(FT_VAL),
                    "--n_test", "0"], check=True, capture_output=True)


def finetune_cli_phase(torch, d: str):
    """countr_tpu_torch.cli.finetune at full width on the synthetic tree
    ``d``: the subprocess, the in-process host and --device_aug runs,
    graphed against eager, resumed against uninterrupted. Returns the host
    run's graph launches."""
    import os

    from countr_tpu_torch.cli import finetune as cli

    t_phase = time.perf_counter()
    say("finetune_cli", run="subprocess", **finetune_subprocess(d))

    stats, losses, weights, launches, line = finetune_inprocess(torch, d, device_aug=False)
    torch.cuda.empty_cache()
    say("finetune_cli", run="in-process", **line)
    # graphed against eager: the run's first 4 steps against 4 eager
    # CLI steps from the same start (epoch 0's generator and shots)
    graphed4, eager4 = graphed_vs_eager(losses, lambda: cli.Finetune(finetune_args(d, ""),
                                                                     graphed=False))
    resume = resumed_vs_uninterrupted(
        torch, lambda out, *more: cli.Finetune(finetune_args(d, out, *more)),
        os.path.join(d, "out_split"), stats, weights)
    say("finetune_cli", run="graphed_vs_eager_and_resume", graphed_losses=graphed4,
        eager_losses=eager4, graphed_equals_eager=True, **resume)
    del weights
    torch.cuda.empty_cache()

    line = finetune_inprocess(torch, d, device_aug=True)[-1]
    say("finetune_cli", run="in-process", **line)
    torch.cuda.empty_cache()
    say("finetune_cli_done", seconds=time.perf_counter() - t_phase)
    return launches


def fsc_epoch0(ft):
    """Epoch 0 of the FSC147 CLI ``ft``, with its shot stream."""
    import random

    return ft.train_epoch(0, random.Random(f"{ft.args.seed}:0"))


def graphed_vs_eager(losses, make_twin, epoch0=fsc_epoch0, steps: int = 4):
    """The first ``steps`` losses of a graphed run against ``steps`` eager
    steps (``epoch0(twin)``) of a twin from the same start (epoch 0's
    generator and shots), to the bit. Returns both lists; raises
    otherwise."""
    twin = make_twin()
    eager_losses = recorded_losses(twin)
    twin.args.limit_steps = steps  # after the build: the schedule keeps its steps an epoch
    epoch0(twin)
    twin.close()
    graphed = [float(x) for x in losses[:steps]]
    eager = [float(x) for x in eager_losses]
    if graphed != eager:
        raise AssertionError(f"graphed losses {graphed} against eager {eager}")
    return graphed, eager


def resumed_vs_uninterrupted(torch, make, out: str, stats, weights) -> dict:
    """Epoch 0 of a CLI run ``make(out)`` that saves, then a fresh run
    ``make(out, "--do_resume")`` resumed from its ckpt_last for the epochs
    after, against the uninterrupted run's ``stats`` and ``weights``: the
    same stats and weights, to the bit. Returns the epoch the resumed run
    started at and the seconds of epoch 0's checkpoint saves; raises
    otherwise."""
    first = make(out)
    keep, saves = first._keep, []

    def timed_keep(*args):
        t0 = time.perf_counter()
        keep(*args)
        saves.append(time.perf_counter() - t0)

    first._keep = timed_keep
    head = first.run_epoch(0)
    first.close()
    del first
    torch.cuda.empty_cache()
    resumed = make(out, "--do_resume")
    tail = resumed.run()
    drop = lambda r: {k: v for k, v in r.items() if k != "epoch_time_s"}  # noqa: E731
    same_stats = [drop(r) for r in [head, *tail]] == [drop(r) for r in stats]
    same_weights = all(torch.equal(p, q) for p, q in zip(resumed.model.parameters(), weights,
                                                           strict=True))
    if resumed.start_epoch != 1 or not same_stats or not same_weights:
        raise AssertionError(f"{out}: resumed at {resumed.start_epoch}, stats "
                             f"{[head, *tail]} against {stats}, weights equal {same_weights}")
    start = resumed.start_epoch
    del resumed
    torch.cuda.empty_cache()
    return dict(resumed_at=start, resumed_equals_uninterrupted=True, epoch0_save_s=saves[0])


NO_LAUNCHES = dict.fromkeys(FT_TRAIN_LAUNCHES, 0)


def check_runners(what: str, runners: dict, expect: dict, graphs_before: int, graphs_after: int):
    """Each runner's replays and launches per replay against ``expect``
    ({name: (replays, per replay)}), no eager launch and no graph captured
    during the run. Returns (replays, per replay, eager launches); raises
    otherwise."""
    eager = launch_counts()
    replays = {k: r.replays for k, r in runners.items()}
    per = {k: {n: v / max(r.replays, 1) for n, v in r.launched.items()}
           for k, r in runners.items()}
    want = {k: e[0] for k, e in expect.items()}
    if any(eager.values()) or graphs_after != graphs_before or replays != want \
            or any(per[k] != e[1] for k, e in expect.items()):
        raise AssertionError(f"{what}: eager launches {eager}, graphs {graphs_before} -> "
                             f"{graphs_after}, replays {replays} (expected {want}), per "
                             f"replay {per}")
    return replays, per, eager


SURF_LOG_EVERY = 4  # the surfaces phase's --log_every
SURF_STATS = ("train/loss", "train/MAE", "train/RMSE", "val/MAE", "val/RMSE", "val/NAE", "lr",
              "epoch_time_s")  # an epoch's record (countr_tpu/cli/finetune.py:446-456)
ENTRY_LAUNCHES = {"B1": 26, "B2": 18, "B3": 0, "B4": 0, "B5": 0, "B6": 0, "AdamW": 0,
                  "B3h80": 0, "B4h80": 0, "B1bwd": 0, "HGN": 4}


class RecordingWandb:
    """A W&B sink that records its calls (the JAX package's test sink,
    tests/test_cli_train.py:80-97)."""

    def __init__(self):
        self.calls = []

    def log(self, record, step=None):
        self.calls.append(("log", step, sorted(record)))

    def image(self, tag, img, step=None):
        self.calls.append(("image", step, tag, tuple(np.shape(img))))

    def log_artifact(self, path, name, kind="model"):
        self.calls.append(("artifact", name))


def jax_cli_sinks(names, improved, epochs: int = 2, steps: int = FT_STEPS,
                  every: int = SURF_LOG_EVERY):
    """The TensorBoard (tag, step) pairs and the W&B calls the JAX finetune
    CLI makes (countr_tpu/cli/finetune.py:354-364, :464-479, :515-520) in
    ``epochs`` epochs of ``steps`` steps at --log_every ``every`` and
    --panel_every 1, the panels of the samples ``names``, the minMAE
    artifact at the epochs ``improved``."""
    tb, wb = [], []
    for e in range(epochs):
        for s in range(every, steps + 1, every):
            tb += [("train/loss_step", e * steps + s), ("train/lr_step", e * steps + s)]
            wb.append(("log", e * steps + s, ["train/loss_step", "train/lr_step"]))
        end = (e + 1) * steps
        tb += [(k, e) for k in SURF_STATS]
        wb.append(("log", end, sorted(("epoch", *SURF_STATS))))
        for n in names:
            tb.append((f"val/density_{n}", e))
            wb.append(("image", end, f"val/density_{n}", (384, 3 * 384, 3)))
        if e in improved:
            wb.append(("artifact", "finetuning_minMAE"))
    return tb, wb


def surfaces_logging(torch, d: str):
    """The finetune CLI in this process with TensorBoard (under its output
    directory), a recording W&B sink (``common.make_wandb`` swapped) and
    the panels every epoch, graphs captured first: launches per train,
    eval and panel replay, no eager launch, no capture during the epochs;
    the event files read back and the W&B calls against the JAX CLI's
    (tags and steps); the panel replay's densities against an eager
    forward of the same samples (to the bit); the panel and eval replays'
    ms; train epochs with the step scalars on against off, in turns, and
    the panels of one epoch alone. Returns the run's graph launches."""
    import os

    from countr_tpu_torch.cli import common
    from countr_tpu_torch.cli import finetune as cli
    from countr_tpu_torch.data.loader import device_prefetch
    from countr_tpu_torch.engine.train import PANEL_SHOT
    from countr_tpu_torch.utils.metrics import read_tb_events

    out = os.path.join(d, "out_surfaces")
    sink, make = RecordingWandb(), common.make_wandb
    common.make_wandb = lambda *a, **k: sink
    try:
        t0 = time.perf_counter()
        ft = cli.Finetune(finetune_args(d, out, "--panel_every", "1", "--log_every",
                                        str(SURF_LOG_EVERY)))
        build_s = time.perf_counter() - t0
    finally:
        common.make_wandb = make
    graphs = ft.graphs()
    runners = {"train": ft.train_step.runner, "eval": ft.eval_step.runner,
               "panel": ft.panels.runner}
    reset_counts()
    for r in runners.values():
        r.zero_counts()
    t0 = time.perf_counter()
    stats = ft.run()
    run_s = time.perf_counter() - t0
    val_batches = -(-FT_VAL // TRAIN_BATCH)
    replays, per, eager = check_runners(
        "surfaces (finetune CLI, panels every epoch)", runners,
        {"train": (2 * FT_STEPS, FT_TRAIN_LAUNCHES), "eval": (2 * val_batches, FT_EVAL_LAUNCHES),
         "panel": (2, FT_EVAL_LAUNCHES)}, graphs, ft.graphs())
    launches = {k: sum(r.launched[k] for r in runners.values()) for k in FT_TRAIN_LAUNCHES}

    events, wandb_calls = read_tb_events(os.path.join(out, "tb")), list(sink.calls)
    names = [ft.val_ds[i]["name"] for i in range(ft.n_panels)]
    improved = [0] + ([1] if stats[1]["val/MAE"] < stats[0]["val/MAE"] else [])
    want_tb, want_wb = jax_cli_sinks(names, improved)
    images = [v for _, _, v in events if not isinstance(v, float)]
    scalars = {(t, s): v for t, s, v in events if isinstance(v, float)}
    stat_diff = max(rel_diff(scalars[(k, e)], r[k]) for e, r in enumerate(stats)
                    for k in SURF_STATS if k != "epoch_time_s")
    if [(t, s) for t, s, _ in events] != want_tb or sink.calls != want_wb \
            or any(i.shape != (384, 3 * 384, 3) for i in images) or stat_diff > 1e-6 \
            or len(images) != 2 * ft.n_panels:
        raise AssertionError(f"surfaces: TensorBoard {[(t, s) for t, s, _ in events]} against "
                             f"{want_tb}; W&B {sink.calls} against {want_wb}; stat diff "
                             f"{stat_diff}")

    samples, dens = ft.panel_densities()
    batch = ft.panel_inputs()[1]
    with torch.inference_mode():
        eager_dens = ft.model(batch["image"], batch["boxes"], PANEL_SHOT).float().cpu()
    if not torch.equal(torch.from_numpy(dens), eager_dens):
        raise AssertionError("surfaces: the panel replay's densities differ from the eager "
                             f"forward's (max|d| {max_abs(torch.from_numpy(dens), eager_dens)})")
    panel_ms = events_ms(lambda: ft.panels(batch, PANEL_SHOT), iters=8)
    val = next(device_prefetch(ft._val_batches(), ft.device))
    eval_ms = events_ms(lambda: ft.eval_step(val, PANEL_SHOT), iters=8)

    import functools
    import random

    def timed(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    # train epochs with the step scalars on and off, in turns; then the
    # panels of one epoch alone (replay, triptychs, TensorBoard's PNGs)
    scalars_on, scalars_off = [], []
    for epoch, every in ((2, SURF_LOG_EVERY), (3, 0), (4, 0), (5, SURF_LOG_EVERY)):
        ft.args.log_every = every
        rng = random.Random(epoch)
        (scalars_on if every else scalars_off).append(
            timed(functools.partial(ft.train_epoch, epoch, rng)))
    panels_s = [timed(lambda: ft.log_val_panels(9, 0)) for _ in range(2)]
    panel = cli.val_panel(samples[0], dens[0])
    tb_image_ms = min(timed(lambda: ft.tb.image("timing/panel", panel, 9)) for _ in range(3)) * 1e3
    n_images = FT_STEPS * TRAIN_BATCH
    panel_epoch = min(scalars_on) + min(panels_s)
    say("surfaces", part="finetune_logging", build_s=build_s, capture_s=ft.capture_s,
        graphs=graphs, run_s=run_s, replays=replays, launches_per_replay=per,
        eager_launches=eager, graphs_after=ft.graphs(), tb_events=len(events),
        tb_images=len(images), wandb_calls=len(wandb_calls),
        wandb_artifacts=sum(c[0] == "artifact" for c in wandb_calls),
        tensorboard_imported_tensorflow="tensorflow" in sys.modules,
        tb_and_wandb_match_jax_cli=True, tb_stat_max_rel_diff=stat_diff,
        panel_samples=names, panels_equal_eager=True, panel_batch=ft.n_panels,
        panel_replay_ms=panel_ms, eval_replay_ms=eval_ms, eval_batch=TRAIN_BATCH,
        train_epoch_s_scalars_on=scalars_on, train_epoch_s_scalars_off=scalars_off,
        loader_fed_images_per_s_scalars_on=[n_images / x for x in scalars_on],
        loader_fed_images_per_s_scalars_off=[n_images / x for x in scalars_off],
        panels_s=panels_s, tb_image_ms=tb_image_ms,
        loader_fed_images_per_s_panel_epoch=n_images / panel_epoch,
        panel_epoch_note="the train epoch with the scalars on, and its panels")
    ft.close()
    del ft
    torch.cuda.empty_cache()
    return launches


def surfaces_debug_nans(torch, d: str):
    """--debug_nans on the finetune CLI: no graph captured, 2 eager steps
    (their launches), a batch with one NaN pixel raising
    FloatingPointError naming its step; then the same CLI without the flag
    captures its graphs again and replays them. Returns the eager
    launches."""
    import random

    from countr_tpu_torch.cli import finetune as cli
    from countr_tpu_torch.data import fsc147

    ft = cli.Finetune(finetune_args(d, "", "--debug_nans", "--limit_steps", "2"))
    if ft.graphs() != 0:
        raise AssertionError(f"--debug_nans captured {ft.graphs()} graphs")
    reset_counts()
    t0 = time.perf_counter()
    tr = ft.train_epoch(0, random.Random(f"{ft.args.seed}:0"))
    torch.cuda.synchronize()
    steps_s = time.perf_counter() - t0
    eager = launch_counts()
    if tr["steps"] != 2 or eager != {k: 2 * v for k, v in FT_TRAIN_LAUNCHES.items()} \
            or not np.isfinite(tr["loss"]):
        raise AssertionError(f"--debug_nans: {tr}, eager launches {eager}")

    get = fsc147.TrainDataset.__getitem__

    def nan_pixel(self, i):
        s = dict(get(self, i))
        s["image"] = np.array(s["image"], np.float32)
        s["image"][0, 0, 0] = np.nan
        return s

    fsc147.TrainDataset.__getitem__ = nan_pixel
    try:
        ft.train_epoch(1, random.Random(f"{ft.args.seed}:1"))
    except FloatingPointError as e:
        raised = str(e)
    else:
        raised = None
    finally:
        fsc147.TrainDataset.__getitem__ = get
    ft.close()
    del ft
    if raised is None or "epoch 1 step 1" not in raised:
        raise AssertionError(f"--debug_nans on a NaN batch raised {raised!r}")

    again = cli.Finetune(finetune_args(d, "", "--limit_steps", "2"))
    graphs = again.graphs()
    runners = {"train": again.train_step.runner}
    reset_counts()
    again.train_step.runner.zero_counts()
    again.train_epoch(0, random.Random(f"{again.args.seed}:0"))
    check_runners("after --debug_nans", runners, {"train": (2, FT_TRAIN_LAUNCHES)}, graphs,
                  again.graphs())
    again.close()
    del again
    torch.cuda.empty_cache()
    say("surfaces", part="debug_nans", graphs=0, eager_steps=2, eager_steps_s=steps_s,
        eager_launches=eager, nan_batch_raised=raised[:300], graphs_without_flag=graphs)
    return eager


def surfaces_entry(torch):
    """countr_tpu_torch.entry.entry() on the card: its forward (eager)
    against the model's own eager forward, to the bit, with its launches
    and ms. Returns the launches of one forward."""
    from countr_tpu_torch.entry import ENTRY_SHOT, entry

    fn, args = entry()
    fn(*args)
    reset_counts()
    out = fn(*args)
    launches = launch_counts()
    with torch.inference_mode():
        want = fn.model(*args, ENTRY_SHOT)
    if launches != ENTRY_LAUNCHES or not torch.equal(out, want) \
            or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"entry(): launches {launches}, equal to the model's forward "
                             f"{torch.equal(out, want)}")
    ms = events_ms(lambda: fn(*args), iters=10)
    say("surfaces", part="entry", shape=list(out.shape), launches=launches,
        equals_model_forward=True, ms=ms)
    del fn, args, out, want
    torch.cuda.empty_cache()
    return launches


def aggregate_check(d: str) -> None:
    """countr_tpu_torch.cli.aggregate over the run directories in ``d``:
    each row against the plain mean of its run's log.txt."""
    import os

    from countr_tpu_torch.cli import aggregate

    rows = aggregate.log_test_results(d)
    worst = 0.0
    for row in rows:
        with open(os.path.join(d, row["name"], "log.txt")) as f:
            recs = [json.loads(line) for line in f if line.strip()]
        keys = {k for r in recs for k, v in r.items()
                if isinstance(v, (int, float)) and not isinstance(v, bool)}
        want = {k: float(np.mean([r[k] for r in recs if k in r])) for k in keys}
        if set(row) - {"name"} != keys:
            raise AssertionError(f"aggregate: {row['name']} columns {sorted(row)}, log {keys}")
        worst = max([worst] + [rel_diff(row[k], want[k]) for k in keys])
    if len(rows) < 4 or worst > 1e-12:
        raise AssertionError(f"aggregate: {len(rows)} runs, max rel diff {worst}")
    plot = aggregate.plot_test_results(d)
    say("surfaces", part="aggregate", runs=[r["name"] for r in rows], max_rel_diff=worst,
        plot=os.path.basename(plot) if plot else None,
        logs_csv_bytes=os.path.getsize(os.path.join(d, "logs.csv")))


def surfaces_phase(torch, d: str) -> dict:
    """The surfaces of the last slice: the finetune CLI's TensorBoard,
    W&B and panels, --debug_nans and entry() (aggregate runs inside
    cli_test_phase, on its run directories). Returns their launches by
    path."""
    t0 = time.perf_counter()
    out = {"finetune_cli_panels": surfaces_logging(torch, d),
           "debug_nans": surfaces_debug_nans(torch, d),
           "entry": surfaces_entry(torch)}
    say("surfaces_done", seconds=time.perf_counter() - t0)
    return out


def resident_inprocess(torch, d: str, pipelined: bool):
    """The CLI's --resident_data run (--resident_pipeline with
    ``pipelined``) in this process, its graphs captured first and the
    counters at 0: the launches per replay, no eager launch, no capture
    during the epochs; the loader-fed rate of a timed epoch, a profiled
    epoch, the graphed step's ms on a batch already on the card, the
    materialisation's ms (graphed, bitwise against eager), the host's
    rates, the stores' bytes. Returns (stats, weights, losses, launches,
    line)."""
    import random

    from countr_tpu_torch.cli import finetune as cli
    from countr_tpu_torch.data.loader import device_prefetch
    from countr_tpu_torch.engine import train as engine
    from countr_tpu_torch.engine.train_store import materialize_batch

    path = "resident_pipeline" if pipelined else "resident"
    extra = ("--resident_data",) + (("--resident_pipeline",) if pipelined else ())
    t0 = time.perf_counter()
    ft = cli.Finetune(finetune_args(d, "", *extra))
    build_s = time.perf_counter() - t0
    graphs = ft.graphs()
    losses = recorded_losses(ft)
    val_batches = -(-FT_VAL // TRAIN_BATCH)
    if pipelined:
        runners = {"prime": ft.prime.runner, "pipelined": ft.pipe_step.runner,
                   "train_phase": ft.train_phase.runner}
        expect = {"prime": (2, NO_LAUNCHES), "pipelined": (2 * (FT_STEPS - 1), FT_TRAIN_LAUNCHES),
                  "train_phase": (2, FT_TRAIN_LAUNCHES)}
    else:
        runners = {"train": ft.train_step.runner}
        expect = {"train": (2 * FT_STEPS, FT_TRAIN_LAUNCHES)}
    runners["eval"] = ft.eval_step.runner
    expect["eval"] = (2 * val_batches, FT_EVAL_LAUNCHES)
    reset_counts()
    for r in runners.values():
        r.zero_counts()
    stats = ft.run()
    replays, per, eager = check_runners(f"resident_cli ({path})", runners, expect, graphs,
                                        ft.graphs())
    numbers = [v for r in stats for k, v in r.items() if k != "epoch"]
    if not np.all(np.isfinite(numbers)):
        raise AssertionError(f"resident_cli ({path}): stats {stats}")
    weights = [p.detach().clone() for p in ft.model.parameters()]
    launches = {k: sum(r.launched[k] for r in runners.values()) for k in FT_TRAIN_LAUNCHES}

    rng = random.Random(7)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr = ft.train_epoch(2, rng)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    prof = profile_run(torch, lambda: ft.train_epoch(3, rng), 1)
    batch = next(device_prefetch(ft.train_dl.epoch(4), ft.device, ft.batch_keys))
    if pipelined:
        carry = ft.prime(batch)
        step_ms = events_ms(lambda: ft.pipe_step(carry, batch, 3), iters=8)
    else:
        step_ms = events_ms(lambda: ft.train_step(batch, 3), iters=8)
    line = dict(path=path, graphs=graphs, capture_s=ft.capture_s, build_s=build_s,
                epochs=stats, replays=replays, launches_per_replay=per, eager_launches=eager,
                graphs_after=ft.graphs(), timed_epoch_steps=tr["steps"], timed_epoch_s=epoch_s,
                loader_fed_images_per_s=tr["steps"] * TRAIN_BATCH / epoch_s,
                step_ms_on_card=step_ms, step_images_per_s_on_card=TRAIN_BATCH / step_ms * 1e3,
                idle_share=prof["idle_share"], profile=prof,
                store_bytes=ft.store.nbytes, val_store_bytes=ft.val_store.nbytes,
                mosaic_in_batch=int((batch["is_mosaic"] > 0).sum()), **host_rates(ft))
    if not pipelined:
        # the materialisation alone, graphed against eager at one generator
        # state, with TF32 off (the same bits; it runs no matrix product or
        # convolution, so the flags cannot reach it), and its ms; the
        # pixels alone (eager)
        arrays = ft.store.arrays
        flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        gens = [torch.Generator(device=ft.device) for _ in range(2)]
        mats = [engine.make_store_materialize(ft.state, ft.tcfg, arrays, g, graphed=graphed)
                for g, graphed in zip(gens, (True, False))]
        outs = []
        for g, mat in zip(gens, mats):
            g.manual_seed(11)
            outs.append(mat(batch))
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
        same = {k: bool(torch.equal(outs[0][k], outs[1][k])) for k in engine.CARRY_KEYS}
        if not all(same.values()):
            raise AssertionError(f"resident_cli: graphed materialisation against eager {same}")
        line.update(materialize_graphed_equals_eager=True, materialize_check_tf32=False,
                    run_tf32_matmul=flags[0], run_tf32_cudnn=flags[1],
                    materialize_graphed_ms=events_ms(lambda: mats[0](batch), iters=10),
            materialize_eager_ms=events_ms(lambda: mats[1](batch), iters=10),
            pixels_eager_ms=events_ms(lambda: materialize_batch(arrays, batch), iters=10))
        del mats, outs
    ft.close()
    return stats, weights, losses, launches, line


def resident_cli_phase(torch, d: str):
    """countr_tpu_torch.cli.finetune --resident_data at full width on the
    synthetic tree ``d``: the serial run, graphed against eager, resumed
    against uninterrupted, and the --resident_pipeline run against the
    serial one, each to the bit. Returns the serial and pipelined runs'
    graph launches together."""
    import os

    from countr_tpu_torch.cli import finetune as cli

    t_phase = time.perf_counter()
    stats, weights, losses, launches, line = resident_inprocess(torch, d, pipelined=False)
    torch.cuda.empty_cache()
    say("resident_cli", run="in-process", **line)
    graphed4, eager4 = graphed_vs_eager(losses, lambda: cli.Finetune(
        finetune_args(d, "", "--resident_data"), graphed=False))
    resume = resumed_vs_uninterrupted(
        torch, lambda out, *more: cli.Finetune(finetune_args(d, out, "--resident_data", *more)),
        os.path.join(d, "out_split_resident_data"), stats, weights)
    p_stats, p_weights, _, p_launches, p_line = resident_inprocess(torch, d, pipelined=True)
    say("resident_cli", run="in-process", **p_line)
    drop = lambda r: {k: v for k, v in r.items() if k != "epoch_time_s"}  # noqa: E731
    same_stats = [drop(r) for r in p_stats] == [drop(r) for r in stats]
    same_weights = all(torch.equal(p, q) for p, q in zip(p_weights, weights, strict=True))
    if not (same_stats and same_weights):
        raise AssertionError(f"resident_cli: pipelined stats {p_stats} against serial {stats}, "
                             f"weights equal {same_weights}")
    say("resident_cli", run="graphed_vs_eager_resume_pipelined", graphed_losses=graphed4,
        eager_losses=eager4, graphed_equals_eager=True, **resume, pipelined_equals_serial=True,
        step_ms_serial=line["step_ms_on_card"], step_ms_pipelined=p_line["step_ms_on_card"])
    del weights, p_weights
    torch.cuda.empty_cache()
    say("resident_cli_done", seconds=time.perf_counter() - t_phase)
    return {k: launches[k] + p_launches[k] for k in launches}


PT_STEPS = FT_TRAIN // PRETRAIN_BATCH  # the pretrain_cli phase's steps an epoch (6)


def pretrain_args(d: str, out: str, *extra):
    """The pretrain CLI's arguments on the synthetic tree ``d``: its
    defaults (mae_vit_base_patch16, bf16, batch 16, 8 loader threads), 2
    epochs."""
    from countr_tpu_torch.cli import pretrain as cli

    return cli.get_args(["--data_path", d, "--epochs", "2", "--log_every", "0",
                         "--output_dir", out, *extra])


def pretrain_subprocess(d: str) -> dict:
    """The CLI as a user runs it: one epoch of 2 steps on the host path."""
    import os
    import re
    import subprocess

    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    sub = subprocess.run([sys.executable, "-m", "countr_tpu_torch.cli.pretrain", "--data_path",
                          d, "--epochs", "1", "--limit_steps", "2", "--output_dir", ""],
                         cwd=root, capture_output=True, text=True, timeout=300)
    seconds = time.perf_counter() - t0
    m = re.search(r"\[Epoch 0\] loss (\S+)", sub.stdout)
    if sub.returncode != 0 or m is None or not np.isfinite(float(m.group(1))):
        raise AssertionError(f"cli.pretrain exited {sub.returncode}: {sub.stdout[-1500:]} "
                             f"{sub.stderr[-1500:]}")
    return dict(seconds=seconds, epoch0_loss=float(m.group(1)))


def materialize_checks(torch, pt, batch) -> dict:
    """The resident run's materialisation alone on a loader batch: replayed
    from a CUDA graph and eager with the process's TF32 flags on, and eager
    with them off, the same bits (its band products run in fp32 whatever
    the flags); graphed and eager ms; the store's bytes."""
    from countr_tpu_torch.engine.graphs import GraphRunner
    from countr_tpu_torch.engine.train_store import PRETRAIN_KEYS, materialize_pretrain_batch

    arrays, max_w = pt.store.arrays, pt.store.max_w
    ins = tuple(batch[k] for k in PRETRAIN_KEYS)

    def fn(*xs):
        return materialize_pretrain_batch(arrays, dict(zip(PRETRAIN_KEYS, xs)), max_w)

    runner = GraphRunner(pt.device)
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        graphed = runner("m", fn, *ins).clone()
        eager_tf32_on = fn(*ins)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        eager_tf32_off = fn(*ins)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    same = (torch.equal(graphed, eager_tf32_off), torch.equal(eager_tf32_on, eager_tf32_off))
    if not all(same) or tuple(graphed.shape) != (PRETRAIN_BATCH, 384, 384, 3):
        raise AssertionError(f"pretrain_cli: materialisation graphed / TF32 on against eager "
                             f"TF32 off equal {same}, shape {tuple(graphed.shape)}")
    return dict(materialize_graphed_equals_eager=True, materialize_tf32_flags_ignored=True,
                materialize_graphed_ms=events_ms(lambda: runner("m", fn, *ins), iters=10),
                materialize_eager_ms=events_ms(lambda: fn(*ins), iters=10),
                store_bytes=pt.store.nbytes, store_max_w=max_w)


def reconstruction_check(torch, pt, imgs) -> dict:
    """The reconstruction panel (``cli/pretrain.py reconstruction_panel``,
    eager, outside the counted run) of a loader batch: its shape, values
    in [0, 1], its ms, and whether TensorBoard imports here (the CLI writes
    the panel only where it does)."""
    import tempfile

    from countr_tpu_torch.cli.pretrain import reconstruction_panel
    from countr_tpu_torch.utils.metrics import TBWriter

    gen = torch.Generator(device=pt.device)
    t0 = time.perf_counter()
    panel = reconstruction_panel(pt.model, imgs, generator=gen.manual_seed(3))
    ms = (time.perf_counter() - t0) * 1e3
    if panel.shape != (384, 3 * 384, 3) or not (np.all(panel >= 0) and np.all(panel <= 1)):
        raise AssertionError(f"pretrain_cli: reconstruction panel {panel.shape}, "
                             f"range {panel.min()}..{panel.max()}")
    with tempfile.TemporaryDirectory() as tb_dir:
        tb = TBWriter(tb_dir)
        enabled = tb.enabled
        tb.flush()
    return dict(reconstruction_panel_shape=list(panel.shape), reconstruction_panel_ms=ms,
                tensorboard_imports=enabled)


def pretrain_inprocess(torch, d: str, resident: bool):
    """The pretrain CLI's run in this process, its graph captured first
    and the counters at 0: launches per replay, no eager launch, no capture
    during the 2 epochs; the loader-fed rate of a timed epoch, a profiled
    epoch (idle share), the graphed step's ms on a batch already on the
    card, the host's ms a sample (one thread; the loader's 8: PIL's crop
    and resize, or on the resident path ``_store_item``); on the resident
    path the materialisation's checks. Returns (stats, weights,
    losses, launches, line)."""
    from countr_tpu_torch.cli import pretrain as cli
    from countr_tpu_torch.data.loader import device_prefetch

    path = "resident" if resident else "host"
    extra = ("--resident_data",) if resident else ()
    t0 = time.perf_counter()
    pt = cli.Pretrain(pretrain_args(d, "", *extra))  # no output: no log, no checkpoints
    build_s = time.perf_counter() - t0
    graphs = pt.graphs()
    losses = recorded_losses(pt)
    runner = pt.train_step.runner
    reset_counts()
    runner.zero_counts()
    stats = pt.run()
    replays, per, eager = check_runners(
        f"pretrain_cli ({path})", {"train": runner},
        {"train": (2 * PT_STEPS, PRETRAIN_LAUNCHES[False])}, graphs, pt.graphs())
    if not all(np.isfinite(r["train/loss"]) for r in stats):
        raise AssertionError(f"pretrain_cli ({path}): stats {stats}")
    weights = [p.detach().clone() for p in pt.model.parameters()]
    launches = dict(runner.launched)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr = pt.train_epoch(2)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    prof = profile_run(torch, lambda: pt.train_epoch(3), 1)
    batch = next(device_prefetch(pt.train_dl.epoch(4), pt.device, pt.batch_keys))
    step_ms = events_ms(lambda: pt.train_step(pt._inputs(batch)), iters=8)
    line = dict(path=path, graphs=graphs, capture_s=pt.capture_s, build_s=build_s,
                epochs=stats, replays=replays, launches_per_replay=per, eager_launches=eager,
                graphs_after=pt.graphs(), timed_epoch_steps=tr["steps"], timed_epoch_s=epoch_s,
                loader_fed_images_per_s=tr["steps"] * PRETRAIN_BATCH / epoch_s,
                step_ms_on_card=step_ms,
                step_images_per_s_on_card=PRETRAIN_BATCH / step_ms * 1e3,
                idle_share=prof["idle_share"], profile=prof, **host_rates(pt),
                upload_bytes_per_batch=sum(batch[k].numel() * batch[k].element_size()
                                           for k in pt.batch_keys))
    if resident:
        line.update(materialize_checks(torch, pt, batch))
    else:
        line.update(reconstruction_check(torch, pt, batch["image"]))
    pt.close()
    return stats, weights, losses, launches, line


def pretrain_cli_phase(torch, d: str):
    """countr_tpu_torch.cli.pretrain at full width (mae_vit_base_patch16,
    bf16, batch 16) on the synthetic tree ``d``: a subprocess, then in this
    process the host path and --resident_data, each graphed against eager
    and resumed against uninterrupted. Returns each path's graph
    launches."""
    import os

    from countr_tpu_torch.cli import pretrain as cli

    t_phase = time.perf_counter()
    say("pretrain_cli", run="subprocess", **pretrain_subprocess(d))
    by_path = {}
    for resident in (False, True):
        extra = ("--resident_data",) if resident else ()
        stats, weights, losses, launches, line = pretrain_inprocess(torch, d, resident)
        torch.cuda.empty_cache()
        graphed4, eager4 = graphed_vs_eager(
            losses, lambda: cli.Pretrain(pretrain_args(d, "", *extra), graphed=False),
            epoch0=lambda twin: twin.train_epoch(0))
        out = os.path.join(d, "out_pt_split" + "_".join(e.strip("-") for e in extra))
        line.update(graphed_losses=graphed4, eager_losses=eager4, graphed_equals_eager=True,
                    **resumed_vs_uninterrupted(
                        torch, lambda o, *more: cli.Pretrain(pretrain_args(d, o, *extra, *more)),
                        out, stats, weights),
                    kept={k: sorted(os.listdir(os.path.join(out, k)))
                          for k in ("ckpt_periodic", "ckpt_last", "ckpt_params")},
                    ckpt_bytes={k: os.path.getsize(os.path.join(out, k, "checkpoint-1.pth"))
                                for k in ("ckpt_last", "ckpt_params")})
        say("pretrain_cli", run="in-process", **line)
        by_path["pretrain_cli_resident" if resident else "pretrain_cli"] = launches
        del weights, losses
        torch.cuda.empty_cache()
    say("pretrain_cli_done", seconds=time.perf_counter() - t_phase)
    return by_path


HUGE_LAUNCHES = {"B1": 82, "B2": 0, "B3": 40, "B4": 40, "B5": 0, "B6": 0, "AdamW": 1,
                 "B3h80": 32, "B4h80": 32, "B1bwd": 82,
                 "HGN": 0}  # 32 x 1280 encoder, 8 x 512 decoder


def huge_adamw(torch, state) -> dict:
    """The fused AdamW at ViT-H/14's 491 tensors and 656.6 M fp32
    parameters (flat buffers of 2.6 GB, so byte offsets pass 2^31)
    against its plain version: one update of ``state`` by the kernel and
    one of a copy of its parameters, moments and step count by
    ``adamw_plain``, from the last step's gradient and a copy of it:
    the parameters held to adamw_phase's bound (``adamw_gaps``, lr times
    one update, at the cell's peak lr), the moments to the bit;
    then both updates' device ms (graph-replayed) beside the
    28-byte-a-parameter bound."""
    import copy
    import types

    from countr_tpu_torch.ops.fused_adamw import adamw_plain, fused_adamw

    with torch.no_grad():
        seg = copy.copy(state.segments)  # adamw_plain reads params, offsets, decay_end
        seg.params = [p.detach().clone() for p in state.params]
        plain = types.SimpleNamespace(
            segments=seg, flat=state.flat.clone(), exp_avg=state.exp_avg.clone(),
            exp_avg_sq=state.exp_avg_sq.clone(), adam_step=state.adam_step.clone(),
            optimizer=state.optimizer)
    # the cell's peak lr: the phase's one epoch ends inside the warm-up,
    # where a near-zero lr would leave the parameters' part unchecked
    group, lr = state.optimizer.param_groups[0], 1.5e-4 * HUGE_BATCH / 256
    if torch.is_tensor(group["lr"]):
        group["lr"].fill_(lr)
    else:
        group["lr"] = lr
    for st, fn in ((state, fused_adamw), (plain, adamw_plain)):
        st.adam_step.add_(1)
        adamw_update(st, fn)
    param_d, moment_d, worst = adamw_gaps(torch, "AdamW (ViT-H/14)", state, plain, lr)
    if moment_d != 0.0:  # the same fp32 operations per element: adamw_phase reads 0
        raise AssertionError(f"AdamW (ViT-H/14): the kernel's moments are not the plain "
                             f"version's bits ({moment_d} relative)")
    n = sum(p.numel() for p in state.params)
    out = dict(adamw_shape=[n, len(state.params)], adamw_max_abs_err=worst,
               adamw_max_param_rel_diff=param_d, adamw_max_moment_rel_diff=moment_d,
               adamw_limit=ADAMW_TOL, adamw_chunks=int(state.segments.table.shape[0]),
               adamw_ms=graph_ms(torch, lambda: adamw_update(state, fused_adamw), [()]),
               adamw_plain_ms=graph_ms(torch, lambda: adamw_update(plain, adamw_plain), [()]),
               adamw_bound_ms=28 * n / HBM_BYTES_PER_S * 1e3)
    del plain, seg
    torch.cuda.empty_cache()
    return out


def pretrain_huge_phase(torch, d: str) -> dict:
    """countr_tpu_torch.cli.pretrain with mae_vit_huge_patch14 (ViT-H/14
    at 378 px: 32 x 1280, 16 heads of 80; bf16, batch 32) on the synthetic
    tree ``d``, in this process, on --resident_data and on the host path:
    one epoch of graphed steps each, B3 and B4 at head dim 80 in every
    encoder block (launches per replay against HUGE_LAUNCHES, no eager
    launch, no capture during the epoch), finite losses, 378-px crops, the
    graphed step's ms on a batch already on the card and the peak memory;
    on the resident path last, the AdamW update over the model's 656.6 M
    parameters against its plain version, and the device ms of each
    beside the 28-byte-a-parameter bound (``huge_adamw``).
    Returns each path's graph launches."""
    from countr_tpu_torch.cli import pretrain as cli
    from countr_tpu_torch.data.loader import device_prefetch
    from countr_tpu_torch.engine.train_store import materialize_pretrain_batch

    t_phase = time.perf_counter()
    by_path = {}
    for resident in (True, False):
        path = "resident" if resident else "host"
        extra = ("--resident_data",) if resident else ()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        pt = cli.Pretrain(pretrain_args(d, "", "--model", "mae_vit_huge_patch14", "--epochs", "1",
                                        "--batch_size", str(HUGE_BATCH), *extra))
        build_s = time.perf_counter() - t0
        graphs = pt.graphs()
        runner = pt.train_step.runner
        reset_counts()
        runner.zero_counts()
        stats = pt.run()
        replays, per, eager = check_runners(
            f"pretrain_huge ({path})", {"train": runner},
            {"train": (FT_TRAIN // HUGE_BATCH, HUGE_LAUNCHES)}, graphs, pt.graphs())
        if not all(np.isfinite(r["train/loss"]) for r in stats):
            raise AssertionError(f"pretrain_huge ({path}): stats {stats}")
        launches = dict(runner.launched)
        batch = next(device_prefetch(pt.train_dl.epoch(1), pt.device, pt.batch_keys))
        if resident:
            with torch.no_grad():
                imgs = materialize_pretrain_batch(pt.store.arrays, batch, pt.store.max_w,
                                                  pt.img_size)
        else:
            imgs = batch["image"]
        if tuple(imgs.shape) != (HUGE_BATCH, 378, 378, 3):
            raise AssertionError(f"pretrain_huge ({path}): crops {tuple(imgs.shape)}")
        step_ms = events_ms(lambda: pt.train_step(pt._inputs(batch)), iters=4)
        # the weights move on: the phase's checks are done
        adamw = huge_adamw(torch, pt.state) if resident else {}
        say("pretrain_huge", path=path, build_s=build_s, capture_s=pt.capture_s, graphs=graphs,
            epochs=stats, replays=replays, launches_per_replay=per, eager_launches=eager,
            step_ms_on_card=step_ms, step_images_per_s_on_card=HUGE_BATCH / step_ms * 1e3,
            peak_bytes=torch.cuda.max_memory_allocated(),
            params=sum(p.numel() for p in pt.model.parameters()), **adamw)
        by_path["pretrain_huge_resident" if resident else "pretrain_huge"] = launches
        pt.close()
        del pt, runner, batch, imgs
        torch.cuda.empty_cache()
    say("pretrain_huge_done", seconds=time.perf_counter() - t_phase)
    return by_path


POOL_IMAGES, POOL_H, POOL_W = 3659, 384, 512  # FSC147's train split, at 384x512


def store_pool_phase(torch, dev):
    """``materialize_batch`` alone on a pool of FSC147's size made on the
    card (3659 random images at 384x512, ~2.2 GB of uint8, far beyond the
    50 MB L2), 8 batches of 8 samples of the CLI's geometry (a quarter of
    them mosaics; every sample pays the mosaic path, n_mosaic None, as in
    the CLI), eager and replayed from one CUDA graph (CUDA events), beside
    the bytes bound: the output written once and each source pixel that
    the batch's taps need read once. Then ``materialize_pretrain_batch`` on
    the same pixels as the pretrain store's column-major layout
    (``pretrain_pool``)."""
    from countr_tpu_torch.data import transforms as T
    from countr_tpu_torch.engine.train_store import compose_affine, materialize_batch

    n, h, w = POOL_IMAGES, POOL_H, POOL_W
    gen = torch.Generator(device=dev).manual_seed(0)
    arrays = {
        # the tail pad is the pretrain store's, w * 384 pixels (the finetune
        # store's 384 is less)
        "pixels": torch.randint(0, 256, (n * h * w + w * 384, 3), generator=gen, device=dev,
                                dtype=torch.uint8),
        "exemplars": torch.randint(0, 256, (n, 3, 64, 64, 3), generator=gen, device=dev,
                                   dtype=torch.uint8),
        "base": torch.arange(n, device=dev) * (h * w),
        "width": torch.full((n,), w, device=dev), "height": torch.full((n,), h, device=dev)}
    rng = np.random.default_rng(3)
    batches, source_px = [], 0
    for _ in range(8):
        geo = {k: [] for k in ("img_idx", "affine_C", "affine_d", "is_mosaic", "cell_idx",
                               "cell_top", "cell_left", "cell_len", "blend_l")}
        for i in range(TRAIN_BATCH):
            mosaic = i % 4 == 0
            idx = int(rng.integers(0, n))
            C, d = compose_affine(T.draw_affine_matrix(rng, h, w), bool(rng.random() > 0.5),
                                  int(rng.integers(0, w - 383)), int(rng.integers(0, h - 383)), w)
            lens = rng.integers(250, 385, 4)
            geo["img_idx"].append(idx)
            geo["affine_C"].append(C)
            geo["affine_d"].append(d)
            geo["is_mosaic"].append(float(mosaic))
            geo["cell_idx"].append(rng.integers(0, n, 4))
            geo["cell_top"].append([int(rng.integers(0, h - v + 1)) for v in lens])
            geo["cell_left"].append([int(rng.integers(0, w - v + 1)) for v in lens])
            geo["cell_len"].append(lens)
            geo["blend_l"].append(int(rng.integers(10, 21)))
            source_px += int((lens ** 2).sum()) if mosaic else 384 * 384
        batches.append({k: torch.as_tensor(np.asarray(v), device=dev).to(
            torch.float32 if k in ("affine_C", "affine_d", "is_mosaic") else torch.int32)
            for k, v in geo.items()})
    arg_sets = [(b,) for b in batches]
    fn = lambda b: materialize_batch(arrays, b)  # noqa: E731
    affine = lambda b: materialize_batch(arrays, b, 0)  # noqa: E731
    out_bytes = TRAIN_BATCH * (384 * 384 * 3 + 3 * 64 * 64 * 3) * 4
    moved = out_bytes + (source_px / len(batches)) * 3 + TRAIN_BATCH * 3 * 64 * 64 * 3
    line = dict(pool_images=n, pool_bytes=int(arrays["pixels"].numel()), batch=TRAIN_BATCH,
                mosaic_per_batch=TRAIN_BATCH // 4,
                eager_ms=time_ms(torch, fn, arg_sets, iters=16),
                graphed_ms=graph_ms(torch, fn, arg_sets),
                affine_only_graphed_ms=graph_ms(torch, affine, arg_sets),
                bound_ms=moved / HBM_BYTES_PER_S * 1e3, bound_by="bytes", bytes_moved=moved)
    say("store_pool", **line)
    pretrain_pool(torch, dev, {k: arrays[k] for k in ("pixels", "base")})
    del arrays, batches, arg_sets
    torch.cuda.empty_cache()


H100_FP32_FLOPS = 67e12  # float32 outside the tensor cores, H100 SXM


def pretrain_pool(torch, dev, arrays) -> None:
    """``materialize_pretrain_batch`` alone on an FSC147-sized pretrain pool
    (``pixels`` and ``base`` of the store_pool phase read as 3659 images
    stored [512, 384], max_w 512), 8 batches of 16 RandomResizedCrop draws
    (every 4th a portrait, stored transposed; random flips), eager and
    replayed from one CUDA graph, beside its bounds: the two dense fp32
    band products' operations (2 * 384 * 1152 * (max_w + 384) a sample) at
    the card's fp32 rate without TF32, and the bytes (each crop's source
    pixels read once, the float32 output written once)."""
    from countr_tpu_torch.data.fsc147 import PretrainDataset
    from countr_tpu_torch.engine.train_store import PRETRAIN_KEYS, materialize_pretrain_batch

    max_w, b = POOL_W, PRETRAIN_BATCH
    arrays = {**arrays, "width": torch.full((POOL_IMAGES,), max_w, device=dev)}
    rng = np.random.default_rng(4)
    batches, source_px = [], 0
    for _ in range(8):
        geo = {k: [] for k in PRETRAIN_KEYS}
        for i in range(b):
            transposed = int(i % 4 == 3)
            h0, w0 = (max_w, 384) if transposed else (384, max_w)
            top, left, ch, cw = PretrainDataset.sample_crop(rng, h0, w0)
            if transposed:
                top, left, ch, cw = left, top, cw, ch
            for k, v in zip(PRETRAIN_KEYS, (int(rng.integers(0, POOL_IMAGES)), top, left, ch, cw,
                                            transposed, int(rng.random() < 0.5))):
                geo[k].append(v)
            source_px += ch * cw
        batches.append({k: torch.tensor(v, dtype=torch.int8 if k in ("transposed", "flip")
                                        else torch.int32, device=dev) for k, v in geo.items()})
    arg_sets = [(x,) for x in batches]
    fn = lambda x: materialize_pretrain_batch(arrays, x, max_w)  # noqa: E731
    flops = 2 * 384 * 384 * 3 * (max_w + 384) * b
    moved = source_px / len(batches) * 3 + b * 384 * 384 * 3 * 4
    tf, tb = flops / H100_FP32_FLOPS * 1e3, moved / HBM_BYTES_PER_S * 1e3
    say("pretrain_pool", pool_images=POOL_IMAGES, pool_bytes=int(arrays["pixels"].numel()),
        max_w=max_w, batch=b, eager_ms=time_ms(torch, fn, arg_sets, iters=16),
        graphed_ms=graph_ms(torch, fn, arg_sets), flops=flops, flop_bound_ms=tf,
        bytes_moved=moved, bytes_bound_ms=tb, bound_ms=max(tf, tb),
        bound_by="operations" if tf > tb else "bytes")


CARPK_TRAIN = 8  # the carpk_cli phase's tree: PNGs at 720x1280
CARPK_EPOCH_LAUNCHES = CARPK_TRAIN  # batch 1 (the CLI's default): 8 steps an epoch


def carpk_cli_phase(torch):
    """countr_tpu_torch.cli.finetune_carpk at full width on a local CARPK
    tree of 8 PNGs at 720x1280, batch 1 (the CLI's default), on the host
    path and with --resident_data: graphs captured first and the counters
    at 0 (B1 44, B3 18, B4 6 per replay, no eager launch, no capture during
    the epochs), 2 epochs, the loader-fed images/s of a timed epoch, a
    profiled epoch (idle share), the graphed step's ms on a batch already
    on the card, the host's ms per sample, and 4 graphed steps against 4
    eager ones (the same losses to the bit). Returns both runs' graph
    launches together."""
    import os

    from countr_tpu_torch.cli import finetune_carpk as cli
    from countr_tpu_torch.data.loader import device_prefetch

    t_phase = time.perf_counter()
    total = dict(NO_LAUNCHES)
    with smoke_dir("out_smoke_carpk_ft_") as d:
        carpk_tree(d, CARPK_TRAIN, seed=31)
        for resident in (False, True):
            path = "resident" if resident else "host"

            def args():
                return cli.get_args(["--carpk_root", d, "--output_dir", "", "--epochs", "2",
                                     "--num_workers", "8", "--dtype", "bf16",
                                     *(["--resident_data"] * resident)])

            t0 = time.perf_counter()
            ft = cli.FinetuneCarpk(args())
            build_s = time.perf_counter() - t0
            graphs = ft.graphs()
            losses = recorded_losses(ft)
            step, runner = ft.step, ft.step.runner
            reset_counts()
            runner.zero_counts()
            stats = ft.run()
            replays, per, eager = check_runners(
                f"carpk_cli ({path})", {"train": runner},
                {"train": (2 * CARPK_EPOCH_LAUNCHES, FT_TRAIN_LAUNCHES)}, graphs, ft.graphs())
            total = {k: total[k] + runner.launched[k] for k in total}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr = ft.train_epoch(2)
            torch.cuda.synchronize()
            epoch_s = time.perf_counter() - t0
            prof = profile_run(torch, lambda: ft.train_epoch(3), 1)
            batch = next(device_prefetch(ft.batches(4), ft.device, ft.batch_keys))
            step_ms = events_ms(lambda: step(batch), iters=8)
            t0 = time.perf_counter()
            if resident:
                from countr_tpu_torch.engine.carpk_store import exemplar_geometry

                g = np.random.default_rng(0)
                for i in range(64):
                    exemplar_geometry(g, ft.store, np.asarray([i % CARPK_TRAIN]))
                host_ms = (time.perf_counter() - t0) * 1e3 / 64
            else:
                for i in range(CARPK_TRAIN):
                    ft.dl.dataset[i]
                host_ms = (time.perf_counter() - t0) * 1e3 / CARPK_TRAIN
            ft.close()
            graphed4, eager4 = graphed_vs_eager(
                losses, lambda: cli.FinetuneCarpk(args(), graphed=False),
                epoch0=lambda twin: twin.train_epoch(0))
            say("carpk_cli", path=path, graphs=graphs, capture_s=ft.capture_s, build_s=build_s,
                epochs=stats, replays=replays, launches_per_replay=per, eager_launches=eager,
                graphs_after=ft.graphs(), timed_epoch_steps=tr["steps"], timed_epoch_s=epoch_s,
                loader_fed_images_per_s=tr["steps"] * ft.args.batch_size / epoch_s,
                step_ms_on_card=step_ms, idle_share=prof["idle_share"], profile=prof,
                host_ms_per_sample_1_thread=host_ms, cpu_count=os.cpu_count(),
                store_bytes=ft.store.nbytes if resident else 0, graphed_losses=graphed4,
                eager_losses=eager4, graphed_equals_eager=True)
            del ft, step, runner
            torch.cuda.empty_cache()
    say("carpk_cli_done", seconds=time.perf_counter() - t_phase)
    return total


PARALLEL_ENV = dict(MASTER_ADDR="localhost", RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")


def same_state(torch, what: str, a, b, losses_a, losses_b) -> dict:
    """Two training states after the same steps: every loss, parameter and
    Adam tensor the same bits. Raises otherwise."""
    params = all(torch.equal(p, q) for p, q in zip(a.model.parameters(), b.model.parameters()))
    moments = all(torch.equal(x, y) for p, q in zip(a.params, b.params)
                  for x, y in zip(a.moments(p), b.moments(q)))
    out = dict(losses_equal=losses_a == losses_b, params_equal=params, moments_equal=moments)
    if not all(out.values()):
        raise AssertionError(f"{what}: {out}; losses {losses_a} against {losses_b}")
    return out


@contextlib.contextmanager
def counted_all_reduces(torch):
    """Counts the torch.distributed.all_reduce calls made while a CUDA
    graph is being captured and those made outside a capture."""
    import torch.distributed as tdist

    real, n = tdist.all_reduce, {"in_capture": 0, "outside_capture": 0}

    def counting(*a, **kw):
        n["in_capture" if torch.cuda.is_current_stream_capturing() else "outside_capture"] += 1
        return real(*a, **kw)

    tdist.all_reduce = counting
    try:
        yield n
    finally:
        tdist.all_reduce = real


def parallel_step(torch, what: str, setup, args, per_step: dict, seed: int) -> dict:
    """A training step of one rank of a world of 1 (its gradient and
    metric all-reduces captured in its graphs) against the same step
    without a group: 4 steps each from the same start, the same bits;
    two all-reduces issued in each graph's capture (the flat gradient
    buffer and the metrics), none by the replays; launches per replay and
    no eager launch; no capture after the first step; step ms of both
    (CUDA events) and the all-reduce's device ms inside the replay
    (profiler)."""
    (state_d, step_d, gen_d), (state_p, step_p, gen_p) = setup(True), setup(False)
    with counted_all_reduces(torch) as in_captures:
        for a in args:
            step_d.capture(*a)
    for a in args:
        step_p.capture(*a)
    graphs = len(step_d.runner)
    if in_captures["in_capture"] != 2 * graphs:
        raise AssertionError(f"{what}: all-reduces {in_captures} in {graphs} captures")
    reset_counts()
    step_d.runner.zero_counts()
    with counted_all_reduces(torch) as in_replays:
        run_d = run_steps(torch, step_d, args, lambda: gen_d.manual_seed(seed))
    if any(in_replays.values()):
        raise AssertionError(f"{what}: the replays issued all-reduces {in_replays}")
    per_replay = graph_launches(step_d.runner, per_step, len(args), what)
    run_p = run_steps(torch, step_p, args, lambda: gen_p.manual_seed(seed))
    same = same_state(torch, what, state_d, state_p, run_d["losses"], run_p["losses"])
    if len(step_d.runner) != graphs:
        raise AssertionError(f"{what}: {len(step_d.runner) - graphs} graphs captured after "
                             "the first step")
    ms_d = events_ms(lambda: step_d(*args[0]), iters=10)
    ms_p = events_ms(lambda: step_p(*args[0]), iters=10)
    prof = profile_run(torch, lambda: step_d(*args[0]), 3)
    out = dict(steps=len(args), losses=run_d["losses"], launches_per_replay=per_replay,
               graphs=graphs, captured_after_first_step=0, bitwise_equal_to_no_group=same,
               all_reduces_in_captures=in_captures, all_reduces_in_replays=in_replays,
               ms_per_step=ms_d, no_group_ms_per_step=ms_p,
               allreduce_bytes_per_step=state_d.flat.numel() * state_d.flat.element_size(),
               allreduce_device_ms_per_step=sum(r["ms"] for r in prof["collectives"]),
               collectives=prof["collectives"], idle_share=prof["idle_share"],
               device_busy_ms=prof["device_busy_ms"])
    del state_d, step_d, state_p, step_p
    torch.cuda.empty_cache()
    return out


def parallel_counting(torch, model) -> dict:
    """count_batch through a pipeline over two replicas on cuda:0 against
    the one-device pipeline on COUNT_BATCH_CASES' images: counts within
    COUNT_BATCH_REL_TOL (and whether they are the same bits); B1 26 and B2
    18 per replica forward, no eager launch; images/s of both."""
    from countr_tpu_torch.engine.inference import CountingEngine

    rng = np.random.default_rng(14)
    cases = [synthetic_image(rng, w, sizes) for w, sizes in COUNT_BATCH_CASES]
    images, boxes, rects = (list(x) for x in zip(*cases))
    one = CountingEngine(model, batch_windows=WINDOWS)
    two = CountingEngine(model, batch_windows=WINDOWS, devices=["cuda:0", "cuda:0"])
    graphs = {"one": one.capture_forwards((3,)), "two": two.capture_forwards((3,))}

    def timed(engine):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = engine.count_batch(images, boxes, rects, 3, return_density=False)
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t0) * 1e3

    runners = [f.runner for f in two._pipeline.forwards]
    reset_counts()
    for r in runners:
        r.zero_counts()
    res_two, ms_two = timed(two)
    eager = launch_counts()
    per_replica = []
    for i, r in enumerate(runners):
        want = {"B1": 26 * r.replays, "B2": 18 * r.replays, "B3": 0, "B4": 0, "B5": 0, "B6": 0,
                "AdamW": 0, "B3h80": 0, "B4h80": 0, "B1bwd": 0, "HGN": 4 * r.replays}
        if any(eager.values()) or r.launched != want or r.replays == 0:
            raise AssertionError(f"parallel count_batch, replica {i}: {r.launched} over "
                                 f"{r.replays} replays, eager {eager}")
        per_replica.append(dict(replays=r.replays,
                                per_replay={k: v / r.replays for k, v in r.launched.items()}))
    if runners[0].replays != runners[1].replays:
        raise AssertionError(f"parallel count_batch: replays {[r.replays for r in runners]}")
    res_one, ms_one = timed(one)
    worst, bitwise = 0.0, True
    for i, (a, b) in enumerate(zip(res_two, res_one)):
        if a.grid_mode != b.grid_mode or a.n_windows != b.n_windows:
            raise AssertionError(f"parallel count_batch image {i}: grid or windows differ")
        for field in ("count", "raw_count", "e_cnt"):
            x, r = getattr(a, field), getattr(b, field)
            bitwise &= x == r
            rel = abs(x - r) / max(abs(r), 1e-6)
            worst = max(worst, rel)
            if not np.isfinite(x) or not rel <= COUNT_BATCH_REL_TOL:
                raise AssertionError(f"parallel count_batch image {i}: {field} {x} against "
                                     f"one device's {r}")
    ms_two = min(ms_two, *(timed(two)[1] for _ in range(3)))
    ms_one = min(ms_one, *(timed(one)[1] for _ in range(3)))
    out = dict(devices=["cuda:0", "cuda:0"], images=len(images), graphs=graphs,
               per_replica=per_replica, eager_launches=eager, max_rel_diff_vs_one=worst,
               rel_limit=COUNT_BATCH_REL_TOL, counts_bitwise_equal=bool(bitwise),
               ms=ms_two, one_device_ms=ms_one, images_per_s=len(images) / ms_two * 1e3,
               one_device_images_per_s=len(images) / ms_one * 1e3)
    del one, two
    torch.cuda.empty_cache()
    return out


def parallel_phase(torch, dev, model) -> dict:
    """Data parallelism on the one card: a process group of world 1 over
    NCCL (torchrun's environment set here), the finetune step (batch 8)
    and the pretrain step (batch 16) with the group against the same steps
    without one (``parallel_step``); count_batch over two replicas on
    cuda:0 (``parallel_counting``); ``--n_devices 2`` refused, naming the
    visible count. The group is destroyed and the environment restored
    after. Returns the launches of the steps' runs by path."""
    import torch.distributed as tdist

    from countr_tpu_torch.cli import finetune
    from countr_tpu_torch.parallel import dist

    saved = {k: os.environ.get(k) for k in (*PARALLEL_ENV, "MASTER_PORT")}
    os.environ.update(PARALLEL_ENV, MASTER_PORT=str(dist.free_port()))
    try:
        t0 = time.perf_counter()
        mesh = dist.init_distributed("cuda")
        init_s = time.perf_counter() - t0
        backend = tdist.get_backend(mesh.group)
        if backend != "nccl" or mesh.world != 1:
            raise AssertionError(f"parallel: backend {backend}, world {mesh.world}")
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in train_batch(np.random.default_rng(6), TRAIN_BATCH).items()}
        ft = parallel_step(
            torch, "parallel finetune",
            lambda grouped: finetune_setup(torch, dev, mesh=mesh if grouped else None)[:3],
            [(batch, s) for s in (3, 2, 1, 0)], FT_TRAIN_LAUNCHES, seed=2)
        imgs = torch.from_numpy(train_batch(np.random.default_rng(10),
                                            PRETRAIN_BATCH)["image"]).to(dev)
        pt = parallel_step(
            torch, "parallel pretrain",
            lambda grouped: pretrain_setup(torch, dev, False, mesh=mesh if grouped else None),
            [(imgs,)] * 4, PRETRAIN_LAUNCHES[False], seed=11)
        dist.destroy()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    count = parallel_counting(torch, model)
    try:
        finetune.main(finetune.get_args(["--n_devices", "2", "--data_path", "none"]))
        raise AssertionError("parallel: --n_devices 2 ran on a one-card machine")
    except ValueError as e:
        if f"{torch.cuda.device_count()} CUDA device(s) visible" not in str(e):
            raise
        refused = str(e)
    say("parallel", backend=backend, world=mesh.world, init_s=init_s, finetune=ft,
        pretrain=pt, count_batch=count, n_devices_2_refused=refused,
        destroyed=not tdist.is_initialized())
    def total(per_replay: dict, replays: int) -> dict:
        return {k: v * replays for k, v in per_replay.items()}

    replicas = [total(r["per_replay"], r["replays"]) for r in count["per_replica"]]
    return {"parallel_finetune": total(ft["launches_per_replay"], ft["steps"]),
            "parallel_pretrain": total(pt["launches_per_replay"], pt["steps"]),
            "parallel_count_batch": {k: sum(r[k] for r in replicas) for k in replicas[0]}}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from countr_tpu_torch.config import fast_mode_overrides
    from countr_tpu_torch.engine.inference import CountingEngine
    from countr_tpu_torch.models import build_countr

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    say("environment", device=name, count=torch.cuda.device_count(), nvidia_smi=smi,
        torch=torch.__version__, cuda=torch.version.cuda, decoders=decoders())
    try:
        import cv2  # noqa: F401
        import PIL.Image  # noqa: F401
    except ImportError as e:
        raise RuntimeError(f"the CLIs decode and resize with PIL and cv2: {e}") from e

    t0 = time.perf_counter()
    phase_build()
    ln_shapes = ln_phase(torch, dev)
    say("build_done", seconds=time.perf_counter() - t0)
    gemm_phase(torch, dev)
    block_shapes = block_phase(torch, dev)
    block_bwd_shapes = block_bwd_phase(torch, dev)
    b3_shapes, b4_shapes = attn_phase(torch, dev)
    ab = {}
    b5_shapes = mlp_phase(torch, dev, ab)
    b6_shapes = cross_phase(torch, dev, ab)
    say("ab_launches", **ab)
    adamw_shapes = adamw_phase(torch, dev)
    hgn_shapes = hgn_phase(torch, dev)

    model = build_countr("mae_vit_base6_patch16", seed=0, **fast_mode_overrides("bf16"))
    forward_phase(torch, dev, model)
    profile_phase(torch, dev, model)
    by_path = {"ab": ab, "count": count_phase(torch, model)}
    engine = CountingEngine(model, batch_windows=WINDOWS)
    graph_phase(torch, engine)
    by_path["count_batch"] = count_batch_phase(torch, engine)
    by_path.update(parallel_phase(torch, dev, model))
    # the mixed modes turn TF32 off for the process (an fp32 head); the
    # later phases keep the flags they had
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    by_path["cli_test"], cli_engine = cli_test_phase(torch)
    by_path["serve"] = serve_phase(torch, cli_engine)
    demo_phase(cli_engine)
    by_path["test_carpk"] = carpk_phase(torch, cli_engine)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    del model, engine, cli_engine
    torch.cuda.empty_cache()
    by_path["train"], ref = train_phase(torch, dev)
    accum_phase(torch, dev)
    checkpoint_phase(torch, dev, ref)
    del ref
    by_path["pretrain"] = pretrain_phase(torch, dev, fused=False)
    by_path["pretrain_b2_on"] = pretrain_phase(torch, dev, fused=True)
    with smoke_dir("out_smoke_ft_") as d:
        synthetic_fsc(d)
        by_path["finetune_cli"] = finetune_cli_phase(torch, d)
        by_path.update(surfaces_phase(torch, d))
        by_path["resident_cli"] = resident_cli_phase(torch, d)
        by_path.update(pretrain_cli_phase(torch, d))
        by_path.update(pretrain_huge_phase(torch, d))
    store_pool_phase(torch, dev)
    by_path["carpk_cli"] = carpk_cli_phase(torch)
    # ViT-H/14's kernel shapes last: after their profiled passes, a
    # one-kernel torch.profiler window (B6's check) lost its only record
    torch.cuda.empty_cache()
    ln_shapes += ln_phase(torch, dev, HUGE_LN_SHAPES)
    huge_b3, huge_b4 = attn_phase(torch, dev, HUGE_ATTN_SHAPES)
    b3_shapes += huge_b3
    b4_shapes += huge_b4
    # B1bwd here too: run before B6's check, its kernels' lines left that
    # one-kernel profiler window empty as well
    ln_bwd_shapes = ln_bwd_phase(torch, dev)

    def entry(name, route, source, replaces, path, shapes, **extra):
        main_shape = dict(shapes[0])
        key = name.split()[0]
        return dict(
            name=name, route=route, source=source, replaces=replaces,
            launches=by_path[path][key], launches_path=path,
            launches_by_path={p: counts[key] for p, counts in by_path.items()},
            max_abs_err=main_shape["max_abs_err"],
            max_abs_diff=max(s["max_abs_err"] for s in shapes),
            ms=main_shape["ms"], plain_ms=main_shape["plain_ms"],
            bound_ms=main_shape["bound_ms"], bound_by=main_shape["bound_by"],
            library_ms=main_shape["library_ms"], shape=main_shape["shape"],
            other_shapes=shapes[1:], **extra,
        )

    bwd = block_bwd_shapes[0]
    print(json.dumps({"kernels": [
        entry("B1 fused_layer_norm", "triton", "countr_tpu_torch/ops/fused_ln.py",
              "countr_tpu/ops/pallas_ln.py:30", "count_batch", ln_shapes, redesigned_in=1),
        entry("B1bwd fused_layer_norm backward", "triton", "countr_tpu_torch/ops/fused_ln.py",
              "none (XLA's LN VJP, countr_tpu/ops/pallas_ln.py:81-86)", "pretrain",
              ln_bwd_shapes,
              design="a persistent row pass (x and g read once, the rows' statistics "
                     "recomputed, dx written, the column sums of g*x^ and g in registers) "
                     "and a column pass over the programs' partial sums, in a fixed order"),
        entry("B2 fused_attention_block", "cuda", "countr_tpu_torch/csrc/attn_block.cu",
              "countr_tpu/ops/pallas_block.py:41", "count_batch", block_shapes, redesigned_in=4,
              backward=dict(replaces="countr_tpu/ops/pallas_block.py:164", path="pretrain_b2_on",
                            runs="B3 and B4 (countr_tpu_torch/csrc/attn.cu) and torch.matmul",
                            ms=bwd["ms"], fwd_bwd_ms=bwd["fwd_bwd_ms"],
                            plain_fwd_bwd_ms=bwd["plain_fwd_bwd_ms"],
                            library_fwd_bwd_ms=bwd["library_fwd_bwd_ms"],
                            bound_ms=bwd["bound_ms"], bound_by=bwd["bound_by"],
                            min_cosine=min(x["min_cosine"] for x in block_bwd_shapes),
                            max_rel_err=max(x["max_rel_err"] for x in block_bwd_shapes),
                            shapes=block_bwd_shapes)),
        entry("B3 fused_attention", "cuda", "countr_tpu_torch/csrc/attn.cu",
              "countr_tpu/ops/pallas_attn.py:33", "train", b3_shapes, redesigned_in=6,
              core="csrc/attention.cuh attn_resident_kernel, launched by launch_attn_any; "
                   "B2 runs it as its step 3"),
        entry("B4 fused_attention backward", "cuda", "countr_tpu_torch/csrc/attn.cu",
              "countr_tpu/ops/pallas_attn.py:93", "train", b4_shapes, redesigned_in=5,
              passes=b4_shapes[0]["passes"]),
        entry("B5 fused_mlp_block", "cuda", "countr_tpu_torch/csrc/mlp_block.cu",
              "countr_tpu/ops/pallas_block.py:214", "ab", b5_shapes, redesigned_in=4),
        entry("B6 fused_cross_attention_block", "cuda", "countr_tpu_torch/csrc/cross_block.cu",
              "countr_tpu/ops/pallas_block.py:398", "ab", b6_shapes, redesigned_in=15, widened_in=16,
              design="one kernel a call at every C <= 2048, one block a tile of up to 72 "
                     "rows (132 tiles at the decoder's shape: one wave): q and att in "
                     "shared memory, LN(x) resident where it fits in one wave (C 512), "
                     "else streamed by K-chunks with the weight's stages; past C 1280 a "
                     "2-block cluster a tile, each block the att of half the heads, the "
                     "peer's read through distributed shared memory; rows 0-63 by wgmma "
                     "and 64-71 by mma.sync on the same TMA weight stages, the small-k "
                     "attention on its own warps",
              device_kernels_per_call=sum(r["calls"] for r in
                                          b6_shapes[0]["device_kernels_per_call"])),
        entry("AdamW fused_adamw", "triton", "countr_tpu_torch/ops/fused_adamw.py",
              "none (optax's AdamW, left to XLA)", "pretrain", adamw_shapes,
              foreach_capturable_ms=adamw_shapes[0]["foreach_capturable_ms"],
              design="one launch over every trainable parameter: flat fp32 gradient and "
                     "moments, the parameters in place through a chunk table, a persistent "
                     "grid of 4 programs an SM, 16-byte vectors"),
        entry("HGN fused_group_norm", "triton", "countr_tpu_torch/ops/fused_gn.py",
              "none (XLA fuses countr_tpu/ops/norms.py group_norm and ops/subpixel.py "
              "gn_phase_stats, gn_phase_apply, pred_phase_flat)", "count_batch", hgn_shapes,
              design="a statistics pass (per-tile sums and centred squares, fp32), a "
                     "fixed-order merge a sample, and a normalise + ReLU pass, the conv bias "
                     "added in registers; at stage 3 the pred conv folded into the last pass"),
    ]}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
