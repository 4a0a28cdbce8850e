"""A pretraining job as ``cli.pretrain`` runs it: the CLI's own
``Pretrain`` object (its loader, its resident store with
``--resident_data``, its training state and its step replayed from CUDA
graphs), with the run's weights in place of the random ones the CLI
would draw on the host.

Set-up builds the object once (the synthetic tree is written into
``benchmark/cache/`` by the frozen generator the first time a checkout
needs it), then drives it from the seed through ``check_steps`` steps of
a first epoch, through ``step_metrics`` on the loader's batches: the
same call and feed as the window's. The window then runs whole epochs
from the start of the next one, as ``Pretrain.train_epoch`` does, until
its seconds are up; it ends when the steps it launched have finished.

Measured: ``train_images_per_s``, the samples of the window's steps over
the window's seconds. Checked, after the window, against the plain
reference (``reference/mae.py``) in float32 with TF32 off, which
follows the first steps from the same weights, the same batch geometry
(the crops' scalars that the loader drew, read as the step got them,
and held to RandomResizedCrop's ranges and the loader's seeded order),
the same masking noise (the step's generator state, drawn again) and
AdamW: each step's loss, the first gradient as AdamW got it (its first
moment after one step over 1 - beta1), and the parameters' change after
the steps, each by the worst leaf."""

from __future__ import annotations

import os
import time

import numpy as np

from benchmark.lib.common import (
    CACHE, Check, Outcome, free, peak_bytes, reset_peak, sync, torch_seed,
)
from benchmark.lib.trace import Profile, span, warm
from benchmark.work.models import mae as mae_work


class TimedBatches:
    """The loader's batches, with the host seconds spent waiting for each
    (a span around the call into the iterator), and each batch's arrays
    kept on the host while ``keep`` is set."""

    def __init__(self, it, waits=None):
        self.it = iter(it)
        self.waits = [] if waits is None else waits
        self.kept = []
        self.keep = False

    def __iter__(self):
        return self

    def __next__(self):
        t0 = time.perf_counter()
        with span("loader_next"):
            batch = next(self.it)
        self.waits.append(time.perf_counter() - t0)
        if self.keep:
            self.kept.append({k: v.cpu().numpy() if hasattr(v, "cpu") else v
                              for k, v in batch.items()})
        return batch

    def close(self):
        if hasattr(self.it, "close"):
            self.it.close()


def synthetic_tree(t: dict, log) -> str:
    """The FSC147-format tree of the traffic's size, written once into the
    checkout's cache directory (a fixed path named by its parameters)."""
    from benchmark.frozen.synthetic_fsc import write_tree

    d = t["tree"]
    path = CACHE / (f"fsc_synth_v2_{d['n_train']}_{d['n_val']}_{d['n_test']}_s{d['seed']}_"
                    + "w" + "-".join(str(w) for w in d["widths"]))
    if not (path / "DONE").exists():
        log(f"writing the synthetic tree {path.name}")
        write_tree(str(path), d["n_train"], d["n_val"], d["n_test"], d["seed"], d["widths"],
                   log=log)
    return str(path)


def cli_value(t: dict, flag: str) -> str:
    """The value the traffic's CLI arguments give ``flag``."""
    args = t["cli_args"]
    return args[args.index(flag) + 1]


def optimizer_settings(t: dict) -> dict:
    """AdamW's settings and the schedule the traffic's CLI arguments ask
    for: lr = blr * batch / 256 (the authors' rule), warm-up and cosine
    over ``--epochs`` of n_train // batch steps."""
    batch = int(cli_value(t, "--batch_size"))
    return dict(t["optimizer"], lr=float(cli_value(t, "--blr")) * batch / 256,
                epochs=int(cli_value(t, "--epochs")),
                warmup_epochs=int(cli_value(t, "--warmup_epochs")),
                steps_per_epoch=t["tree"]["n_train"] // batch)


def split_qkv(tensors: dict) -> dict:
    """Each fused qkv projection's weight and bias as three leaves, q, k
    and v: three products of their own in the architecture, and k's bias
    has no gradient but round-off (softmax ignores a shift of every key
    alike)."""
    out = {}
    for n, v in tensors.items():
        if n.endswith(("qkv.weight", "qkv.bias")):
            for part, chunk in zip("qkv", v.chunk(3, dim=0)):
                out[f"{n}.{part}"] = chunk
        else:
            out[n] = v
    return out


def leaf_gaps(prog: dict, ref: dict, skip=frozenset()) -> tuple:
    """(worst gap, its leaf): per leaf |norm(prog) - norm(ref)| over the
    larger of norm(ref) and the median leaf's norm(ref)."""
    rn = {k: float(v.double().norm()) for k, v in ref.items() if k not in skip}
    med = float(np.median(list(rn.values())))
    worst, at = 0.0, None
    for k, r in rn.items():
        gap = abs(float(prog[k].double().norm()) - r) / max(r, med)
        if gap > worst:
            worst, at = gap, k
    return worst, at


def run(ctx) -> Outcome:
    import torch

    from benchmark.lib import models
    from countr_tpu_torch.cli import pretrain as cli
    from countr_tpu_torch.cli.finetune import epoch_seed
    from countr_tpu_torch.data.loader import device_prefetch

    cfg, t = ctx.config, ctx.traffic
    dev = torch.device(ctx.device)
    tree = synthetic_tree(t, ctx.note)
    state = models.mae_weights(cfg, torch_seed(ctx.seed, 0), dev)
    model = models.program_mae(cfg, cfg["builds"]["pretrain"], state, dev)
    args = cli.get_args(["--data_path", tree, "--output_dir", "", "--seed", str(ctx.seed % 2**31),
                         "--mask_ratio", str(cfg["mask_ratio"]), *t["cli_args"]]
                        + (["--device", ctx.device] if ctx.device != "cuda" else []))
    built = cli.build_mae_model
    cli.build_mae_model = lambda a: model  # the run's weights, made on the card
    try:
        pt = cli.Pretrain(args)
    finally:
        cli.build_mae_model = built
    ctx.note(f"Pretrain built: {pt.steps_per_epoch} steps an epoch, {pt.graphs()} graphs")

    # the first steps, from the seed, through the window's own call and feed
    n_check = t["check_steps"]
    noise_seed = torch_seed(ctx.seed, 1)
    pt.generator.manual_seed(noise_seed)
    feed = TimedBatches(device_prefetch(pt.train_dl.epoch(0), pt.device, pt.batch_keys))
    feed.keep = True
    losses, moment1, snap = [], None, None
    steps = pt.step_metrics(feed, 0)
    for k in range(n_check):
        m = next(steps)
        losses.append(float(m["loss"]))
        if k == 0:
            opt = pt.state.optimizer
            moment1 = {n: opt.state[p]["exp_avg"].detach().cpu().clone()
                       for n, p in pt.model.named_parameters() if p in opt.state}
    snap = {n: p.detach().cpu().clone() for n, p in pt.model.named_parameters()}
    steps.close()
    feed.close()
    geometry = feed.kept[:n_check]
    if ctx.trace:
        warm()
    sync(dev)
    reset_peak(dev)
    setup_s = time.perf_counter() - ctx.t_start
    ctx.note(f"set-up {setup_s:.1f}s; losses {losses}")

    # the window: whole epochs from the start of the next one
    samples, epoch, waits = 0, 1, []
    runner = getattr(pt.train_step, "runner", None)
    t0 = time.perf_counter()
    trace_from, trace_len = ctx.seconds / 3, min(4.0, ctx.seconds / 3)
    prof, traced = None, None
    stop = False
    while not stop:
        pt.generator.manual_seed(epoch_seed(args.seed, epoch))
        feed = TimedBatches(device_prefetch(pt.train_dl.epoch(epoch), pt.device, pt.batch_keys),
                            waits)
        steps = pt.step_metrics(feed, epoch * pt.steps_per_epoch)
        for _ in steps:
            samples += args.batch_size
            now = time.perf_counter() - t0
            if ctx.trace and prof is None and traced is None and now >= trace_from:
                prof = Profile().__enter__()
                mark = (samples, now, dict(runner.launched) if runner else None, len(waits))
            elif prof is not None and now >= mark[1] + trace_len:
                prof.__exit__(None, None, None)
                traced = {"summary": prof, "samples": samples - mark[0],
                          "seconds": time.perf_counter() - t0 - mark[1],
                          "waits": sum(w for w in waits[mark[3]:]),
                          "counted": {k: runner.launched[k] - mark[2][k] for k in mark[2]}
                          if runner else None}
                prof = None
            if now >= ctx.seconds:
                stop = True
                break
        steps.close()
        feed.close()
        epoch += 1
    sync(dev)
    window = time.perf_counter() - t0
    peak = peak_bytes(dev)
    ctx.note(f"window: {samples} samples in {window:.2f}s over {epoch - 1} epoch(s)")

    layer, extra_trace = {}, {}
    if traced:
        # the model's operations over the window's samples outside the traced
        # stretch, over their seconds: the profiler's host overhead stays out
        untraced_s = window - traced["seconds"]
        traced_s = traced["summary"].summary["window_s"]
        extra_trace = {"traced_images_per_s": traced["samples"] / traced_s,
                       "untraced_images_per_s": (samples - traced["samples"]) / untraced_s,
                       "stretch_s": traced["seconds"], "traced_s": traced_s}
        layer = {"trace": traced["summary"].summary,
                 "untraced_flops": (samples - traced["samples"]) * mae_work.train_sample(cfg),
                 "untraced_s": untraced_s,
                 "launches": train_launches(cfg, traced["samples"] // args.batch_size,
                                            args.batch_size),
                 "launches_counted": traced["counted"],
                 "data_wait_s": traced["waits"]}

    # the check: the reference follows the first steps
    del steps, feed
    pt.close()
    del pt, model
    free(dev)
    opt = optimizer_settings(t)
    checks = check_steps(cfg, t["limits"], opt, tree, state, geometry, noise_seed, losses,
                         moment1, snap, dev, ctx)
    bad = geometry_faults(geometry, tree, int(args.seed))
    ctx.note(f"geometry: {len(bad)} fault(s) {bad[:4]}")
    checks.append(Check("geometry_faults", len(bad), t["limits"]["geometry_faults"]))
    return Outcome(attempted=samples, failed=0,
                   e2e={"train_images_per_s": samples / window, "setup_s": setup_s},
                   memory_peak_bytes=peak, checks=checks, layer=layer,
                   extra={"window_s": window, "epochs": epoch - 1, "losses": losses,
                          **extra_trace})


def geometry_faults(geometry, tree: str, seed: int) -> list:
    """What the check steps' batches break of what the pretraining data
    path states (``util/FSC147.py``'s RandomResizedCrop(384, scale=(0.2,
    1.0)) and horizontal flip over the train split, in the loader's seeded
    order): an image other than the epoch's seeded permutation puts there
    (``numpy.random.default_rng(SeedSequence([seed, epoch])).permutation``)
    or than its name says, a crop outside the image, an area under a fifth
    of it or an aspect outside [3/4, 4/3] (each up to the rounding of its
    sides to pixels), a transposition other than the image's, and a
    sample's flip when all of them read the same. The reference reads the
    crops the batches give; this check holds those crops to the ranges."""
    import json

    from PIL import Image

    with open(os.path.join(tree, "Train_Test_Val_FSC_147.json")) as f:
        ids = json.load(f)["train"]
    order = np.random.default_rng(np.random.SeedSequence([seed, 0])).permutation(len(ids))
    bad, flips, pos = [], set(), 0
    for batch in geometry:
        for b in range(len(batch["img_idx"])):
            i = int(batch["img_idx"][b])
            name = batch["name"][b] if "name" in batch else ids[i]
            if ids[int(order[pos])] != name or ids[i] != name:
                bad.append(("order", pos))
            pos += 1
            w, h = Image.open(os.path.join(tree, "images_384_VarV2", ids[i])).size
            portrait = h > w
            # the logical image: its smaller side 384, a portrait upright
            h0, w0 = (round(h * 384 / w), 384) if portrait else (384, round(w * 384 / h))
            top, left = int(batch["crop_top"][b]), int(batch["crop_left"][b])
            ch, cw = int(batch["crop_h"][b]), int(batch["crop_w"][b])
            if int(batch["transposed"][b]) != int(portrait):
                bad.append(("transposed", pos - 1))
            if portrait:  # the store holds a portrait transposed
                top, left, ch, cw = left, top, cw, ch
            if not (ch >= 1 and cw >= 1 and 0 <= top <= h0 - ch and 0 <= left <= w0 - cw):
                bad.append(("outside", pos - 1))
                continue
            slack = 0.5 / ch + 0.5 / cw
            if ch * cw < 0.2 * h0 * w0 * (1 - 2 * slack):
                bad.append(("area", pos - 1))
            if not 0.75 * (1 - slack) <= cw / ch <= 4 / 3 * (1 + slack):
                bad.append(("aspect", pos - 1))
            flips.add(int(batch["flip"][b]))
    if flips != {0, 1}:
        bad.append(("flip", sorted(flips)))
    return bad


def train_launches(cfg: dict, steps: int, batch: int) -> dict:
    """B1, B3 and B4 launches of ``steps`` MAE training steps at ``batch``
    (B2 off): B1 on every LayerNorm's forward, B3 on every block's
    attention forward, B4 on its backward; the encoder on the kept
    tokens, the decoder on all of them."""
    g = cfg["img_size"] // cfg["patch_size"]
    n = g * g
    keep = int(n * (1 - cfg["mask_ratio"]))
    d, dd = cfg["embed_dim"], cfg["decoder_embed_dim"]
    de, dde = cfg["depth"], cfg["decoder_depth"]
    return {
        "B1": {(batch * keep, d): steps * (2 * de + 1), (batch * n, dd): steps * (2 * dde + 1)},
        "B3": {(batch, keep, d): steps * de, (batch, n, dd): steps * dde},
        "B4": {(batch, keep, d): steps * de, (batch, n, dd): steps * dde},
    }


def reference_steps(cfg, opt, tree, state, geometry, noise_seed, dev, precision="fp32",
                    fault=None) -> dict:
    """The plain reference's steps on ``geometry`` (the batches' crop
    scalars) from the weights ``state``, with the masking noise drawn
    again from ``noise_seed``: each step's loss, the first step's gradient
    and the parameters after the steps (name -> host tensor). ``fault``
    plants one for the controls: "half_batch" (the loss over the first
    half of each batch)."""
    import json

    import torch
    from PIL import Image

    from benchmark.reference import mae as ref
    from benchmark.reference.precision import mode

    with open(os.path.join(tree, "Train_Test_Val_FSC_147.json")) as f:
        ids = json.load(f)["train"]
    model = ref.build(cfg, state, dev)
    params = dict(model.named_parameters())
    gen = torch.Generator(device=dev).manual_seed(noise_seed)
    g = cfg["img_size"] // cfg["patch_size"]
    stored, moments, losses, grad1 = {}, {}, [], None
    with mode(precision):
        for k, batch in enumerate(geometry):
            imgs = []
            for b in range(len(batch["img_idx"])):
                i = int(batch["img_idx"][b])
                if i not in stored:
                    stored[i] = ref.store_layout(Image.open(os.path.join(
                        tree, "images_384_VarV2", ids[i])))
                px, tr = stored[i]
                imgs.append(ref.crop(px, tr, int(batch["crop_top"][b]), int(batch["crop_left"][b]),
                                     int(batch["crop_h"][b]), int(batch["crop_w"][b]),
                                     bool(batch["flip"][b]), dev))
            noise = torch.rand((len(imgs), g * g), generator=gen, device=dev)
            imgs = torch.stack(imgs)
            if fault == "half_batch":
                imgs, noise = imgs[:len(imgs) // 2], noise[:len(imgs) // 2]
            model.zero_grad(set_to_none=True)
            loss = model(imgs, noise)
            loss.backward()
            losses.append(float(loss.detach()))
            grads = {n: p.grad.detach() for n, p in params.items()}
            if k == 0:
                grad1 = {n: v.cpu().clone() for n, v in grads.items()}
            lr = ref.warmup_cosine(k, opt["lr"], opt["epochs"], opt["warmup_epochs"],
                                   opt["steps_per_epoch"])
            ref.adamw({n: p.data for n, p in params.items()}, grads, moments, k + 1, lr, opt)
    out = {"losses": losses, "grad1": grad1,
           "params": {n: p.detach().cpu().clone() for n, p in params.items()}}
    del model, params, moments
    return out


def check_steps(cfg, lim, opt, tree, state, geometry, noise_seed, losses, moment1, snap, dev,
                ctx) -> list:
    """The program's first steps against the reference's: the worst
    step's loss gap, the worst leaf's first-gradient gap and the worst
    leaf's change gap. Leaves whose reference gradient is under a
    thousandth of the median leaf's (round-off alone moves them under
    Adam) are left out of the last two."""
    t_ref = time.perf_counter()
    ref = reference_steps(cfg, opt, tree, state, geometry, noise_seed, dev)
    p0 = {n: v.detach().cpu() for n, v in state.items()}
    delta_ref = split_qkv({n: ref["params"][n] - p0[n] for n in ref["params"]})
    delta_prog = split_qkv({n: snap[n] - p0[n] for n in ref["params"]})
    g1_prog = split_qkv({n: m / (1 - opt["beta1"]) for n, m in moment1.items()})
    g1_ref = split_qkv(ref["grad1"])
    med = float(np.median([float(v.norm()) for v in g1_ref.values()]))
    skip = {n for n, v in g1_ref.items() if float(v.norm()) < 1e-3 * med}
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"]))
    grad_gap, grad_at = leaf_gaps(g1_prog, g1_ref, skip)
    change_gap, change_at = leaf_gaps(delta_prog, delta_ref, skip)
    ctx.note(f"reference: {len(geometry)} steps in {time.perf_counter() - t_ref:.1f}s: losses "
             f"{ref['losses']}; worst leaves: gradient {grad_at}, change {change_at}; "
             f"left out {sorted(skip)}")
    return [Check("loss_gap", loss_gap, lim["loss_gap"]),
            Check("grad_gap", grad_gap, lim["grad_gap"]),
            Check("change_gap", change_gap, lim["change_gap"])]
