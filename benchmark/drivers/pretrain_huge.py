"""MAE ViT-H/14 pretraining (``configs/mae_huge14.json``) as
``cli.pretrain --model mae_vit_huge_patch14 --resident_data`` runs it:
``drivers/pretrain.py``'s set-up, window and check, with two things of
this configuration swapped in for the run:

- the plain reference crops to the configuration's ``img_size`` (378;
  ``reference/mae_sized.py``) and computes each step's loss and gradient
  in micro-batches of the traffic's ``reference_micro_batch`` samples,
  each weighted by its share of the batch (the loss is a mean over the
  batch's patches), so that the float32 ViT-H and its activations fit on
  the card beside the run's weights. The crop's draw and its check stay
  in the 384-side frame of the stored images (``geometry_faults``);
- the launch plan adds B3h80 and B4h80, the launches of B3 and B4 at
  head dim 80 (every encoder block's attention at 16 heads of 80), which
  ``b3h80_roofline.pretrain_huge`` and ``b4h80_roofline.pretrain_huge``
  read.

Measured and checked as ``drivers/pretrain.py`` says, against this
traffic's limits."""

from __future__ import annotations

import contextlib
import json
import os

from benchmark.drivers import pretrain as base


_PLAN = base.train_launches


def train_launches(cfg: dict, steps: int, batch: int) -> dict:
    """``drivers/pretrain.py``'s plan, with the B3 and B4 launches whose
    head dim is 80 also under B3h80 and B4h80."""
    out = _PLAN(cfg, steps, batch)
    g = cfg["img_size"] // cfg["patch_size"]
    keep = int(g * g * (1 - cfg["mask_ratio"]))
    hd = {(batch, keep, cfg["embed_dim"]): cfg["embed_dim"] // cfg["num_heads"],
          (batch, g * g, cfg["decoder_embed_dim"]):
              cfg["decoder_embed_dim"] // cfg["decoder_num_heads"]}
    for kernel in ("B3", "B4"):
        out[kernel + "h80"] = {s: k for s, k in out[kernel].items() if hd[s] == 80}
    return out


def micro_batch(t: dict) -> int:
    return int(t["reference_micro_batch"])


def reference_steps(cfg, opt, tree, state, geometry, noise_seed, dev, precision="fp32",
                    fault=None, micro=8) -> dict:
    """``drivers/pretrain.py reference_steps`` at the configuration's image
    size, in micro-batches of ``micro`` samples: each step's loss and
    gradient are the sums of the micro-batches' over their share of the
    batch."""
    import torch
    from PIL import Image

    from benchmark.reference import mae_sized as ref
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
                                     bool(batch["flip"][b]), dev, cfg["img_size"]))
            noise = torch.rand((len(imgs), g * g), generator=gen, device=dev)
            imgs = torch.stack(imgs)
            if fault == "half_batch":
                imgs, noise = imgs[:len(imgs) // 2], noise[:len(imgs) // 2]
            model.zero_grad(set_to_none=True)
            loss = 0.0
            for lo in range(0, len(imgs), micro):
                part = imgs[lo:lo + micro]
                share = len(part) / len(imgs)
                mb = model(part, noise[lo:lo + micro]) * share
                mb.backward()
                loss += float(mb.detach())
            losses.append(loss)
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


@contextlib.contextmanager
def sized(t: dict):
    """Within it ``drivers/pretrain.py`` runs this configuration: its
    ``reference_steps`` and ``train_launches`` are this module's."""
    swapped = {"reference_steps": lambda *a, **kw: reference_steps(*a, micro=micro_batch(t),
                                                                   **kw),
               "train_launches": train_launches}
    kept = {name: getattr(base, name) for name in swapped}
    for name, fn in swapped.items():
        setattr(base, name, fn)
    try:
        yield base
    finally:
        for name, fn in kept.items():
            setattr(base, name, fn)


def supported(cfg: dict) -> None:
    """Raise at once, before the tree or the model is made, where the
    program cannot run this configuration: B3/B4 without its encoder's
    head dim, or a pretrain dataset that crops 384 whatever the model."""
    import inspect

    from countr_tpu_torch.data.fsc147 import PretrainDataset
    from countr_tpu_torch.ops import fused_attn

    hd = cfg["embed_dim"] // cfg["num_heads"]
    if hd not in fused_attn.HEAD_DIMS:
        raise SystemExit(f"the program's B3/B4 take head dims {fused_attn.HEAD_DIMS}, not {hd}")
    if "img_size" not in inspect.signature(PretrainDataset).parameters:
        raise SystemExit("the program's pretrain data path crops 384 px, not the model's "
                         f"{cfg['img_size']}")


def run(ctx):
    supported(ctx.config)
    with sized(ctx.traffic):
        return base.run(ctx)
