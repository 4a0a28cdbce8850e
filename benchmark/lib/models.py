"""The program's models as a configuration file states them, with the
run's weights: built on the card (the constructors' own initialisation
runs there), then every parameter overwritten by ``lib/weights.py``'s
draw, which the reference gets too."""

from __future__ import annotations

import torch

from benchmark.lib import weights

WIDTH_KEYS = ("img_size", "patch_size", "embed_dim", "depth", "num_heads", "decoder_embed_dim",
              "decoder_depth", "decoder_num_heads", "mlp_ratio", "ln_eps")


def countr_weights(cfg: dict, seed: int, device) -> dict:
    """The counting model's weights, made in bfloat16 where the count
    build serves them in it."""
    from benchmark.reference import countr as ref

    with torch.device("meta"):
        shapes = weights.spec(ref.CounTR(cfg))
    served = torch.bfloat16 if cfg["builds"]["count"]["dtype"] == "bf16" else None
    return weights.make(shapes, seed, device, served)


def mae_weights(cfg: dict, seed: int, device) -> dict:
    from benchmark.reference import mae as ref

    with torch.device("meta"):
        shapes = weights.spec(ref.MAE(cfg))
    return weights.make(shapes, seed, device)


def program_countr(cfg: dict, build: dict, state: dict, device):
    """The program's CounTR in the build ``build`` names (its ``dtype``
    mode of ``config.fast_mode_overrides``, and ``training``)."""
    import dataclasses

    from countr_tpu_torch import disable_tf32
    from countr_tpu_torch.config import CounTRConfig, fast_mode_overrides
    from countr_tpu_torch.models.countr import CounTR

    over = fast_mode_overrides(build["dtype"], training=build.get("training", False))
    pcfg = dataclasses.replace(CounTRConfig(), head_width=cfg["head_width"],
                               **{k: cfg[k] for k in WIDTH_KEYS}, **over)
    if pcfg.approx_gelu != (cfg["gelu"] == "tanh"):
        raise ValueError(f"the build {build} computes another GELU than the configuration's "
                         f"{cfg['gelu']!r}")
    if pcfg.computes_fp32:
        disable_tf32()
    with torch.device(device):
        model = CounTR(pcfg)
    model = model.to(device)
    weights.load_into(model, state)
    return model.train(build.get("training", False))


def program_mae(cfg: dict, build: dict, state: dict, device):
    """The program's MAE as ``models.build_mae`` builds it in the build's
    ``dtype`` mode (``config.pretrain_overrides``)."""
    import dataclasses

    from countr_tpu_torch.config import MAEConfig, pretrain_overrides
    from countr_tpu_torch.models.mae import MaskedAutoencoderViT

    over = pretrain_overrides(build["dtype"], build.get("fused_attn_block", False))
    pcfg = dataclasses.replace(MAEConfig(), mask_ratio=cfg["mask_ratio"],
                               **{k: cfg[k] for k in WIDTH_KEYS}, **over)
    if pcfg.approx_gelu != (cfg["gelu"] == "tanh"):
        raise ValueError(f"the build {build} computes another GELU than the configuration's")
    with torch.device(device):
        model = MaskedAutoencoderViT(pcfg)
    model = model.to(device)
    weights.load_into(model, state)
    return model.train()
