"""Tiny configurations of the benchmark's cells for the CPU tests: the
published widths cut to a few channels and two blocks, the program's
plain float32 build (its kernels run only on the card), traffic cut to a
few images or steps."""

import time

from benchmark.lib import common


def countr_config() -> dict:
    cfg = common.load_json(common.BENCH / "configs" / "countr_base6.json")
    cfg.update(embed_dim=64, depth=2, num_heads=4, decoder_embed_dim=32, decoder_depth=2,
               decoder_num_heads=4, head_width=16, gelu="erf")
    cfg["builds"] = {"count": {"dtype": "fp32"}}
    return cfg


def mae_config() -> dict:
    cfg = common.load_json(common.BENCH / "configs" / "mae_base.json")
    cfg.update(embed_dim=64, depth=2, num_heads=4, decoder_embed_dim=32, decoder_depth=2,
               decoder_num_heads=4, gelu="erf")
    cfg["builds"] = {"pretrain": {"dtype": "fp32"}}
    return cfg


def traffic(name: str) -> dict:
    t = common.load_json(common.BENCH / "traffic" / f"{name}.json")
    if t["driver"] == "count":
        t.update(pool_images=8, batch_images=4, n_calls=4, warm_calls=1, check_images=6,
                 widths=[384, 512, 400], tiny_every=4)
    elif t["driver"] == "pretrain":
        t["tree"] = dict(t["tree"], n_train=24)
        t["cli_args"] = ["4" if a == "16" else "2" if a == "8" else a for a in t["cli_args"]]
    return t


def context(name: str, cfg: dict, t: dict, seed: int, seconds: float, trace: bool = False):
    return common.Context(workload={"name": name}, config=cfg, traffic=t, seed=seed,
                          seconds=seconds, trace=trace, t_start=time.perf_counter(),
                          device="cpu")
