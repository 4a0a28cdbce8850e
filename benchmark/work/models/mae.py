"""Operations of one MAE training sample (CounTR's pretraining model,
He et al. arXiv 2111.06377 without the class token): the encoder on the
visible tokens, the decoder on all of them, the pixel prediction. A
trained part's backward counts twice its forward, so a sample of a step
that trains every part costs 3x its forward."""

from benchmark.work.models import vit


def forward(cfg: dict) -> float:
    g = cfg["img_size"] // cfg["patch_size"]
    n, d, dd = g * g, cfg["embed_dim"], cfg["decoder_embed_dim"]
    keep = int(n * (1 - cfg["mask_ratio"]))
    p2c = 3 * cfg["patch_size"] ** 2
    f = vit.linear(n, p2c, d)  # every patch is embedded before the masking
    f += cfg["depth"] * vit.block(keep, d, int(d * cfg["mlp_ratio"]))
    f += vit.linear(keep, d, dd)
    f += cfg["decoder_depth"] * vit.block(n, dd, int(dd * cfg["mlp_ratio"]))
    f += vit.linear(n, dd, p2c)
    return f


def train_sample(cfg: dict) -> float:
    return 3.0 * forward(cfg)
