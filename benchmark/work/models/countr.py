"""Operations of one CounTR window forward and of one image's exemplar
CNN, from the configuration's widths: the reference architecture's work,
whatever implements it. The subpixel head counts as the reference head:
each 2x bilinear upsample, then a 3x3 convolution at the larger size."""

from benchmark.work.models import vit


def window(cfg: dict, shots: int) -> float:
    g = cfg["img_size"] // cfg["patch_size"]
    n, d, dd = g * g, cfg["embed_dim"], cfg["decoder_embed_dim"]
    hid, dhid = int(d * cfg["mlp_ratio"]), int(dd * cfg["mlp_ratio"])
    m = max(shots, 1)
    f = vit.linear(n, 3 * cfg["patch_size"] ** 2, d)
    f += cfg["depth"] * vit.block(n, d, hid)
    f += vit.linear(n, d, dd)
    f += cfg["decoder_depth"] * vit.cross_block(n, m, dd, dhid)
    hw = cfg["head_width"]
    size, cin = g, dd
    for _ in range(4):
        f += vit.conv(size, size, cin, hw, 3)
        size, cin = size * 2, hw
    f += vit.conv(size // 2, size // 2, hw, 1, 1)  # the 1x1 prediction conv
    return f


def exemplars(cfg: dict, shots: int) -> float:
    """The exemplar CNN on ``shots`` 64x64 crops."""
    f, size = 0.0, 64
    for cin, cout in ((3, 64), (64, 128), (128, 256), (256, cfg["decoder_embed_dim"])):
        f += vit.conv(size, size, cin, cout, 3)
        size //= 2
    return shots * f
