"""Plain PyTorch reference of CounTR counting (Liu et al., BMVC 2022,
arXiv 2208.13721; the authors' ``models_mae_cross.py`` and
``FSC_test_cross(few-shot).py``), written for the benchmark's check. It
imports nothing of the program under test.

- The model: a ViT encoder (patch embedding as a stride-16 convolution,
  fixed 2-D sin-cos position embeddings, pre-norm blocks), the exemplar
  CNN (4 x conv3x3 + InstanceNorm + ReLU, max-pool after the first three,
  global average pool), the interaction decoder (self-attention,
  cross-attention from image tokens to exemplar tokens, MLP, each
  pre-norm residual) and the density head (4 x conv3x3 + GroupNorm(8) +
  ReLU + bilinear 2x, the 1x1 prediction conv before the last upsample),
  in NCHW, with the parameter names of the authors' state_dict.
- Counting an image of height 384: exemplar crops resized to 64x64
  (bilinear, half-pixel, no antialias), 384-wide windows at stride 128
  with the last snapped to the right edge, blended as the authors' loop
  does (the overlap with the previous window averaged), 3x3 grid mode
  when an exemplar is under 10x10 px (each crop resized back to the
  image's size and counted, the counts summed), count = sum / 60, and the
  test-time normalisation: divide by the mean density in the exemplar
  boxes of the last map when it exceeds 1.8.

The configuration states the GELU form (``gelu``: "tanh" or "erf");
everything else follows the paper's code. Precision: ``precision.py``.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.precision import operand

DENSITY_SCALE = 60.0
TTN_THRESHOLD = 1.8
WINDOW = 384
STRIDE = 128
EXEMPLAR = 64


def linear(x, lin: nn.Linear):
    return F.linear(operand(x), operand(lin.weight), lin.bias)


def conv(x, c: nn.Conv2d, padding: int):
    return F.conv2d(operand(x), operand(c.weight), c.bias, stride=c.stride, padding=padding)


def gelu(x, form: str):
    return F.gelu(x, approximate="tanh" if form == "tanh" else "none")


def sincos_2d(dim: int, grid: int) -> torch.Tensor:
    """[grid*grid, dim] fixed position embedding (MAE's
    get_2d_sincos_pos_embed, without a class token)."""
    gh = np.arange(grid, dtype=np.float32)
    gw = np.arange(grid, dtype=np.float32)
    mesh = np.stack(np.meshgrid(gw, gh), axis=0).reshape(2, 1, grid, grid)

    def one_d(d, pos):
        omega = np.arange(d // 2, dtype=np.float64) / (d / 2.0)
        omega = 1.0 / 10000 ** omega
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    emb = np.concatenate([one_d(dim // 2, mesh[0]), one_d(dim // 2, mesh[1])], axis=1)
    return torch.from_numpy(emb.astype(np.float32))


def layer_norm(x, ln: nn.LayerNorm):
    return F.layer_norm(x, x.shape[-1:], ln.weight, ln.bias, ln.eps)


def heads_attention(q, k, v, num_heads: int):
    """softmax(q k^T / sqrt(hd)) v over ``num_heads`` heads; [B, N, C]."""
    b, n, c = q.shape
    m = k.shape[1]
    hd = c // num_heads
    q = q.reshape(b, n, num_heads, hd).transpose(1, 2)
    k = k.reshape(b, m, num_heads, hd).transpose(1, 2)
    v = v.reshape(b, m, num_heads, hd).transpose(1, 2)
    s = torch.matmul(operand(q), operand(k).transpose(-1, -2)) * hd ** -0.5
    p = s.softmax(dim=-1)
    o = torch.matmul(operand(p), operand(v))
    return o.transpose(1, 2).reshape(b, n, c)


class Attention(nn.Module):
    def __init__(self, dim, heads):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        q, k, v = linear(x, self.qkv).chunk(3, dim=-1)
        return linear(heads_attention(q, k, v, self.heads), self.proj)


class CrossAttention(nn.Module):
    def __init__(self, dim, heads):
        super().__init__()
        self.heads = heads
        self.wq = nn.Linear(dim, dim)
        self.wk = nn.Linear(dim, dim)
        self.wv = nn.Linear(dim, dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, y):
        out = heads_attention(linear(x, self.wq), linear(y, self.wk), linear(y, self.wv),
                              self.heads)
        return linear(out, self.proj)


class Mlp(nn.Module):
    def __init__(self, dim, hidden, form):
        super().__init__()
        self.form = form
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return linear(gelu(linear(x, self.fc1), self.form), self.fc2)


class Block(nn.Module):
    def __init__(self, dim, heads, ratio, eps, form):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=eps)
        self.attn = Attention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=eps)
        self.mlp = Mlp(dim, int(dim * ratio), form)

    def forward(self, x):
        x = x + self.attn(layer_norm(x, self.norm1))
        return x + self.mlp(layer_norm(x, self.norm2))


class CrossBlock(nn.Module):
    def __init__(self, dim, heads, ratio, eps, form):
        super().__init__()
        self.norm0 = nn.LayerNorm(dim, eps=eps)
        self.selfattn = Attention(dim, heads)
        self.norm1 = nn.LayerNorm(dim, eps=eps)
        self.attn = CrossAttention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=eps)
        self.mlp = Mlp(dim, int(dim * ratio), form)

    def forward(self, x, y):
        x = x + self.selfattn(layer_norm(x, self.norm0))
        x = x + self.attn(layer_norm(x, self.norm1), y)
        return x + self.mlp(layer_norm(x, self.norm2))


class PatchEmbed(nn.Module):
    def __init__(self, p, cin, dim):
        super().__init__()
        self.proj = nn.Conv2d(cin, dim, p, p)

    def forward(self, x):  # NCHW -> [B, L, D]
        return conv(x, self.proj, 0).flatten(2).transpose(1, 2)


class CounTR(nn.Module):
    """The counting model; parameter names as the authors' state_dict."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        d, dd = cfg["embed_dim"], cfg["decoder_embed_dim"]
        form, eps, ratio = cfg["gelu"], cfg["ln_eps"], cfg["mlp_ratio"]
        self.grid = cfg["img_size"] // cfg["patch_size"]
        self.patch_embed = PatchEmbed(cfg["patch_size"], 3, d)
        self.blocks = nn.ModuleList(
            [Block(d, cfg["num_heads"], ratio, eps, form) for _ in range(cfg["depth"])])
        self.norm = nn.LayerNorm(d, eps=eps)
        self.decoder_embed = nn.Linear(d, dd)
        self.shot_token = nn.Parameter(torch.zeros(dd))
        widths, cins = (64, 128, 256, dd), (3, 64, 128, 256)
        for k in range(4):
            setattr(self, f"decoder_proj{k + 1}",
                    nn.Sequential(nn.Conv2d(cins[k], widths[k], 3, padding=1)))
        self.decoder_blocks = nn.ModuleList(
            [CrossBlock(dd, cfg["decoder_num_heads"], ratio, eps, form)
             for _ in range(cfg["decoder_depth"])])
        self.decoder_norm = nn.LayerNorm(dd, eps=eps)
        hw = cfg["head_width"]
        for k in range(4):
            layers = [nn.Conv2d(dd if k == 0 else hw, hw, 3, padding=1), nn.GroupNorm(8, hw),
                      nn.ReLU()]
            if k == 3:
                layers.append(nn.Conv2d(hw, 1, 1))
            setattr(self, f"decode_head{k}", nn.Sequential(*layers))
        self.register_buffer("pos", sincos_2d(d, self.grid), persistent=False)
        self.register_buffer("dec_pos", sincos_2d(dd, self.grid), persistent=False)

    def exemplar_tokens(self, boxes: torch.Tensor, shot: int) -> torch.Tensor:
        """[B, k, 3, 64, 64] crops -> [B, max(shot, 1), C]."""
        b = boxes.shape[0]
        if shot == 0:
            return self.shot_token.expand(b, 1, -1)
        x = boxes[:, :shot].reshape(b * shot, *boxes.shape[2:])
        for k in range(1, 5):
            x = F.relu(F.instance_norm(conv(x, getattr(self, f"decoder_proj{k}")[0], 1),
                                       eps=1e-5))
            x = F.max_pool2d(x, 2) if k < 4 else x.mean(dim=(2, 3))
        return x.reshape(b, shot, -1)

    def head(self, x: torch.Tensor, terms: bool = False):
        """Token grid -> density [B, 384, 384]; with ``terms`` also the
        map of the prediction conv's terms' magnitudes, sum_c |w_c y_c|
        + |b|, upsampled alike: the scale of the density with no
        cancellation between channels."""
        mags = None
        for k in range(4):
            st = getattr(self, f"decode_head{k}")
            x = F.relu(F.group_norm(conv(x, st[0], 1), 8, st[1].weight, st[1].bias, st[1].eps))
            if k == 3:
                if terms:
                    mags = F.conv2d(x, st[3].weight.abs(), st[3].bias.abs())
                    mags = F.interpolate(mags, scale_factor=2, mode="bilinear",
                                         align_corners=False)[:, 0]
                x = conv(x, st[3], 0)
            x = F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)
        return (x[:, 0], mags) if terms else x[:, 0]

    def forward(self, imgs: torch.Tensor, y: torch.Tensor, terms: bool = False):
        """imgs [B, 3, 384, 384] in [0, 1], exemplar tokens y [B, k, C]
        -> density [B, 384, 384] (and with ``terms`` its terms' map)."""
        x = self.patch_embed(imgs) + self.pos
        for blk in self.blocks:
            x = blk(x)
        x = layer_norm(x, self.norm)
        x = linear(x, self.decoder_embed) + self.dec_pos
        for blk in self.decoder_blocks:
            x = blk(x, y)
        x = layer_norm(x, self.decoder_norm)
        b, _, c = x.shape
        x = x.transpose(1, 2).reshape(b, c, self.grid, self.grid)
        return self.head(x, terms)


def resize(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Bilinear resize of [N, C, H, W], half-pixel centres, no antialias."""
    return F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False,
                         antialias=False)


def crop_boxes(image: torch.Tensor, rects: Sequence[Sequence[int]], k: int = 3) -> torch.Tensor:
    """Exemplar crops [k, 3, 64, 64] of a [3, H, W] image from rects
    (y1, x1, y2, x2), bounds inclusive."""
    out = []
    for y1, x1, y2, x2 in list(rects)[:k]:
        out.append(resize(image[None, :, y1:y2 + 1, x1:x2 + 1], EXEMPLAR, EXEMPLAR)[0])
    return torch.stack(out)


def window_starts(w: int) -> List[int]:
    starts, start = [], 0
    while start + WINDOW - 1 < w:
        starts.append(start)
        start += STRIDE
        if start + WINDOW - 1 >= w:
            if start == w - WINDOW + STRIDE:
                break
            start = w - WINDOW
    return starts


def stitch(outs, starts, h: int, w: int) -> torch.Tensor:
    """The authors' blend of window maps [n, 384, 384] into [384, w]: each
    window's overlap with the previous one averaged with it."""
    dm = torch.zeros((h, w), dtype=torch.float64, device=outs.device)
    prev = -1
    for out, s in zip(outs, starts):
        if prev >= s:
            dm[:, s:prev + 1] = (dm[:, s:prev + 1] + out[:, :prev - s + 1]) / 2
            dm[:, prev + 1:s + WINDOW] = out[:, prev - s + 1:]
        else:
            dm[:, s:s + WINDOW] = out
        prev = s + WINDOW - 1
    return dm


def sliding_density(model: CounTR, image: torch.Tensor, y: torch.Tensor, chunk: int):
    """The authors' loop over windows: [3, 384, w] -> the density [384, w]
    and its terms' map (float64)."""
    _, h, w = image.shape
    starts = window_starts(w)
    outs, mags = [], []
    for i in range(0, len(starts), chunk):
        wins = torch.stack([image[:, :, s:s + WINDOW] for s in starts[i:i + chunk]])
        d, m = model(wins, y.expand(wins.shape[0], -1, -1), terms=True)
        outs.append(d.double())
        mags.append(m.double())
    return stitch(torch.cat(outs), starts, h, w), stitch(torch.cat(mags), starts, h, w)


def grid_crops(h: int, w: int):
    """The 3x3 grid crops (top, left, h/3, w/3) in the authors' order;
    the last one's map feeds the test-time normalisation."""
    h3, w3 = h // 3, w // 3
    tl = [(0, 0), (h3, 0), (0, w3), (h3, w3), (2 * h // 3, 0), (2 * h // 3, w3),
          (0, 2 * w // 3), (h3, 2 * w // 3), (2 * h // 3, 2 * w // 3)]
    return [(t, l, h3, w3) for t, l in tl]


@torch.no_grad()
def count_image(model: CounTR, image_u8: np.ndarray, rects, shot: int, *,
                normalization: bool = True, max_s_cnt: int = 1, chunk: int = 8) -> dict:
    """Count one uint8 [384, W, 3] image with exemplar rects. Returns the
    count, the count before normalisation, the normalisation statistic,
    and the scales the check measures gaps against: ``mass``, the terms'
    map summed as the count is (/ 60), and ``e_mass``, the same over the
    exemplar boxes as the statistic is. A sum of signed terms can cancel;
    a random model's count is such a sum over the prediction conv's
    channels, so its rounding error scales with the terms, not with the
    count."""
    dev = model.shot_token.device
    img = torch.from_numpy(np.array(image_u8)).to(dev).permute(2, 0, 1).float() / 255
    _, h, w = img.shape
    if w < WINDOW:
        raise ValueError("the reference counts images at least one window wide")
    if shot > 0:
        y = model.exemplar_tokens(crop_boxes(img, rects, shot)[None], shot)
    else:
        y = model.exemplar_tokens(torch.zeros((1, 1, 3, EXEMPLAR, EXEMPLAR), device=dev), 0)
    tiny = sum(1 for r in list(rects)[:3] if r[2] - r[0] < 10 and r[3] - r[1] < 10)
    if tiny >= max_s_cnt:
        raw, mass, dm = 0.0, 0.0, None
        for t, l, ch, cw in grid_crops(h, w):
            crop = resize(img[None, :, t:t + ch, l:l + cw], h, w)[0]
            dm, tm = sliding_density(model, crop, y, chunk)
            raw += float(dm.sum()) / DENSITY_SCALE
            mass += float(tm.sum()) / DENSITY_SCALE
    else:
        dm, tm = sliding_density(model, img, y, chunk)
        raw = float(dm.sum()) / DENSITY_SCALE
        mass = float(tm.sum()) / DENSITY_SCALE
    e_cnt, e_mass, cnt = 0.0, 0.0, raw
    if normalization:
        for y1, x1, y2, x2 in rects:
            e_cnt += float(dm[y1:y2 + 1, x1:x2 + 1].sum()) / DENSITY_SCALE
            e_mass += float(tm[y1:y2 + 1, x1:x2 + 1].sum()) / DENSITY_SCALE
        e_cnt /= 3
        e_mass /= 3
        if e_cnt > TTN_THRESHOLD:
            cnt = raw / e_cnt
    return {"count": cnt, "raw": raw, "e_cnt": e_cnt, "mass": mass, "e_mass": e_mass,
            "grid": tiny >= max_s_cnt}


def gaps(got: dict, r: dict) -> dict:
    """An answer's gaps from the reference's ``r`` (``count_image``), each
    over its scale: the count before normalisation (``raw``) over the
    terms' mass, the normalisation statistic (``e_cnt``) over the terms'
    mass in the boxes, and the count over the scale the two give it, the
    last only where both sides took the same branch of the normalisation
    (where they did not, the statistic lies within its own gap of 1.8, and
    its gap judges that)."""
    out = {"raw_gap": abs(got["raw"] - r["raw"]) / max(r["mass"], 1e-30)}
    if r["e_mass"] > 0:
        out["ttn_gap"] = abs(got["e_cnt"] - r["e_cnt"]) / r["e_mass"]
    if (got["e_cnt"] > TTN_THRESHOLD) == (r["e_cnt"] > TTN_THRESHOLD):
        out["count_gap"] = abs(got["count"] - r["count"]) / count_scale(r)
    return out


def answer_gaps(pairs) -> dict:
    """The numbers of a set of answers, from (answer, the reference's
    ``count_image``) pairs: the widest of each of ``gaps``'s over the set,
    and ``raw_dev``, the widest distance of an answer's signed raw-count
    gap (over the terms' mass) from the set's median one: the part of the
    error that differs from answer to answer, with an offset that every
    answer of one model shares taken out."""
    out, signed = {}, []
    for got, r in pairs:
        for name, v in gaps(got, r).items():
            out[name] = max(out.get(name, 0.0), v)
        signed.append((got["raw"] - r["raw"]) / max(r["mass"], 1e-30))
    if signed:
        med = float(np.median(signed))
        out["raw_dev"] = max(abs(e - med) for e in signed)
    return out


def count_scale(r: dict) -> float:
    """The scale of the count's rounding error: the terms' mass, through
    the normalisation's division where it applies (d(raw / e) = draw / e
    - raw de / e^2)."""
    if r["e_cnt"] <= TTN_THRESHOLD:
        return max(r["mass"], 1e-30)
    e = r["e_cnt"]
    return max((r["mass"] + abs(r["raw"]) * r["e_mass"] / e) / e, 1e-30)


def build(cfg: dict, state: dict, device) -> CounTR:
    """The reference model on ``device`` in float32, its parameters
    copied from ``state`` (name -> tensor)."""
    with torch.device("meta"):
        model = CounTR(cfg)
    model = model.to_empty(device=device)
    model.pos.copy_(sincos_2d(cfg["embed_dim"], model.grid))
    model.dec_pos.copy_(sincos_2d(cfg["decoder_embed_dim"], model.grid))
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(state[name].float())
    return model.eval()
