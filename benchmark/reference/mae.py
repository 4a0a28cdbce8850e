"""Plain PyTorch reference of CounTR's MAE pretraining (the authors'
``models_mae_noct.py``: He et al. arXiv 2111.06377 without the class
token), of its data path (``FSC_pretrain.py``: RandomResizedCrop(384,
bicubic) and a horizontal flip) and of AdamW, for the benchmark's check.
It imports nothing of the program under test.

- ``MAE``: patch embedding as a stride-16 convolution, fixed 2-D sin-cos
  position embeddings, random masking by an argsort of uniform noise
  (ties kept in order), the ViT encoder on the kept tokens, the decoder
  on all tokens with the mask token, the pixel prediction, and the loss:
  the per-patch mean square error averaged over ALL patches (the authors'
  code; ``norm_pix_loss`` off). Parameter names of the authors'
  state_dict.
- ``crop``: a decoded image whose smaller side is resized to 384 (PIL
  bilinear, portrait images transposed), the crop (top, left, h, w),
  resized to 384x384 by an antialiased bicubic filter (a = -0.5, PIL's)
  in float32, flipped when asked, clamped to [0, 1].
- ``adamw``: torch's AdamW step written out: decoupled weight decay on
  every parameter of two or more dimensions, bias corrections, eps
  outside the root."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.countr import Block, PatchEmbed, layer_norm, linear, sincos_2d

IMG = 384


class MAE(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        d, dd, p = cfg["embed_dim"], cfg["decoder_embed_dim"], cfg["patch_size"]
        form, eps, ratio = cfg["gelu"], cfg["ln_eps"], cfg["mlp_ratio"]
        self.grid = cfg["img_size"] // p
        self.patch_embed = PatchEmbed(p, 3, d)
        self.blocks = nn.ModuleList(
            [Block(d, cfg["num_heads"], ratio, eps, form) for _ in range(cfg["depth"])])
        self.norm = nn.LayerNorm(d, eps=eps)
        self.decoder_embed = nn.Linear(d, dd)
        self.mask_token = nn.Parameter(torch.zeros(1, 1, dd))
        self.decoder_blocks = nn.ModuleList(
            [Block(dd, cfg["decoder_num_heads"], ratio, eps, form)
             for _ in range(cfg["decoder_depth"])])
        self.decoder_norm = nn.LayerNorm(dd, eps=eps)
        self.decoder_pred = nn.Linear(dd, p * p * 3)
        self.register_buffer("pos", sincos_2d(d, self.grid), persistent=False)
        self.register_buffer("dec_pos", sincos_2d(dd, self.grid), persistent=False)

    def patchify(self, imgs: torch.Tensor) -> torch.Tensor:
        """[B, 3, H, W] -> [B, L, p*p*3] in (row, column, channel) order."""
        p = self.cfg["patch_size"]
        b, c, h, w = imgs.shape
        x = imgs.reshape(b, c, h // p, p, w // p, p)
        return torch.einsum("nchpwq->nhwpqc", x).reshape(b, (h // p) * (w // p), p * p * c)

    def forward(self, imgs: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """imgs [B, 3, 384, 384] in [0, 1], noise [B, L] -> the loss."""
        x = self.patch_embed(imgs) + self.pos
        b, n, d = x.shape
        keep = int(n * (1 - self.cfg["mask_ratio"]))
        shuffle = torch.argsort(noise, dim=1, stable=True)
        restore = torch.argsort(shuffle, dim=1, stable=True)
        x = torch.gather(x, 1, shuffle[:, :keep, None].expand(-1, -1, d))
        for blk in self.blocks:
            x = blk(x)
        x = linear(layer_norm(x, self.norm), self.decoder_embed)
        dd = x.shape[-1]
        x = torch.cat([x, self.mask_token.expand(b, n - keep, dd)], dim=1)
        x = torch.gather(x, 1, restore[:, :, None].expand(-1, -1, dd)) + self.dec_pos
        for blk in self.decoder_blocks:
            x = blk(x)
        pred = linear(layer_norm(x, self.decoder_norm), self.decoder_pred)
        return (pred - self.patchify(imgs)).square().mean(dim=-1).mean()


def build(cfg: dict, state: dict, device) -> MAE:
    with torch.device("meta"):
        model = MAE(cfg)
    model = model.to_empty(device=device)
    model.pos.copy_(sincos_2d(cfg["embed_dim"], model.grid))
    model.dec_pos.copy_(sincos_2d(cfg["decoder_embed_dim"], model.grid))
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(state[name].float())
    return model.train()


def store_layout(img) -> tuple:
    """A PIL image -> (uint8 [rows, w, 3] with rows = 384, transposed): the
    smaller side resized to 384 by PIL bilinear, a portrait image
    transposed so that its rows are 384."""
    from PIL import Image

    if img.mode != "RGB":
        img = img.convert("RGB")
    w0, h0 = img.size
    if h0 <= w0:
        out = img.resize((max(IMG, round(w0 * IMG / h0)), IMG), Image.BILINEAR)
        return np.asarray(out, np.uint8), False
    out = img.resize((IMG, max(IMG, round(h0 * IMG / w0))), Image.BILINEAR)
    return np.asarray(out, np.uint8).transpose(1, 0, 2), True


def crop(stored: np.ndarray, transposed: bool, top: int, left: int, h: int, w: int,
         flip: bool, device) -> torch.Tensor:
    """The sample [3, 384, 384] of a stored image (rows 384): the crop
    resized by the antialiased bicubic filter, back in the original
    orientation, flipped left-right when asked."""
    x = torch.from_numpy(np.array(stored[top:top + h, left:left + w]))
    x = x.to(device).permute(2, 0, 1).float()[None] / 255.0
    x = F.interpolate(x, size=(IMG, IMG), mode="bicubic", align_corners=False, antialias=True)[0]
    if transposed:
        x = x.transpose(1, 2)
    if flip:
        x = x.flip(2)
    return x.clamp(0.0, 1.0)


def decays(name: str, p: torch.Tensor) -> bool:
    """The authors' grouping (timm add_weight_decay): no decay for 1-D
    parameters and biases."""
    return p.ndim > 1 and not name.endswith(".bias")


def adamw(params: dict, grads: dict, moments: dict, step: int, lr: float, cfg: dict) -> None:
    """One AdamW step in place on ``params`` (name -> tensor); ``moments``
    (name -> (m, v)) is filled at the first step; ``step`` counts from 1."""
    b1, b2, eps = cfg["beta1"], cfg["beta2"], cfg["eps"]
    bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
    with torch.no_grad():
        for name, p in params.items():
            g = grads[name]
            m, v = moments.setdefault(name, (torch.zeros_like(p), torch.zeros_like(p)))
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            if decays(name, p):
                p.mul_(1 - lr * cfg["weight_decay"])
            p.addcdiv_(m, v.sqrt() / math.sqrt(bc2) + eps, value=-lr / bc1)


def warmup_cosine(step: int, lr: float, epochs: int, warmup_epochs: int,
                  steps_per_epoch: int, min_lr: float = 0.0) -> float:
    """The authors' per-step schedule (util/lr_sched.py): linear warm-up,
    then a half cosine, in fractional epochs."""
    e = step / steps_per_epoch
    if e < warmup_epochs:
        return lr * e / warmup_epochs
    prog = (e - warmup_epochs) / max(epochs - warmup_epochs, 1e-8)
    return min_lr + (lr - min_lr) * 0.5 * (1.0 + math.cos(math.pi * prog))
