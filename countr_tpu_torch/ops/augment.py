"""Device-side training augmentation (counterpart of
``countr_tpu/ops/augment.py``): the photometric chain and the density
synthesis of ``--device_aug``, as torch ops inside the finetune step.

The host keeps only the uint8 geometry (affine, flip, crop, mosaic) and
ships a uint8 crop and the dot coordinates (``data/fsc147.py
TrainDataset(device_aug=True)``); the per-pixel work runs here, on the
card, inside the step's CUDA graph. The JAX package computes this chain
outside any Pallas kernel, so it is plain torch ops here too.

The random draws are apart from the transforms: ``draw_photometric``
makes every factor from one ``torch.Generator`` (the noise, the four
jitter factors, the op order and the blur sigma, per sample), and
``photometric`` is a deterministic function of the image and the draws,
so a test can feed the JAX package's functions the same factors. The
draws are other bits than JAX's ``jax.random`` streams (the same
distributions).

The jitter's random op order: JAX applies a drawn permutation as four
``lax.switch`` steps. A CUDA graph cannot branch on the device, and a host
read of the permutation would break the replay, so each of the four
positions applies all four ops and selects one result by the
permutation's one-hot (``torch.where``): four times the work of one
sequential pass, the hue round trip included.

Reference pipeline modelled (reference: util/FSC147.py:117-308): gaussian
noise N(0, 0.1) clip -> ColorJitter(0.25, 0.15, 0.15, 0.15) ->
GaussianBlur(kernel (7, 9), sigma U(0.1, 2)); density = gaussian_filter
(dot map, sigma 1) * 60. Mosaic samples get no photometric change, as in
the reference (``apply_photo`` 0). The density synthesis equals scipy's
gaussian_filter (sigma 1, truncate 4, reflect) and the blur equals
cv2.GaussianBlur's kernel, to float tolerance.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
import torch

from countr_tpu_torch.config import DENSITY_SCALE, IMG_SIZE
from countr_tpu_torch.parallel.mesh import rows_of

_GRAY = (0.299, 0.587, 0.114)  # ITU-R 601, as the host path
JITTER = (0.25, 0.15, 0.15, 0.15)  # brightness, contrast, saturation, hue
NOISE_STD = 0.1
BLUR_SIGMA = (0.1, 2.0)


# ---------------------------------------------------------------------------
# The random draws
# ---------------------------------------------------------------------------


def draw_photometric(b: int, h: int, w: int, generator: torch.Generator,
                     noise_std: float = NOISE_STD, jitter=JITTER,
                     sigma_range: Tuple[float, float] = BLUR_SIGMA, rank: int = 0,
                     world: int = 1) -> Dict[str, torch.Tensor]:
    """Every random factor of ``photometric`` for a batch of b [h, w, 3]
    images, from ``generator`` on its device: ``noise`` [b, h, w, 3]
    (already times noise_std), ``factors`` [b, 4] (brightness, contrast
    and saturation factors uniform around 1, the hue shift uniform in
    +-hue, as a fraction of a turn), ``perm`` [b, 4] (a uniform random op
    order: the argsort of uniforms) and ``sigma`` [b] (the blur's). A
    data-parallel rank (``rank`` of ``world``, b its rows) draws the global
    batch's b * world and keeps its rows (``parallel.mesh.rows_of``)."""
    dev = generator.device
    b = b * world
    noise = torch.randn((b, h, w, 3), generator=generator, device=dev) * noise_std
    u = torch.rand((b, 4), generator=generator, device=dev)
    lo = [max(0.0, 1.0 - f) for f in jitter[:3]] + [-jitter[3]]
    hi = [1.0 + f for f in jitter[:3]] + [jitter[3]]
    factors = torch.stack([lo[k] + u[:, k] * (hi[k] - lo[k]) for k in range(4)], 1)
    perm = torch.argsort(torch.rand((b, 4), generator=generator, device=dev), dim=1)
    s = torch.rand((b,), generator=generator, device=dev)
    sigma = sigma_range[0] + s * (sigma_range[1] - sigma_range[0])
    draws = {"noise": noise, "factors": factors, "perm": perm, "sigma": sigma}
    return {k: rows_of(v, rank, world) for k, v in draws.items()}


# ---------------------------------------------------------------------------
# Colour jitter (torchvision semantics), per-sample factors [b]
# ---------------------------------------------------------------------------


def _per_sample(f: torch.Tensor, ndim: int) -> torch.Tensor:
    return f.reshape(f.shape[0], *([1] * (ndim - 1)))


def _blend(img, other, factor):
    return torch.clamp(factor * img + (1.0 - factor) * other, 0.0, 1.0)


def _gray(img):
    return img[..., 0] * _GRAY[0] + img[..., 1] * _GRAY[1] + img[..., 2] * _GRAY[2]


def brightness(img, f):
    return _blend(img, 0.0, _per_sample(f, img.dim()))


def contrast(img, f):
    mean = _gray(img).mean(dim=(1, 2))
    return _blend(img, _per_sample(mean, img.dim()), _per_sample(f, img.dim()))


def saturation(img, f):
    return _blend(img, _gray(img)[..., None], _per_sample(f, img.dim()))


def hue(img, shift):
    """Rotate the hue by ``shift`` [b] (a fraction of a turn in [-0.5,
    0.5]) through an RGB -> HSV -> RGB round trip."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    v = maxc
    d = maxc - minc
    safe_d = torch.where(d > 0, d, torch.ones_like(d))
    s = torch.where(maxc > 0, d / torch.where(maxc > 0, maxc, torch.ones_like(maxc)),
                    torch.zeros_like(maxc))
    rc = (maxc - r) / safe_d
    gc = (maxc - g) / safe_d
    bc = (maxc - b) / safe_d
    h = torch.where(maxc == r, bc - gc, torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.remainder(h / 6.0, 1.0)
    h = torch.where(d > 0, h, torch.zeros_like(h))

    h = torch.remainder(h + _per_sample(shift, h.dim()), 1.0)
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.to(torch.int32), 6)

    def select(*vals):
        out = vals[5]
        for k in range(4, -1, -1):
            out = torch.where(i == k, vals[k], out)
        return out

    rgb = torch.stack([select(v, q, p, p, t, v), select(t, v, v, q, p, p),
                       select(p, p, t, v, v, q)], dim=-1)
    return torch.clamp(rgb, 0.0, 1.0)


OPS = (brightness, contrast, saturation, hue)


def color_jitter(img: torch.Tensor, factors: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """The four ops in each sample's order ``perm`` [b, 4] with its
    ``factors`` [b, 4], without a branch: at each position every op runs
    and the permutation's one-hot selects one result."""
    x = img
    for pos in range(4):
        outs = [op(x, factors[:, k]) for k, op in enumerate(OPS)]
        sel = _per_sample(perm[:, pos], img.dim())
        x = outs[0]
        for k in range(1, 4):
            x = torch.where(sel == k, outs[k], x)
    return x


# ---------------------------------------------------------------------------
# Gaussian blur (cv2.GaussianBlur kernel (7, 9), per-sample sigma)
# ---------------------------------------------------------------------------


def _reflect101(x: torch.Tensor, r: int, dim: int) -> torch.Tensor:
    """Pad ``dim`` by r on each side, reflected without the edge sample
    (cv2's BORDER_REFLECT_101, numpy's 'reflect')."""
    n = x.shape[dim]
    head = x.narrow(dim, 1, r).flip(dim)
    tail = x.narrow(dim, n - 1 - r, r).flip(dim)
    return torch.cat([head, x, tail], dim)


def _symmetric(x: torch.Tensor, r: int, dim: int) -> torch.Tensor:
    """Pad ``dim`` by r on each side, reflected with the edge sample
    (scipy.ndimage's 'reflect', numpy's 'symmetric')."""
    n = x.shape[dim]
    return torch.cat([x.narrow(dim, 0, r).flip(dim), x, x.narrow(dim, n - r, r).flip(dim)], dim)


def _gauss_kernel(sigma: torch.Tensor, ksize: int) -> torch.Tensor:
    """cv2.getGaussianKernel per sample: exp(-(i - c)^2 / (2 sigma^2)),
    normalised; [b, ksize]."""
    c = (ksize - 1) / 2.0
    x = torch.arange(ksize, dtype=torch.float32, device=sigma.device) - c
    s = sigma[:, None]
    k = torch.exp(-(x * x) / (2.0 * s * s))
    return k / k.sum(dim=1, keepdim=True)


def gaussian_blur(img: torch.Tensor, sigma: torch.Tensor, kx: int = 7, ky: int = 9):
    """Separable gaussian blur of [b, h, w, 3] images with reflect-101
    padding, one sigma [b] for both axes: cv2.GaussianBlur(ksize=(7, 9),
    sigmaX=sigmaY=sigma) (reference blur: util/FSC147.py:373)."""
    bsz, h, w = img.shape[:3]
    khx, khy = _gauss_kernel(sigma, kx), _gauss_kernel(sigma, ky)
    ry, rx = ky // 2, kx // 2
    pad = _reflect101(_reflect101(img, ry, 1), rx, 2)
    out = torch.zeros_like(pad[:, :, :w])
    for i in range(kx):
        out = out + khx[:, i].reshape(bsz, 1, 1, 1) * pad[:, :, i : i + w]
    out2 = torch.zeros_like(img)
    for j in range(ky):
        out2 = out2 + khy[:, j].reshape(bsz, 1, 1, 1) * out[:, j : j + h]
    return out2


# ---------------------------------------------------------------------------
# Density synthesis from dot coordinates (scipy's gaussian_filter)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def scipy_gauss_kernel(sigma: float, truncate: float = 4.0):
    """scipy.ndimage.gaussian_filter's 1-D kernel as Python floats (of
    float32): radius int(truncate * sigma + 0.5), normalised."""
    radius = int(truncate * float(sigma) + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / float(sigma)) ** 2)
    return tuple(float(v) for v in (k / k.sum()).astype(np.float32)), radius


def density_from_dots(dots: torch.Tensor, n_dots: torch.Tensor, h: int = IMG_SIZE,
                      w: int = IMG_SIZE, sigma: float = 1.0,
                      scale: float = DENSITY_SCALE) -> torch.Tensor:
    """[b, K, 2] integer (x, y) dot coordinates, the first n_dots [b] of
    each real -> the smoothed, scaled densities [b, h, w]: a binary dot
    map (duplicate dots overwrite, as the reference's map[y, x] = 1,
    util/FSC147.py:266-268), then gaussian_filter(sigma, reflect) *
    scale."""
    k, radius = scipy_gauss_kernel(sigma)
    bsz, kmax = dots.shape[:2]
    dots = dots.long()
    valid = (torch.arange(kmax, device=dots.device)[None, :] < n_dots.reshape(bsz, 1)).float()
    xs = dots[..., 0].clamp(0, w - 1)
    ys = dots[..., 1].clamp(0, h - 1)
    flat = (torch.arange(bsz, device=dots.device)[:, None] * (h * w) + ys * w + xs).reshape(-1)
    dmap = torch.zeros(bsz * h * w, device=dots.device)
    dmap = dmap.scatter_reduce(0, flat, valid.reshape(-1), reduce="amax").reshape(bsz, h, w)
    pad = _symmetric(_symmetric(dmap, radius, 1), radius, 2)
    out = torch.zeros_like(pad[:, :h])
    for i in range(2 * radius + 1):
        out = out + k[i] * pad[:, i : i + h]
    out2 = torch.zeros_like(dmap)
    for j in range(2 * radius + 1):
        out2 = out2 + k[j] * out[:, :, j : j + w]
    return out2 * scale


# ---------------------------------------------------------------------------
# The chain and the batched entry
# ---------------------------------------------------------------------------


def photometric(img: torch.Tensor, draws: Dict[str, torch.Tensor]) -> torch.Tensor:
    """noise -> jitter -> blur on [b, h, w, 3] images in [0, 1], the
    reference's photometric chain (reference: util/FSC147.py:134-141),
    with the factors of ``draw_photometric``."""
    img = torch.clamp(img + draws["noise"], 0.0, 1.0)
    img = color_jitter(img, draws["factors"], draws["perm"])
    return gaussian_blur(img, draws["sigma"])


def augment_batch(images_u8: torch.Tensor, dots: torch.Tensor, n_dots: torch.Tensor,
                  apply_photo: torch.Tensor, generator: torch.Generator,
                  density_sigma: float = 1.0, rank: int = 0,
                  world: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """The batched device augmentation: images_u8 [b, 384, 384, 3] uint8
    host-geometry crops, dots [b, K, 2] (x, y) in crop coordinates,
    n_dots [b], apply_photo [b] (0 for mosaic samples). Draws from
    ``generator`` (a data-parallel rank: ``draw_photometric``'s ``rank`` and
    ``world``); returns (images float32, gt_density float32
    [b, 384, 384])."""
    bsz, h, w = images_u8.shape[:3]
    img = images_u8.float() / 255.0
    draws = draw_photometric(bsz, h, w, generator, rank=rank, world=world)
    img = torch.where(_per_sample(apply_photo, 4) > 0, photometric(img, draws), img)
    return img, density_from_dots(dots, n_dots, h, w, sigma=density_sigma)
