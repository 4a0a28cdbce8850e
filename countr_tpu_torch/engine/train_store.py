"""Resident-store training (counterpart of the FSC147 part of
``countr_tpu/engine/train_store.py``): the whole decoded train split lives
on the card and every augmented batch is materialised there from a few
scalars per sample.

Why: the host path re-augments and re-uploads every sample as pixels each
step (reference dataloader: FSC_finetune_cross.py:178-210 +
util/FSC147.py:117-308), and on the card's host that work holds the step
back. FSC147's decoded train split is about 2 GB as uint8 RGB, which fits
many times over in the card's memory. ``build_store`` uploads it once (a
flat [P, 3] uint8 pixel pool, a per-image catalog and a [N, 3, 64, 64, 3]
uint8 exemplar pool), and ``materialize_batch`` re-creates the reference's
geometric augmentation inside the graphed train step (engine/train.py):

- random-crop path: the full-image affine, the horizontal flip and the 384
  crop compose into one 2x3 map (``compose_affine``: 6 floats from the
  host); the card samples the source image bilinearly with cv2's
  semantics (BORDER_CONSTANT 0) from 4 taps gathered from the pool;
- mosaic path: the reference's 2x2 mosaic with linear seam blending
  (util/FSC147.py:177-255) is separable per axis, so each output pixel is
  a weighted sum of up to 2x2 cells, each a 2-tap x 2-tap resize of a
  crop of a resident image. The blend and resize indices and weights are
  computed on the card from 5 scalars per cell (image, top, left, length)
  and the blend width.

The layout differs from the JAX package's, which works around the TPU's
gather: there each pixel is packed into one uint32 lane and each mosaic
cell is two banded matrix products (``_band_matrix``). Here the pool is
[P, 3] uint8 and each mosaic cell is gathered directly: for every output
row the two source rows it blends (one gather of a contiguous strip each,
then their 2-tap lerp), then for every output column the two columns. The
same pixels are read and the same sums computed, in the band products'
order (rows first, then columns, each a two-term sum: the band rows hold
two nonzeros, and adding its zeros is exact), and no matrix product runs,
so TF32 never applies. Indices are int64: a pool near 2^31 pixels would
overflow int32 arithmetic on ``base + y * stride + x``.

The photometric chain and the density synthesis are ``ops/augment.py``'s
(mosaic samples skip the photometric chain, like the reference's clean
cells). Per-step upload: ~100 bytes of geometry and the dot coordinates
per sample.

The MAE pretrain store (``PretrainStore``, the JAX package's layout: a
column-major [w, 384] uint8 pool) makes the RandomResizedCrop(384,
bicubic) + flip of pretraining from ~30 bytes of crop scalars a sample
with two dense band products (``materialize_pretrain_batch``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from countr_tpu_torch.config import EXEMPLAR_SIZE, IMG_SIZE, MAX_SHOTS

# uint8 -> [0, 1] on the device as a product with the float32 reciprocal:
# XLA compiles the JAX package's x / 255.0 so, and the product keeps its bits
INV_255 = 1.0 / 255.0


def upload(arrays: Dict[str, np.ndarray], device, what: str) -> Dict[str, torch.Tensor]:
    """The numpy arrays as tensors on ``device``. On a CUDA device a store
    larger than the card's free memory raises here, naming itself: it
    never falls back to the host path."""
    device = torch.device(device)
    if device.type == "cuda":
        need = sum(a.nbytes for a in arrays.values())
        free, _ = torch.cuda.mem_get_info(device)
        if need > free:
            raise RuntimeError(f"{what}: {need / 1e9:.2f} GB does not fit in the "
                               f"{free / 1e9:.2f} GB free on {device}")
    return {k: torch.from_numpy(np.ascontiguousarray(a)).to(device) for k, a in arrays.items()}


# ---------------------------------------------------------------------------
# Store construction (host, once)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TrainStore:
    """The resident pixel pool and its per-image catalog."""

    ids: List[str]
    pixels: torch.Tensor  # [P, 3] uint8: the images row-major, then IMG_SIZE px of pad
    exemplars: torch.Tensor  # [N, 3, 64, 64, 3] uint8
    base: torch.Tensor  # [N] int64 offset of image row 0 in the pool
    width: torch.Tensor  # [N] int64 (the row stride)
    height: torch.Tensor  # [N] int64
    # host mirrors for the dataset's parameter sampling
    h_np: np.ndarray
    w_np: np.ndarray
    index: Dict[str, int]

    @property
    def arrays(self) -> Dict[str, torch.Tensor]:
        return {"pixels": self.pixels, "exemplars": self.exemplars, "base": self.base,
                "width": self.width, "height": self.height}

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.arrays.values())


def build_store(meta, ids: List[str], device, log=print) -> TrainStore:
    """Decode and flex-resize every image once, flatten into the pixel
    pool, crop the exemplars from the clean image (reference:
    util/FSC147.py:281-299), and upload to ``device``."""
    from countr_tpu_torch.data import transforms as T

    n = len(ids)
    bases = np.zeros(n, np.int64)
    widths = np.zeros(n, np.int64)
    heights = np.zeros(n, np.int64)
    chunks = []
    exemplars = np.zeros((n, MAX_SHOTS, EXEMPLAR_SIZE, EXEMPLAR_SIZE, 3), np.uint8)
    off = 0
    for i, im_id in enumerate(ids):
        img = meta.open_image(im_id)
        w0, h0 = img.size
        nh, nw = T.flex_size(h0, w0)
        u8 = T.pil_resize_u8(img, nh, nw)
        bases[i], widths[i], heights[i] = off, nw, nh
        off += nh * nw
        chunks.append(u8.reshape(-1, 3))
        rects = T.scale_rects(meta.annotations[im_id]["box_examples_coordinates"][:MAX_SHOTS],
                              nh / h0, nw / w0)
        crops = T.crop_exemplars_u8(u8, rects)
        exemplars[i, : crops.shape[0]] = np.clip(np.rint(crops * 255.0), 0, 255).astype(np.uint8)
        if (i + 1) % 500 == 0:
            log(f"store: decoded {i + 1}/{n} images")
    # the JAX package's limit (its pool is int32-indexed), kept so that the
    # two stores hold the same splits
    assert off < 2**31, "pixel pool exceeds int32 indexing"
    # tail pad: a mosaic cell's row strips read up to 384 px past a row
    # start, so the last image's strips stay inside the pool
    chunks.append(np.zeros((IMG_SIZE, 3), np.uint8))
    pool = np.concatenate(chunks, axis=0)
    log(f"store: {n} images, {off * 3 / 1e6:.0f} MB pixels + {exemplars.nbytes / 1e6:.0f} MB "
        f"exemplars -> {device}")
    dev = upload({"pixels": pool, "exemplars": exemplars, "base": bases, "width": widths,
                  "height": heights}, device, "the train store")
    return TrainStore(ids=list(ids), pixels=dev["pixels"], exemplars=dev["exemplars"],
                      base=dev["base"], width=dev["width"], height=dev["height"],
                      h_np=heights.copy(), w_np=widths.copy(),
                      index={im_id: i for i, im_id in enumerate(ids)})


# ---------------------------------------------------------------------------
# Materialisation on the device
# ---------------------------------------------------------------------------


def _gather_px(pixels: torch.Tensor, idx: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """int64 pool indices [...] -> float pixels [..., 3] in [0, 255]; taps
    with ok False read index 0 and contribute 0 (cv2 BORDER_CONSTANT). The
    /255 is applied once, by the caller, on the blended output."""
    v = pixels[torch.where(ok, idx, torch.zeros_like(idx))].float()
    return v * ok[..., None].float()


def _bilinear_flat(pixels, base, stride, h, w, sx, sy) -> torch.Tensor:
    """cv2-style bilinear samples of resident images at float coordinates
    sx, sy [B, 384, 384], border constant 0; base, stride, h, w are [B, 1, 1]
    int64. Returns [B, 384, 384, 3]."""
    x0f, y0f = torch.floor(sx), torch.floor(sy)
    fx, fy = (sx - x0f)[..., None], (sy - y0f)[..., None]
    x0, y0 = x0f.long(), y0f.long()

    def tap(yy, xx):
        ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        idx = (base + torch.minimum(yy.clamp_min(0), h - 1) * stride
               + torch.minimum(xx.clamp_min(0), w - 1))
        return _gather_px(pixels, idx, ok)

    p00, p01 = tap(y0, x0), tap(y0, x0 + 1)
    p10, p11 = tap(y0 + 1, x0), tap(y0 + 1, x0 + 1)
    top = p00 * (1 - fx) + p01 * fx
    bot = p10 * (1 - fx) + p11 * fx
    # one end-scale: the blend is linear, so scaling the output equals
    # scaling the taps up to float ulps (the JAX package's order)
    return (top * (1 - fy) + bot * fy) * INV_255


def _affine_sample(pixels, base, stride, h, w, C, d) -> torch.Tensor:
    """The composed affine + flip + crop samples out(y, x) = src(C @ (x, y)
    + d) of a batch: the reference's cv2.warpAffine -> hflip -> 384 crop
    chain as one map (reference: util/FSC147.py:143-174, :257-262).
    base, stride, h, w [B]; C [B, 2, 2], d [B, 2]. Returns [B, 384, 384, 3]."""
    xs = torch.arange(IMG_SIZE, dtype=torch.float32, device=C.device)
    gy, gx = torch.meshgrid(xs, xs, indexing="ij")  # gx[r, c] = c, gy[r, c] = r
    c = C.float().reshape(-1, 2, 2, 1, 1)
    dd = d.float().reshape(-1, 2, 1, 1)

    def fma(a, x, p):
        # a * x + p rounded once, as the fused multiply-add XLA emits for
        # the JAX package's c0 * gx + c1 * gy (the float64 product of two
        # float32 is exact): a coordinate one ulp away (6e-5 px past 512)
        # would move a tap weight by as much
        return (a.double() * x.double() + p.double()).float()

    sx = fma(c[:, 0, 0], gx, c[:, 0, 1] * gy) + dd[:, 0]
    sy = fma(c[:, 1, 0], gx, c[:, 1, 1] * gy) + dd[:, 1]
    b3 = [t.reshape(-1, 1, 1) for t in (base, stride, h, w)]
    return _bilinear_flat(pixels, *b3, sx, sy)


def _resize_map(out_pos, length, r_total):
    """cv2 INTER_LINEAR half-pixel 2-tap map from scalars: cell coordinates
    out_pos [K, 384] (float) of crops of ``length`` [K, 1] resized to
    ``r_total`` [K, 1] -> local source taps (s0, s1, weight of s1)."""
    # rounded once, as the fused multiply-add XLA emits for the JAX
    # package's (out_pos + 0.5) * ratio - 0.5 (see _affine_sample)
    f = ((out_pos + 0.5).double() * (length.float() / r_total.float()).double() - 0.5).float()
    s = torch.floor(f)
    f = f - s
    s = s.long()
    lo = s < 0
    s = torch.where(lo, torch.zeros_like(s), s)
    f = torch.where(lo, torch.zeros_like(f), f)
    hi = s >= length - 1
    s = torch.where(hi, (length - 1).expand_as(s), s)
    f = torch.where(hi, torch.zeros_like(f), f)
    return s, torch.minimum(s + 1, length - 1), f


def _mosaic_axis(r, bl, r_total, is_second: bool):
    """Per-axis blend weight and cell-space coordinate of the output
    indices r [384] for blend widths bl [K, 1], transcribing the seam
    arithmetic of ``data/fsc147.py _blend_mosaic`` (reference:
    util/FSC147.py:236-255). ``is_second`` selects the bottom / right cell
    of a pair. Returns (w [K, 384] float, cy [K, 384] int64)."""
    blf = bl.float()
    rf = r.float()
    one, zero = torch.ones_like(blf * rf), torch.zeros_like(blf * rf)
    if not is_second:
        # the top / left cell: rows bl + r for r <= 191, and its seam
        # contribution rows R - 1 - bl + (r - 192) for 192 <= r <= 191 + bl
        w = torch.where(
            r < 192 - bl, one,
            torch.where(r <= 191, (191.0 - rf + blf) / (2 * blf),
                        torch.where(r <= 191 + bl, (blf - rf + 192.0) / (2 * blf), zero)))
        cy = torch.where(r <= 191, bl + r, r_total - 1 - bl + (r - 192))
    else:
        w = torch.where(
            r < 192 - bl, zero,
            torch.where(r <= 191, (blf - 191.0 + rf) / (2 * blf),
                        torch.where(r <= 191 + bl, (rf - 192.0 + blf) / (2 * blf), one)))
        cy = torch.where(r >= 192, bl + (r - 192), bl - (191 - r))
    return w, torch.minimum(cy.clamp_min(0), r_total - 1)


# cell layout [0 TL, 1 BL, 2 TR, 3 BR]: (second along y, second along x)
_CELLS = ((False, False), (True, False), (False, True), (True, True))


def _mosaic_sample(pixels, bases, strides, tops, lefts, lengths, bl) -> torch.Tensor:
    """2x2 mosaic materialisation of K samples: per-cell args [K, 4] int64
    (cell layout [0 TL, 1 BL, 2 TR, 3 BR], reference:
    util/FSC147.py:236-255), blend widths bl [K]. Returns [K, 384, 384, 3].

    Per cell: for each output row r its two local source rows y0[r],
    y1[r] are gathered as contiguous 384-px strips from (left, top + y) and
    lerped, rows = (1 - fy) wy * strip(y0) + fy wy * strip(y1); then each
    output column c takes its two columns x0[c], x1[c] of those rows the
    same way. Strip columns past the crop (b >= length) are read, from the
    next row or the pool's tail pad, and never weighted (x1 <= length - 1)."""
    dev = pixels.device
    bl = bl.long().reshape(-1, 1)
    r_total = 192 + 2 * bl
    r = torch.arange(IMG_SIZE, device=dev)
    cols = torch.arange(IMG_SIZE, device=dev)
    k = bl.shape[0]
    out = torch.zeros((k, IMG_SIZE, IMG_SIZE, 3), device=dev)
    for i, (second_y, second_x) in enumerate(_CELLS):
        wy, cy = _mosaic_axis(r, bl, r_total, second_y)
        wx, cx = _mosaic_axis(r, bl, r_total, second_x)
        length = lengths[:, i : i + 1]
        y0, y1, fy = _resize_map(cy.float(), length, r_total)
        x0, x1, fx = _resize_map(cx.float(), length, r_total)
        start = bases[:, i : i + 1] + tops[:, i : i + 1] * strides[:, i : i + 1] \
            + lefts[:, i : i + 1]  # [K, 1]
        stride = strides[:, i : i + 1]

        def strip(y):  # [K, 384 out rows] -> [K, 384, 384 strip cols, 3]
            return pixels[(start + y * stride)[:, :, None] + cols].float()

        ay, by = ((1.0 - fy) * wy)[..., None, None], (fy * wy)[..., None, None]
        rows = ay * strip(y0) + by * strip(y1)
        ax, bx = ((1.0 - fx) * wx)[:, None, :, None], (fx * wx)[:, None, :, None]

        def column(x):  # [K, 384 out cols] -> [K, 384 rows, 384 out cols, 3]
            return torch.gather(rows, 2, x[:, None, :, None].expand(-1, IMG_SIZE, -1, 3))

        out = out + (ax * column(x0) + bx * column(x1))
    # one end-scale: the lerps and the 4-cell sum are linear, so /255
    # commutes to the output
    return torch.clamp(out * INV_255, 0.0, 1.0)


def mosaic_bucket(k: int, batch_size: int) -> int:
    """Smallest mosaic-slot bucket >= k (0 / 2 / 4 / B): few distinct step
    variants, while most of the mosaic work of a batch with few mosaic
    samples is skipped (at the reference's 25% mosaic rate and batch 8,
    E[slots] ~ 2.7 against B = 8). The finetune CLI does not bucket, as
    the JAX package's does not: kept for callers with mosaic-heavy data."""
    for b in (0, 2, 4):
        if k <= b <= batch_size:
            return b
    return batch_size


def sort_mosaic_first(batch: Dict) -> tuple:
    """Stable host-side reorder of a collated store batch so the mosaic
    samples form a prefix (training is order-invariant within a batch);
    returns (batch, k), k the number of mosaic samples. Pass
    n_mosaic=mosaic_bucket(k, B) so that only the prefix pays the mosaic
    work."""
    m = np.asarray(batch["is_mosaic"])
    order = np.argsort(-m, kind="stable")
    k = int((m > 0).sum())

    def reorder(v):
        if isinstance(v, np.ndarray) and v.ndim >= 1 and v.shape[0] == m.shape[0]:
            return v[order]
        if isinstance(v, list) and len(v) == m.shape[0]:
            return [v[i] for i in order]
        return v

    return {key: reorder(v) for key, v in batch.items()}, k


def materialize_batch(store_arrays: Dict, batch: Dict, n_mosaic=None):
    """Batch assembly on the store's device from per-sample geometry.

    batch fields (leading dim B): img_idx [B]; affine_C [B, 2, 2],
    affine_d [B, 2] float; is_mosaic [B]; cell_idx [B, 4]; cell_top /
    cell_left / cell_len [B, 4]; blend_l [B]. Returns (images float32
    [B, 384, 384, 3], boxes float32 [B, 3, 64, 64, 3]).

    n_mosaic (static): the number of leading slots that may be mosaic
    samples (see ``sort_mosaic_first``). None = any slot (every sample pays
    the mosaic path, the safe default); 0..B = only the prefix does. A
    mosaic sample outside the prefix silently gets its affine
    materialisation (the identity map): callers must sort and bucket."""
    px = store_arrays["pixels"]
    base, width, height = (store_arrays[k] for k in ("base", "width", "height"))
    idx = batch["img_idx"].long()
    imgs = _affine_sample(px, base[idx], width[idx], height[idx], width[idx],
                          batch["affine_C"], batch["affine_d"])
    b = imgs.shape[0]
    k = b if n_mosaic is None else int(n_mosaic)
    if k > 0:
        cidx = batch["cell_idx"][:k].long()
        mos = _mosaic_sample(px, base[cidx], width[cidx], batch["cell_top"][:k].long(),
                             batch["cell_left"][:k].long(), batch["cell_len"][:k].long(),
                             batch["blend_l"][:k])
        sel = (batch["is_mosaic"][:k] > 0).reshape(k, 1, 1, 1)
        imgs = torch.cat([torch.where(sel, mos, imgs[:k]), imgs[k:]])
    boxes = store_arrays["exemplars"][idx].float() * INV_255
    return imgs, boxes


# ---------------------------------------------------------------------------
# Resident validation split (fixed 384^2 samples; per-epoch upload: indices)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ValStore:
    """The resident validation split: the per-epoch validation (reference:
    FSC_finetune_cross.py:328-350) re-uploads every image each epoch, but
    its samples are fixed 384^2 ones, so they live on the card and an eval
    batch is an index gather. Only the true count is kept (the metrics
    never read the density map)."""

    images: torch.Tensor  # [N, 384, 384, 3] uint8 (exact: PIL's output)
    boxes: torch.Tensor  # [N, 3, 64, 64, 3] float32
    gt_cnt: torch.Tensor  # [N] float32: sum(gt_density) / 60
    n: int

    @property
    def arrays(self) -> Dict[str, torch.Tensor]:
        return {"images": self.images, "boxes": self.boxes, "gt_cnt": self.gt_cnt}

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.arrays.values())


def build_val_store(val_ds, device, log=print) -> ValStore:
    """Materialise a ValDataset (384^2 resize, sigma 4 / radius 7 density,
    exemplar crops) once and upload it to ``device``."""
    from countr_tpu_torch.config import DENSITY_SCALE

    n = len(val_ds)
    images = np.zeros((n, IMG_SIZE, IMG_SIZE, 3), np.uint8)
    boxes = np.zeros((n, MAX_SHOTS, EXEMPLAR_SIZE, EXEMPLAR_SIZE, 3), np.float32)
    gt = np.zeros(n, np.float32)
    for i in range(n):
        s = val_ds[i]
        images[i] = np.clip(np.rint(s["image"] * 255.0), 0, 255)
        boxes[i] = s["boxes"]
        gt[i] = float(s["gt_density"].sum()) / DENSITY_SCALE
        if (i + 1) % 200 == 0:
            log(f"val store: {i + 1}/{n}")
    log(f"val store: {n} samples, {(images.nbytes + boxes.nbytes) / 1e6:.0f} MB -> {device}")
    dev = upload({"images": images, "boxes": boxes, "gt": gt}, device, "the validation store")
    return ValStore(images=dev["images"], boxes=dev["boxes"], gt_cnt=dev["gt"], n=n)


# ---------------------------------------------------------------------------
# MAE pretrain store: RandomResizedCrop(384, bicubic) + flip on the device
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PretrainCatalog:
    """The host's part of a ``PretrainStore``: what ``PretrainDataset`` draws
    a crop from (small and picklable, for process workers)."""

    index: Dict[str, int]
    w_np: np.ndarray  # [N] logical width (the stored row count)
    t_np: np.ndarray  # [N] int8: 1 = stored transposed (a portrait original)


@dataclasses.dataclass
class PretrainStore:
    """The resident store of MAE pretraining (the JAX ``PretrainStore``).
    Every image is resized to exactly 384 logical rows (the smaller side
    384; a portrait transposed first) and stored column-major as [w, 384]
    pixels: with the fixed 384 stride one sample's slab is one static-size
    run of ``max_w * 384`` pixels from its base, gathered inside the graph
    without reading the base back to the host. The pool is tail-padded by
    ``max_w * 384`` pixels, so the last image's slab stays inside it
    whatever its width. The reference crops the ~384-side originals
    (util/FSC147.py:360-365); normalising the smaller side to 384 first
    leaves a scale-invariant crop's distribution as it is."""

    ids: List[str]
    pixels: torch.Tensor  # [P, 3] uint8: the images as [w, 384], then the pad
    base: torch.Tensor  # [N] int64 offset of an image's first pixel
    width: torch.Tensor  # [N] int64 logical width
    max_w: int
    catalog: PretrainCatalog

    @property
    def arrays(self) -> Dict[str, torch.Tensor]:
        return {"pixels": self.pixels, "base": self.base, "width": self.width}

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.arrays.values())


def build_pretrain_store(meta, ids: List[str], device, log=print) -> PretrainStore:
    """Decode and resize every image once (PIL bilinear, the smaller side to
    384), lay it out column-major and upload the pool to ``device``."""
    from countr_tpu_torch.data import transforms as T

    n = len(ids)
    bases = np.zeros(n, np.int64)
    widths = np.zeros(n, np.int64)
    tflags = np.zeros(n, np.int8)
    chunks = []
    off = 0
    for i, im_id in enumerate(ids):
        img = meta.open_image(im_id)
        w0, h0 = img.size
        if h0 <= w0:  # landscape: 384 logical rows
            u8 = T.pil_resize_u8(img, IMG_SIZE, max(IMG_SIZE, round(w0 * IMG_SIZE / h0)))
        else:  # portrait: width 384, its transpose is the logical layout
            u8 = T.pil_resize_u8(img, max(IMG_SIZE, round(h0 * IMG_SIZE / w0)), IMG_SIZE)
            u8 = u8.transpose(1, 0, 2)
            tflags[i] = 1
        bases[i], widths[i] = off, u8.shape[1]
        off += IMG_SIZE * u8.shape[1]
        chunks.append(np.ascontiguousarray(u8.transpose(1, 0, 2)).reshape(-1, 3))
        if (i + 1) % 500 == 0:
            log(f"pretrain store: decoded {i + 1}/{n} images")
    # the JAX package's limit (its base is int32), kept so that the two
    # stores hold the same splits
    assert off < 2**31, "pixel pool exceeds int32 indexing"
    max_w = int(widths.max())
    chunks.append(np.zeros((IMG_SIZE * max_w, 3), np.uint8))
    pool = np.concatenate(chunks, axis=0)
    log(f"pretrain store: {n} images, {pool.nbytes / 1e6:.0f} MB -> {device}")
    dev = upload({"pixels": pool, "base": bases, "width": widths}, device, "the pretrain store")
    return PretrainStore(ids=list(ids), pixels=dev["pixels"], base=dev["base"],
                         width=dev["width"], max_w=max_w,
                         catalog=PretrainCatalog({im_id: i for i, im_id in enumerate(ids)},
                                                 widths.copy(), tflags))


def _bicubic_kernel(x: torch.Tensor) -> torch.Tensor:
    """PIL's and torchvision's bicubic filter (a = -0.5)."""
    a = -0.5
    ax = x.abs()
    w1 = (a + 2.0) * ax ** 3 - (a + 3.0) * ax ** 2 + 1.0
    w2 = a * ax ** 3 - 5.0 * a * ax ** 2 + 8.0 * a * ax - 4.0 * a
    return torch.where(ax <= 1.0, w1, torch.where(ax < 2.0, w2, torch.zeros_like(ax)))


def _bicubic_band(n_src: int, start: torch.Tensor, length: torch.Tensor,
                  out: int = IMG_SIZE) -> torch.Tensor:
    """PIL's antialiased bicubic resize of the crops [start, start + length)
    [B] of an axis of ``n_src`` pixels to ``out``, as dense weights
    [B, n_src, out]: the filter's support scales with the downscale factor
    and each output's weights are renormalised over its in-crop taps
    (reference resize: util/FSC147.py:362)."""
    dev = start.device
    start = start.float()[:, None, None]
    stop = start + length.float()[:, None, None]
    # length / out as XLA compiles it: a product with the float32 reciprocal
    scale = length.float()[:, None, None] * (1.0 / out)
    fs = torch.clamp_min(scale, 1.0)
    j = torch.arange(out, dtype=torch.float32, device=dev)[None, None, :]
    i = torch.arange(n_src, dtype=torch.float32, device=dev)[None, :, None]
    # rounded once, as the fused multiply-add XLA emits for the JAX
    # package's start + (j + 0.5) * scale: a centre one ulp away (6e-5 px
    # past 512) moves a tap weight by as much
    center = (start.double() + (j + 0.5).double() * scale.double()).float()
    w = _bicubic_kernel((i + 0.5 - center) / fs) * ((i >= start) & (i < stop)).float()
    return w / torch.clamp_min(w.sum(dim=1, keepdim=True), 1e-8)


PRETRAIN_KEYS = ("img_idx", "crop_top", "crop_left", "crop_h", "crop_w", "transposed", "flip")


def check_pretrain_crop(img_size: int, patch_size: int) -> None:
    """Raise ValueError where ``materialize_pretrain_batch`` (or the host
    path's crop) cannot make the model's input: a crop side that is not a
    positive multiple of the model's patch, whose patch grid would drop
    pixels that the loss's patchify then cannot split."""
    if img_size <= 0 or patch_size <= 0 or img_size % patch_size:
        raise ValueError(
            f"the pretrain crop is img_size x img_size = {img_size} px, which {patch_size}-px "
            f"patches do not tile: the store and the host loader crop to the model's "
            f"img_size, so the preset needs an img_size that is a multiple of its patch_size")


def materialize_pretrain_batch(store_arrays: Dict, batch: Dict, max_w: int,
                               out: int = IMG_SIZE) -> torch.Tensor:
    """RandomResizedCrop(out, bicubic) + horizontal flip on the store's
    device (the JAX ``materialize_pretrain_batch``, which crops 384).

    batch: img_idx [B]; crop_top / crop_left / crop_h / crop_w [B] (the crop
    in stored coordinates); transposed [B]; flip [B]. Returns [B, out, out,
    3] float32 in [0, 1]: the model's img_size (378 for ViT-H/14); the
    stored images and the crop's draw are those of 384 whatever ``out``.

    Each sample's slab is ``max_w * 384`` pixels from its base, gathered at
    base + arange: a static length, so nothing is read back to the host
    (where JAX takes a ``dynamic_slice``). Stored rows past the image's
    width belong to the next image or the pad, and the x band never weights
    them (left + w <= width). The two band products run in full fp32 (no
    TF32: the JAX package's Precision.HIGHEST) whatever the process's flags
    are, also while a graph is captured. The transpose and the flip are
    selected per sample on the device, both branches computed."""
    from countr_tpu_torch.engine.device_pipeline import fp32_products

    px = store_arrays["pixels"]
    n = max_w * IMG_SIZE
    idx = batch["img_idx"].long()
    flat = px[store_arrays["base"][idx][:, None] + torch.arange(n, device=px.device)]
    img = flat.reshape(-1, max_w, IMG_SIZE, 3).float() * INV_255  # [B, x_stored, y_stored, 3]
    wy = _bicubic_band(IMG_SIZE, batch["crop_top"], batch["crop_h"], out)  # [B, 384 src, out]
    wx = _bicubic_band(max_w, batch["crop_left"], batch["crop_w"], out)  # [B, max_w, out]
    with fp32_products():
        out = torch.einsum("bxyc,bxo->boyc", img, wx)
        out = torch.einsum("boyc,byj->bojc", out, wy)
    # out is [x_out, y_out]: the logical layout's transpose, which is the
    # final orientation of a transposed (portrait) sample
    b = out.shape[0]
    out = torch.where(batch["transposed"].reshape(b, 1, 1, 1) > 0, out, out.transpose(1, 2))
    out = torch.where(batch["flip"].reshape(b, 1, 1, 1) > 0, out.flip(2), out)
    return torch.clamp(out, 0.0, 1.0)


# ---------------------------------------------------------------------------
# Host parameter sampling
# ---------------------------------------------------------------------------


def compose_affine(M: np.ndarray, flip: bool, left: int, top: int, nw: int) -> tuple:
    """Forward cv2 warp matrix M [2, 3] + hflip + crop(top, left) -> the
    single map src = C @ (x_out, y_out) + d of ``_affine_sample``."""
    m2 = M[:, :2]
    off = M[:, 2]
    inv_a = np.linalg.inv(m2)
    inv_b = -inv_a @ off
    s = -1.0 if flip else 1.0
    u0 = (nw - 1 - left) if flip else left
    C = inv_a @ np.diag([s, 1.0])
    d = inv_a @ np.asarray([u0, top], np.float64) + inv_b
    return C.astype(np.float32), d.astype(np.float32)
