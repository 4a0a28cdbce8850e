"""Counting inference engine (counterpart of
``countr_tpu/engine/inference.py``: ``CountResult``,
``small_exemplar_count``, ``CountingEngine`` and ``count_image``).

1. exemplar crops are embedded ONCE per image;
2. every sliding window (and all 9 grid crops' windows) is gathered into
   fixed-size batches of ``batch_windows`` and forwarded on the device;
3. the reference's sequential overlap-halving blend is applied as a
   precomputed weight contraction (engine/stitch.py);
4. the batched path (``count_batch``) keeps images, windows, densities
   and the count readout ON THE DEVICE (engine/device_pipeline.py): one
   uint8 upload per image, two scalars back per density row, and on the
   card the window forward replayed from one CUDA graph per shape.

Behaviour reproduced exactly:
- tiny-exemplar (<10x10) detection triggering 3x3 grid subdivision
  (reference: FSC_test_cross(few-shot).py:264-284); the 9 crops are
  resized back with cv2-INTER_LINEAR-exact 2-tap maps, as a gather and
  lerp in torch on the device;
- test-time normalisation: divide by the mean exemplar-box density of
  the *last* computed density map when it exceeds 1.8 (reference:
  :353-359 — in grid mode that is the 9th crop's map);
- count readout sum/60 (reference: :319, :351).

``count`` is the straight-line single-image path (eager forward, host
stitch) and the parity oracle of ``count_batch`` in the tests.

Images narrower than 384 are padded to one window (narrow_policy="pad",
the default) or counted as 0 as the reference does ("reference").
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from countr_tpu_torch import disable_tf32, resolve_device
from countr_tpu_torch.config import DENSITY_SCALE, EXEMPLAR_SIZE, TTN_THRESHOLD, WINDOW
from countr_tpu_torch.engine.device_pipeline import (
    MAP_KEYS, DevicePipeline, forward_buckets, nan_checked, width_bucket,
)
from countr_tpu_torch.engine.stitch import (
    grid_crop_boxes, resample_maps, stitch, stitch_weights, window_starts,
)
from countr_tpu_torch.models.countr import CounTR
from countr_tpu_torch.utils.profiling import span


@dataclasses.dataclass
class CountResult:
    count: float
    density: Optional[np.ndarray]  # [384, W] stitched (grid: last crop's)
    grid_mode: bool
    e_cnt: float  # exemplar-box density (TTN statistic), 0 if disabled
    raw_count: float  # before TTN division
    n_windows: int  # model-forward windows spent


def small_exemplar_count(rects: Sequence[Sequence[int]]) -> int:
    """Number of tiny exemplars among the first 3 rects (y1, x1, y2, x2)
    (reference: FSC_test_cross(few-shot).py:264-271)."""
    s_cnt = 0
    for rect in list(rects)[:3]:
        if rect[2] - rect[0] < 10 and rect[3] - rect[1] < 10:
            s_cnt += 1
    return s_cnt


def _as_float(img: np.ndarray) -> np.ndarray:
    if img.dtype == np.uint8:
        return img.astype(np.float32) / 255.0
    return img.astype(np.float32)


def resize_crop(image: torch.Tensor, box, out_h: int, out_w: int) -> torch.Tensor:
    """cv2.resize(image[t:t+ch, l:l+cw], (out_w, out_h), INTER_LINEAR) for
    an [H, W, C] float tensor: a 2-tap gather + lerp along the columns,
    then the rows, with the taps clamped at the crop's edges."""
    t, l, ch, cw = box
    dev = image.device
    x0, x1, fx = (torch.from_numpy(a).to(dev) for a in resample_maps(cw, out_w, l))
    y0, y1, fy = (torch.from_numpy(a).to(dev) for a in resample_maps(ch, out_h, t))
    rows = torch.cat([y0, y1]).long()
    sub = image[rows]  # [2*out_h, W, C]
    fx = fx[None, :, None]
    cols = sub[:, x0.long()] * (1 - fx) + sub[:, x1.long()] * fx
    fy = fy[:, None, None]
    return cols[:out_h] * (1 - fy) + cols[out_h:] * fy


class CountingEngine:
    """Counts objects in H=384, variable-width images.

    model: the port's CounTR (moved to ``device``).
    batch_windows: windows per forward (each forward runs the whole
      model once on a [batch_windows, 384, 384, 3] batch).
    images_bucket: max density rows per device set of ``count_batch``.
    normalization: apply test-time normalization (reference default).
    max_s_cnt: grid-mode trigger threshold (reference --max_s_cnt=1).
    device: None = the CUDA card (raises without one); "cpu" on request.
    devices: ``count_batch``'s window chunks split over these devices
      (``device`` first; ``DevicePipeline``): the JAX package's ``mesh``.
      ``batch_windows`` must be a multiple of their number.
    debug_nans: eager window forwards (no CUDA graph), and the first window
      batch whose density holds a NaN raises ``FloatingPointError``
      (``--debug_nans``).
    """

    def __init__(
        self,
        model: CounTR,
        *,
        batch_windows: int = 16,
        # 48 density rows a set: padding-free middle chunks and ~98%
        # forward-slot occupancy on FSC147-like batches (the JAX package's
        # measurement in bench.py's geometry); density scratch at the
        # widest bucket is 48*384*768*4 B = 54 MB.
        images_bucket: int = 48,
        normalization: bool = True,
        max_s_cnt: int = 1,
        narrow_policy: str = "pad",
        device=None,
        devices=None,
        debug_nans: bool = False,
    ):
        self.device = resolve_device(device)
        # an fp32 stage (the fp32 model, the mixed modes' head) runs its
        # products and convolutions in full fp32; the flags are read when
        # a graph is captured, so they are set before any is
        if model.cfg.computes_fp32:
            disable_tf32()
        self.model = model.to(self.device).eval()
        self.batch_windows = batch_windows
        self.images_bucket = images_bucket
        self.normalization = normalization
        self.max_s_cnt = max_s_cnt
        if narrow_policy not in ("pad", "reference"):
            raise ValueError(f"narrow_policy must be 'pad' or 'reference'; got {narrow_policy!r}")
        self.narrow_policy = narrow_policy
        self.forward_batches = 0  # model forwards run by count (window batches)
        self.h2d_bytes = 0  # pixel, exemplar and plan bytes count_batch uploaded
        self._pipeline = DevicePipeline(self.model, self.device, devices, batch_windows,
                                        debug_nans=debug_nans)
        self._nan_check = nan_checked(lambda w, y: self.model.forward_tokens(w, y)) \
            if debug_nans else None

    @torch.inference_mode()
    def _forward_windows(self, windows: torch.Tensor, y: torch.Tensor) -> np.ndarray:
        """[n, 384, 384, 3] windows on the device -> [n, 384, 384]
        densities (host), in fixed-size chunks of batch_windows."""
        n = windows.shape[0]
        b = self.batch_windows
        outs = []
        for i in range(0, n, b):
            chunk = windows[i : i + b]
            pad = b - chunk.shape[0]
            if pad:
                chunk = torch.cat([chunk, chunk.new_zeros((pad, *chunk.shape[1:]))])
            yb = y[:1].expand(b, *y.shape[1:])
            den = (self._nan_check or self.model.forward_tokens)(chunk, yb)
            self.forward_batches += 1
            outs.append(den[: b - pad].cpu().numpy())
        if not outs:
            return np.zeros((0, WINDOW, WINDOW), np.float32)
        return np.concatenate(outs, 0)

    def _sliding_density(self, image: torch.Tensor, y: torch.Tensor):
        """Stitched density map [384, w] for one 384-row image tensor."""
        h, w = image.shape[:2]
        if w < WINDOW:
            if self.narrow_policy == "reference":
                return np.zeros((h, w), np.float32), 0
            padded = image.new_zeros((h, WINDOW, 3))
            padded[:, :w] = image
            den = self._forward_windows(padded[None], y)[0]
            return den[:, :w].astype(np.float32), 1
        starts, weights = stitch_weights(w)
        windows = torch.stack([image[:, s : s + WINDOW] for s in starts])
        dens = self._forward_windows(windows, y)
        return stitch(dens, starts, weights, w), len(starts)

    @torch.inference_mode()
    def exemplar_tokens(self, boxes: Optional[np.ndarray], shot_num: int) -> torch.Tensor:
        """[k, 64, 64, 3] exemplar crops -> [1, max(shot, 1), C] tokens."""
        dt = self.model.dec_dtype
        if shot_num > 0:
            if boxes is None or boxes.shape[0] < shot_num:
                raise ValueError(f"{shot_num}-shot counting needs {shot_num} exemplar crops")
            b = torch.from_numpy(_as_float(boxes)[None, :shot_num])
        else:
            b = torch.zeros((1, 1, EXEMPLAR_SIZE, EXEMPLAR_SIZE, 3))
        return self.model.encode_exemplars(b.to(self.device, dt), shot_num)

    def count(
        self,
        image: np.ndarray,
        boxes: Optional[np.ndarray] = None,
        rects: Sequence[Sequence[int]] = (),
        shot_num: Optional[int] = None,
    ) -> CountResult:
        """Count objects in ``image`` [384, W, 3] (float in [0,1] or
        uint8). boxes: [k, 64, 64, 3] exemplar crops (None = zero-shot);
        rects: exemplar rectangles (y1, x1, y2, x2) in image coords."""
        if shot_num is None:
            shot_num = 0 if boxes is None else int(boxes.shape[0])
        if image.shape[0] != WINDOW:
            raise ValueError(
                f"engine expects H={WINDOW} rows (test-pipeline geometry, "
                f"reference: FSC_test_cross(few-shot).py:148); got {image.shape}"
            )
        y = self.exemplar_tokens(boxes, shot_num)
        img = torch.from_numpy(_as_float(image)).to(self.device)
        h, w = img.shape[:2]

        grid_mode = small_exemplar_count(rects) >= self.max_s_cnt
        n_windows = 0
        if grid_mode:
            # 9 crops resized back to (h, w), each sliding-window counted;
            # total = sum of the 9 counts (reference: :274-320). All
            # crops' windows ride one stream of window batches.
            resized = self._grid_rows(img)
            pred_cnt = 0.0
            density = None
            if w >= WINDOW:
                starts, weights = stitch_weights(w)
                windows = torch.stack(
                    [r[:, s : s + WINDOW] for r in resized for s in starts]
                )
                dens = self._forward_windows(windows, y)
                n_windows = windows.shape[0]
                per_crop = dens.reshape(9, len(starts), WINDOW, WINDOW)
                for crop_dens in per_crop:
                    density = stitch(crop_dens, starts, weights, w)
                    pred_cnt += float(density.sum() / DENSITY_SCALE)
            else:
                for r_img in resized:
                    density, nw = self._sliding_density(r_img, y)
                    n_windows += nw
                    pred_cnt += float(density.sum() / DENSITY_SCALE)
        else:
            density, n_windows = self._sliding_density(img, y)
            pred_cnt = float(density.sum() / DENSITY_SCALE)

        raw_cnt = pred_cnt
        e_cnt = 0.0
        if self.normalization:
            # TTN over ALL rects (not capped at 3), mean divisor 3
            # (reference: FSC_test_cross(few-shot).py:353-359).
            for rect in rects:
                e_cnt += float(
                    density[rect[0] : rect[2] + 1, rect[1] : rect[3] + 1].sum()
                    / DENSITY_SCALE
                )
            e_cnt = e_cnt / 3
            if e_cnt > TTN_THRESHOLD:
                pred_cnt = pred_cnt / e_cnt

        return CountResult(pred_cnt, density, grid_mode, e_cnt, raw_cnt, n_windows)

    @torch.inference_mode()
    def capture_forwards(self, shot_nums: Sequence[int] = (0, 1, 2, 3)) -> int:
        """On the card, capture the window forward's CUDA graph at every
        window bucket ``count_batch`` can run (``forward_buckets``) for
        each shot count, so that no later call captures one; a no-op on
        the CPU and with ``debug_nans``. Returns the number of graphs held."""
        pipe = self._pipeline
        if not pipe.graphed:
            return 0
        dd = self.model.cfg.decoder_embed_dim
        for bk in forward_buckets(self.batch_windows, len(pipe.devices)):
            windows = torch.zeros((bk, WINDOW, WINDOW, 3), device=self.device)
            for shot in shot_nums:
                y = torch.zeros((bk, max(shot, 1), dd), device=self.device,
                                dtype=self.model.dec_dtype)
                pipe.forward(windows, y)
        return sum(len(f.runner) for f in pipe.forwards)

    def _grid_rows(self, image: torch.Tensor) -> torch.Tensor:
        """The 9 grid crops of an [h, w, 3] image tensor, each resized back
        to (h, w) with cv2-INTER_LINEAR maps -> [9, h, w, 3]."""
        h, w = image.shape[:2]
        return torch.stack(
            [resize_crop(image, box, h, w) for box in grid_crop_boxes(h, w)]
        )

    # ------------------------------------------------------------------
    # Batched device pipeline (throughput path)
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def count_batch(
        self,
        images: Sequence[np.ndarray],
        boxes_list: Sequence[Optional[np.ndarray]],
        rects_list: Sequence[Sequence[Sequence[int]]],
        shot_num: int,
        return_density: bool = True,
    ) -> List[CountResult]:
        """Count a batch of images on the device. All images share one
        shot_num (bucket by shot count in the caller)."""
        for img in images:
            if img.shape[0] != WINDOW:
                raise ValueError(f"engine expects H={WINDOW} rows; got {img.shape}")
        results: List[Optional[CountResult]] = [None] * len(images)
        with span("count.batch"):
            with span("count.plan_sets"):
                sets = self.plan_batch_sets(images, rects_list)
            # Every set is dispatched before any is read back, so the host
            # plans and uploads a set while the device runs the previous one.
            pending = [
                self._dispatch_set(idxs, images, boxes_list, rects_list, shot_num, return_density)
                for idxs in sets
            ]
            for handle in pending:
                with span("count.collect"):
                    self._collect_set(handle, return_density, results)
        return results  # type: ignore[return-value]

    def plan_batch_sets(self, images, rects_list) -> List[List[int]]:
        """Pack a batch into device sets: sort by width so each set pads
        to a nearby bucket, then greedy-pack into sets bounded by
        ``images_bucket`` density rows (a grid-mode image takes 9). When
        a set fills, it is cut at the LATEST prefix whose forward-window
        total is a multiple of batch_windows, as long as that keeps the
        set at least half full and the carried images plus the pending
        one fit; with ``stream_chunks`` such a set runs no padded forward
        slot."""
        b = self.batch_windows
        order = sorted(range(len(images)), key=lambda i: images[i].shape[1])
        sets: List[List[int]] = []
        cur: List[int] = []
        rows_used = 0
        wins_after: List[int] = []  # cumulative windows after cur[k]
        rows_after: List[int] = []
        for i in order:
            need, wins = self.windows_per_image(images[i].shape[1], rects_list[i])
            if cur and rows_used + need > self.images_bucket:
                cut = len(cur)
                for k in range(len(cur), 0, -1):
                    if (
                        wins_after[k - 1] % b == 0
                        and wins_after[k - 1] > 0
                        and rows_after[k - 1] * 2 >= self.images_bucket
                        and rows_used - rows_after[k - 1] + need <= self.images_bucket
                    ):
                        cut = k
                        break
                sets.append(cur[:cut])
                cur = cur[cut:]
                wbase = wins_after[cut - 1] if cut else 0
                rbase = rows_after[cut - 1] if cut else 0
                wins_after = [wa - wbase for wa in wins_after[cut:]]
                rows_after = [ra - rbase for ra in rows_after[cut:]]
                rows_used -= rbase
            cur.append(i)
            rows_used += need
            wins_after.append((wins_after[-1] if wins_after else 0) + wins)
            rows_after.append(rows_used)
        if cur:
            sets.append(cur)
        return sets

    def _row_bucket(self, n_rows: int) -> int:
        """The smallest power-of-two bucket from 4 that holds ``n_rows``,
        capped at images_bucket (or n_rows past it)."""
        b = 4
        while b < n_rows:
            b *= 2
        return min(max(b, 4), max(self.images_bucket, n_rows))

    def windows_per_image(self, width: int, rects) -> Tuple[int, int]:
        """(density_rows, forward_windows) one image contributes to a set:
        the one source the set packer and ``_plan_set`` share (the latter
        asserts what it emits against it)."""
        if width >= WINDOW:
            nw = len(window_starts(width))
        else:
            nw = 0 if self.narrow_policy == "reference" else 1
        if small_exemplar_count(rects) >= self.max_s_cnt:
            return 9, 9 * nw  # 3x3 grid: 9 density rows, 9x windows
        return 1, nw

    def _plan_set(self, idxs, images, boxes_list, rects_list, shot_num) -> dict:
        """Host-side set assembly (no device work): the flat pixel pool,
        the exemplar crop stack, the window plan, the rect arrays and the
        row bookkeeping."""
        n_img = len(idxs)
        grid_flags = {i: small_exemplar_count(rects_list[i]) >= self.max_s_cnt for i in idxs}
        u_bucket = self._row_bucket(n_img)
        n_den = sum(9 if grid_flags[i] else 1 for i in idxs)
        r_bucket = self._row_bucket(n_den)
        # encode_exemplars casts the crops to the decoder dtype; cast on
        # the host, so a bf16 decoder's stack uploads 2 bytes a value
        # (the same values)
        if shot_num > 0:
            stack = np.stack([_as_float(boxes_list[i])[:shot_num] for i in idxs])
            stack = np.concatenate(
                [stack, np.zeros((u_bucket - n_img, *stack.shape[1:]), np.float32)], 0)
        else:
            stack = np.zeros((u_bucket, 1, EXEMPLAR_SIZE, EXEMPLAR_SIZE, 3), np.float32)
        bstack = torch.from_numpy(stack).to(self.model.dec_dtype)

        # ONE flat pixel pool per set: the images side by side along the
        # width axis, [384, Wt, 3], Wt padded to a multiple of 2048;
        # windows slice absolute columns, and grid crops are resampled
        # from it on the device, so uint8 pools survive mixed sets.
        use_u8 = all(images[i].dtype == np.uint8 for i in idxs)
        max_w = max(images[i].shape[1] for i in idxs)
        wb = width_bucket(max(max_w, WINDOW))
        alloc = [max(images[i].shape[1], WINDOW) for i in idxs]
        base = np.zeros(n_img, np.int64)
        base[1:] = np.cumsum(alloc)[:-1]
        wt = -(-int(sum(alloc)) // 2048) * 2048
        stackr = np.zeros((WINDOW, wt, 3), np.uint8 if use_u8 else np.float32)
        for p, i in enumerate(idxs):
            img = images[i] if use_u8 else _as_float(images[i])
            stackr[:, base[p]:base[p] + img.shape[1]] = img

        # Window plan: plain sliding windows first, then grid-mode
        # resampled windows. abs_start and the ix taps are absolute pool
        # columns (image base + in-image offset).
        plain = {"img_owner": [], "den_owner": [], "den_start": [], "wcol": [], "abs_start": []}
        rs = {"img_owner": [], "den_owner": [], "den_start": [], "wcol": [],
              **{k: [] for k in MAP_KEYS}}
        img_rows: dict = {}  # image idx -> [(density_row, true_w)]
        den_owner_img: List[int] = []  # image idx per density row
        n_den_rows = 0

        def window_cols(true_w):
            """(start, wcol[384]) pairs for one row of width true_w."""
            if true_w < WINDOW:
                if self.narrow_policy == "reference":
                    return []
                wcol = np.zeros(WINDOW, np.float32)
                wcol[:true_w] = 1.0
                return [(0, wcol)]
            starts, weights = stitch_weights(true_w)
            return [(s, weights[k, s:s + WINDOW]) for k, s in enumerate(starts)]

        for p, i in enumerate(idxs):
            true_w = images[i].shape[1]
            if not grid_flags[i]:
                den_row = n_den_rows
                n_den_rows += 1
                img_rows.setdefault(i, []).append((den_row, true_w))
                den_owner_img.append(i)
                for s, wcol in window_cols(true_w):
                    plain["img_owner"].append(p)
                    plain["den_owner"].append(den_row)
                    plain["den_start"].append(s)
                    plain["abs_start"].append(int(base[p]) + s)
                    plain["wcol"].append(wcol)
                continue
            for (t, l, ch, cw) in grid_crop_boxes(WINDOW, true_w):
                den_row = n_den_rows
                n_den_rows += 1
                img_rows.setdefault(i, []).append((den_row, true_w))
                den_owner_img.append(i)
                iy0, iy1, wy1 = resample_maps(ch, WINDOW, t)
                xi0, xi1, xw1 = resample_maps(cw, true_w, l)
                xi0 = xi0 + int(base[p])
                xi1 = xi1 + int(base[p])
                if true_w < WINDOW:
                    # a narrow image's maps point past its width at its own
                    # zero columns (alloc >= WINDOW): the zero-padded
                    # narrow window of count
                    pad = WINDOW - true_w
                    zcol = np.full(pad, int(base[p]) + true_w, np.int32)
                    xi0 = np.concatenate([xi0, zcol])
                    xi1 = np.concatenate([xi1, zcol])
                    xw1 = np.concatenate([xw1, np.zeros(pad, np.float32)])
                for s, wcol in window_cols(true_w):
                    rs["img_owner"].append(p)
                    rs["den_owner"].append(den_row)
                    rs["den_start"].append(s)
                    rs["wcol"].append(wcol)
                    rs["ix0"].append(xi0[s:s + WINDOW])
                    rs["ix1"].append(xi1[s:s + WINDOW])
                    rs["wx1"].append(xw1[s:s + WINDOW])
                    rs["iy0"].append(iy0)
                    rs["iy1"].append(iy1)
                    rs["wy1"].append(wy1)

        n_plain = len(plain["img_owner"])
        # The packer sized this set with windows_per_image; the plan must
        # agree, or its zero-tail cuts stop landing on batch boundaries.
        expect = sum(self.windows_per_image(images[i].shape[1], rects_list[i])[1] for i in idxs)
        assert n_plain + len(rs["img_owner"]) == expect, (
            f"window plan emitted {n_plain + len(rs['img_owner'])} windows but "
            f"windows_per_image predicts {expect}")
        plan = {
            "n_plain": n_plain,
            "img_owner": np.asarray(plain["img_owner"] + rs["img_owner"], np.int32),
            "den_owner": np.asarray(plain["den_owner"] + rs["den_owner"], np.int32),
            "den_start": np.asarray(plain["den_start"] + rs["den_start"], np.int32),
            "abs_start": np.asarray(plain["abs_start"], np.int32),
            "wcol": (np.stack(plain["wcol"] + rs["wcol"]) if (plain["wcol"] or rs["wcol"])
                     else np.zeros((0, WINDOW), np.float32)),
        }
        for k in MAP_KEYS:
            dt = np.float32 if k in ("wx1", "wy1") else np.int32
            plan[k] = np.stack(rs[k]).astype(dt) if rs[k] else np.zeros((0, WINDOW), dt)

        # rects per DENSITY row: the owning image's, all of them (the
        # reference's TTN loop is uncapped)
        k_max = max(1, max(len(rects_list[i]) for i in idxs))
        rects_arr = np.zeros((r_bucket, k_max, 4), np.int32)
        rects_valid = np.zeros((r_bucket, k_max), np.float32)
        for ridx, im in enumerate(den_owner_img):
            for k, rect in enumerate(rects_list[im]):
                rects_arr[ridx, k] = rect
                rects_valid[ridx, k] = 1.0

        return {
            "stackr": stackr, "bstack": bstack, "plan": plan, "rects_arr": rects_arr,
            "rects_valid": rects_valid, "u_bucket": u_bucket, "r_bucket": r_bucket,
            "den_width": wb, "img_rows": img_rows, "grid_flags": grid_flags,
            "den_owner_img": den_owner_img,
        }

    def _dispatch_set(self, idxs, images, boxes_list, rects_list, shot_num, return_density):
        with span("count.plan_set"):
            sp = self._plan_set(idxs, images, boxes_list, rects_list, shot_num)
        plan = sp["plan"]
        # the set's exemplar tokens in one batched CNN call, at the
        # upload-row bucket
        (bstack,) = self._pipeline.upload([sp["bstack"]])
        with span("count.exemplars"):
            y_img = self.model.encode_exemplars(bstack, shot_num)
        self.h2d_bytes += (
            sp["stackr"].nbytes + sp["bstack"].numel() * sp["bstack"].element_size()
            + sp["rects_arr"].nbytes + sp["rects_valid"].nbytes
            + sum(v.nbytes for k, v in plan.items() if k != "n_plain")
        )
        counts, esum, density = self._pipeline.run(
            sp["stackr"], y_img, plan, sp["rects_arr"], sp["rects_valid"], sp["r_bucket"],
            self.batch_windows, want_density=return_density, den_width=sp["den_width"],
        )
        win_per_row: dict = {}
        for o in plan["den_owner"].tolist():
            win_per_row[o] = win_per_row.get(o, 0) + 1
        return idxs, sp["img_rows"], sp["grid_flags"], win_per_row, counts, esum, density

    def _collect_set(self, handle, return_density, results) -> None:
        idxs, img_rows, grid_flags, win_per_row, counts_dev, esum_dev, density_dev = handle
        counts = counts_dev.cpu().numpy()
        esum = esum_dev.cpu().numpy()
        density = density_dev.cpu().numpy() if density_dev is not None else None
        for i in idxs:
            rws = img_rows[i]
            raw = float(sum(counts[r] for (r, _) in rws))
            last_row, last_w = rws[-1]
            n_win = sum(win_per_row.get(r, 0) for (r, _) in rws)
            e_cnt = 0.0
            pred = raw
            if self.normalization:
                # TTN on the last density row (grid mode: the 9th crop's)
                e_cnt = float(esum[last_row]) / 3
                if e_cnt > TTN_THRESHOLD:
                    pred = raw / e_cnt
            den = None
            if return_density and density is not None:
                den = density[last_row][:, :last_w]
            results[i] = CountResult(pred, den, grid_flags[i], e_cnt, raw, n_win)


def count_image(
    engine: CountingEngine,
    image,
    boxes_xyxy: Sequence[Sequence[float]] = (),
) -> CountResult:
    """One-call counting of a RAW image (the library equivalent of the
    reference demos' load_image + run_one_image, reference:
    demo.py:34-189, demo_zero.py:41-88).

    image: PIL.Image, path string, or HWC uint8/float array at any
    resolution. boxes_xyxy: exemplar boxes (x1, y1, x2, y2) in ORIGINAL
    image pixels; empty = zero-shot. Applies the test-pipeline geometry
    (H=384, W snapped to a multiple of 16) and crops the exemplars on the
    host with PIL and cv2, then counts with ``engine.count`` (TTN and
    grid mode per the engine's settings).
    """
    from PIL import Image

    from countr_tpu_torch.data import transforms as T

    if isinstance(image, str):
        image = Image.open(image)
    if isinstance(image, np.ndarray):
        arr = image
        if arr.dtype != np.uint8:
            arr = (np.clip(arr, 0.0, 1.0) * 255).astype(np.uint8)
        image = Image.fromarray(arr)
    resized, boxes, rects = T.prepare_raw(image, boxes_xyxy)
    return engine.count(resized, boxes, rects, shot_num=len(rects))
