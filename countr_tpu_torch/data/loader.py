"""Host data loading (counterpart of ``countr_tpu/data/loader.py``): a
deterministic, parallel sample loader and the stage that uploads its
batches to the card ahead of the step.

``DataLoader`` fetches samples on a thread pool (PIL, cv2 and the native
host core release the GIL for the heavy work) or, with
``use_processes``, on a pool of spawned worker processes; the per-epoch
order is a seeded permutation, so batches are the JAX package's.

``device_prefetch`` keeps a producer thread ``depth`` batches ahead. Only
the calling thread touches the card: it allocates a ring of ``depth + 1``
pinned host batches once, the producer thread copies each collated batch
into a free slot (host memory only), and the calling thread starts the
non-blocking upload from the slot and records a CUDA event behind it; a
slot is filled again only after its event has completed (the
``DevicePipeline`` rule of ``engine/device_pipeline.py``).
"""

from __future__ import annotations

import collections
import multiprocessing
import pickle
import queue
import threading
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from countr_tpu_torch.utils.profiling import span

_STACK_KEYS = (
    "image", "gt_density", "boxes",
    # device-augmentation geometry samples (TrainDataset(device_aug=True))
    "image_u8", "dots", "n_dots", "apply_photo",
    # resident-store parameter samples (TrainDataset(store_index=...))
    "img_idx", "affine_C", "affine_d", "is_mosaic", "cell_idx",
    "cell_top", "cell_left", "cell_len", "blend_l",
    # pretrain resident-store crop samples (PretrainDataset(store=...))
    "crop_top", "crop_left", "crop_h", "crop_w", "transposed", "flip",
)

# -- process-worker plumbing (one unpickled dataset per worker) ----------
_worker_dataset = None


def _proc_init(ds_bytes: bytes) -> None:
    global _worker_dataset
    _worker_dataset = pickle.loads(ds_bytes)


def _proc_fetch(job):
    epoch, idx = job
    if hasattr(_worker_dataset, "set_epoch"):
        _worker_dataset.set_epoch(epoch)
    return _worker_dataset[idx]


def default_collate(samples: Sequence[Dict]) -> Dict:
    """Stack array fields; list-ify ragged fields (rects, names)."""
    out: Dict = {}
    for k in samples[0]:
        vals = [s[k] for s in samples]
        if k in _STACK_KEYS:
            out[k] = np.stack(vals)
        elif k == "m_flag":
            out[k] = np.asarray(vals, np.int32)
        else:
            out[k] = vals
    return out


class DataLoader:
    """Deterministic shuffling and parallel sample fetch.

    The per-epoch order is a seeded permutation; each sample's
    augmentation is seeded by (dataset.seed, epoch, index) inside the
    dataset, so results are the same for any worker count.

    ``use_processes``: fetch samples in spawned worker processes instead
    of threads (the Python parts of the augmentation without the GIL; the
    dataset must pickle). ``process_index`` / ``process_count``: with
    ``batch_size`` the global batch, every process computes the same
    permutation and loads only its contiguous batch_size / process_count
    slice of each batch; a final batch that cannot be split evenly is
    dropped."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        *,
        shuffle: bool = False,
        num_workers: int = 8,
        drop_last: bool = False,
        seed: int = 0,
        collate: Callable = default_collate,
        prefetch_batches: int = 2,
        use_processes: bool = False,
        process_index: int = 0,
        process_count: int = 1,
    ):
        if process_count > 1 and batch_size % process_count != 0:
            raise ValueError(f"global batch_size {batch_size} not divisible by "
                             f"process_count {process_count}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.seed = seed
        self.collate = collate
        self.prefetch_batches = prefetch_batches
        self.use_processes = use_processes
        self.process_index = process_index
        self.process_count = process_count
        self._pool = None  # kept across epochs: the workers' image caches stay warm

    def _get_pool(self):
        if self._pool is None:
            if self.use_processes:
                self._pool = ProcessPoolExecutor(
                    self.num_workers, mp_context=multiprocessing.get_context("spawn"),
                    initializer=_proc_init, initargs=(pickle.dumps(self.dataset),))
            else:
                self._pool = ThreadPoolExecutor(self.num_workers)
        return self._pool

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def batches(self, epoch: int = 0) -> List[np.ndarray]:
        """The sample indices of each of this process's batches of
        ``epoch``."""
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            order = np.random.default_rng(np.random.SeedSequence([self.seed, epoch])).permutation(n)
        batches = [order[i : i + self.batch_size] for i in range(0, n, self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        if self.process_count > 1:
            sliced = []
            for idxs in batches:
                if len(idxs) % self.process_count:
                    continue  # a final ragged batch that does not split evenly
                k = len(idxs) // self.process_count
                sliced.append(idxs[self.process_index * k : (self.process_index + 1) * k])
            batches = sliced
        return batches

    def epoch(self, epoch: int = 0) -> Iterator[Dict]:
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)
        pool = self._get_pool()
        if self.use_processes:
            submit = lambda i: pool.submit(_proc_fetch, (epoch, int(i)))  # noqa: E731
        else:
            submit = lambda i: pool.submit(self.dataset.__getitem__, int(i))  # noqa: E731
        pending: collections.deque = collections.deque()
        it = iter(self.batches(epoch))

        def submit_next() -> None:
            idxs = next(it, None)
            if idxs is not None:
                pending.append([submit(i) for i in idxs])

        for _ in range(self.prefetch_batches):
            submit_next()
        try:
            while pending:
                futs = pending.popleft()
                submit_next()
                yield self.collate([f.result() for f in futs])
        finally:  # a consumer that stops early leaves no sample running
            for futs in pending:
                for f in futs:
                    f.cancel()


_END = object()


class _Failure:
    def __init__(self, error: BaseException):
        self.error = error


def _host_tensors(batch: Dict, keys) -> Dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) if k in keys else v
            for k, v in batch.items()}


def device_prefetch(it: Iterator[Dict], device=None, keys: Optional[Sequence[str]] = None,
                    depth: int = 2) -> Iterator[Dict]:
    """Yield the batches of ``it`` with the array fields ``keys`` (default:
    every numpy array) as tensors on ``device``, in order, while a
    background thread stays ``depth`` batches ahead; the other fields pass
    through as they are. A producer's exception is raised here, at the
    batch where it happened.

    On a CUDA device the upload runs from a ring of pinned host batches
    (see the module's docstring); elsewhere the producer thread makes the
    tensors. A batch's shapes and dtypes must be those of the first."""
    device = torch.device("cpu" if device is None else device)
    it = iter(it)
    first = next(it, _END)
    if first is _END:
        return
    if keys is None:
        keys = [k for k, v in first.items() if isinstance(v, np.ndarray)]
    keys = tuple(keys)
    cuda = device.type == "cuda"
    slots = []
    if cuda:
        slots = [{k: torch.empty(first[k].shape, dtype=torch.from_numpy(first[k][:0]).dtype,
                                 pin_memory=True) for k in keys} for _ in range(depth + 1)]
    free: "queue.Queue" = queue.Queue()
    for i in range(len(slots)):
        free.put(i)
    filled: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                filled.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def stage(batch):
        if not cuda:
            return _host_tensors(batch, keys)
        while not stop.is_set():
            try:
                i = free.get(timeout=0.1)
                break
            except queue.Empty:
                continue
        else:
            return None
        for k in keys:
            slots[i][k].numpy()[...] = batch[k]
        return i, {k: v for k, v in batch.items() if k not in keys}

    def producer():
        source = _chain(first, it)
        try:
            for batch in source:
                with span("data.stage"):
                    staged = stage(batch)
                if staged is None or not put(staged):
                    return
        except BaseException as e:  # handed to the consumer, raised there
            put(_Failure(e))
        else:
            put(_END)
        finally:
            source.close()  # closes ``it`` too: a loader cancels what it queued

    thread = threading.Thread(target=producer, daemon=True, name="device_prefetch")
    thread.start()
    inflight: collections.deque = collections.deque()  # (slot, event) of uploads in flight
    try:
        while True:
            # free the slots whose uploads have completed; when every slot
            # is in flight the producer waits on one, so wait for the oldest
            while inflight and (inflight[0][1].query() or len(inflight) == len(slots)):
                i, ev = inflight.popleft()
                ev.synchronize()
                free.put(i)
            with span("data.next"):
                item = filled.get()
            if item is _END:
                return
            if isinstance(item, _Failure):
                raise item.error
            if not cuda:
                yield {k: v.to(device) if k in keys else v for k, v in item.items()}
                continue
            i, rest = item
            out = {k: slots[i][k].to(device, non_blocking=True) for k in keys}
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(device))
            inflight.append((i, ev))
            yield {**rest, **out}
    finally:
        stop.set()
        thread.join(timeout=30)
        for _, ev in inflight:
            ev.synchronize()


def _chain(first, it):
    yield first
    yield from it
