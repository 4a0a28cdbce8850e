"""Process groups for data-parallel training (counterpart of
``countr_tpu/parallel/dist.py``).

The JAX package runs one jitted step over a mesh of every device and XLA
inserts the gradient all-reduce. Here each device is driven by a process
of its own (a rank), as ``torchrun`` starts them, and the training step
all-reduces its gradients and metrics itself (``engine/train.py
TrainState``): over NCCL between cards, where the collective is issued
inside the step's CUDA graph, and over gloo between CPU processes. A
second group, always gloo, carries what the hosts agree on (the m_flag
rule, barriers) without touching the card.

``init_distributed`` reads torchrun's environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``); without
``WORLD_SIZE`` it does nothing. ``WORLD_SIZE=1`` starts a group of one,
which is how a one-card machine runs the collective path. ``launch``
starts N ranks of a CLI itself when it is not run under torchrun.
"""

from __future__ import annotations

import ctypes
import datetime
import multiprocessing
import os
import signal
import socket
from typing import Callable, Optional

import torch
import torch.distributed as dist

from countr_tpu_torch.parallel.mesh import Mesh

# Every group's timeout: a rank that waits this long on a collective
# raises (gloo's default is 30 minutes). It covers rank 0's checkpoint
# writes and the first step's capture while the others wait.
TIMEOUT_S = 120


def init_distributed(device, timeout_s: float = TIMEOUT_S) -> Optional[Mesh]:
    """Join the process group that torchrun's environment describes and
    return this rank's ``Mesh``: its device (``cuda:LOCAL_RANK`` for a
    CUDA ``device``, else the CPU), rank and world, the step's group
    (NCCL on CUDA, gloo on the CPU) and the host's gloo group. None, and
    nothing started, when ``WORLD_SIZE`` is unset.

    On NCCL the communicator is made here (``device_id``) and used once
    eagerly, so that no CUDA graph captures its creation."""
    if "WORLD_SIZE" not in os.environ:
        return None
    world = int(os.environ["WORLD_SIZE"])
    rank = int(os.environ.get("RANK", "0"))
    local = int(os.environ.get("LOCAL_RANK", str(rank)))
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda:
        visible = torch.cuda.device_count()
        if local >= visible:
            raise RuntimeError(f"rank {rank} (local rank {local}) needs a card of its own; "
                               f"{visible} visible")
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    timeout = datetime.timedelta(seconds=timeout_s)
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if cuda else "gloo", rank=rank, world_size=world, timeout=timeout,
            init_method=(f"tcp://{os.environ.get('MASTER_ADDR', 'localhost')}:"
                         f"{os.environ['MASTER_PORT']}"),
            **({"device_id": device} if cuda else {}))
    group = dist.group.WORLD
    host = dist.new_group(backend="gloo", timeout=timeout) if cuda else group
    warm = torch.ones(1, device=device)
    dist.all_reduce(warm, group=group)
    if cuda:
        torch.cuda.synchronize(device)
    return Mesh(devices=(device,), rank=rank, world=world, group=group, host_group=host)


def destroy() -> None:
    """Leave the process group (later code runs as one process)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    """Rank 0, or the only process (reference: util/misc.py:211-222)."""
    return rank() == 0


def rank0_print(*args, **kwargs) -> None:
    """Print on rank 0 only (reference: util/misc.py:179-193)."""
    if is_main_process():
        print(*args, **kwargs)


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def check_devices(n: int, device) -> None:
    """N ranks need N cards on a CUDA ``device`` (NCCL refuses two ranks
    on one card); CPU ranks are processes only."""
    if torch.device(device).type == "cuda":
        visible = torch.cuda.device_count()
        if n > visible:
            raise ValueError(f"--n_devices {n}: {visible} CUDA device(s) visible; "
                             "each rank needs a card of its own")


def _die_with_parent() -> None:
    """PR_SET_PDEATHSIG: a rank is killed when the process that started it
    dies, so no rank stays blocked on a collective."""
    try:
        ctypes.CDLL("libc.so.6", use_errno=True).prctl(1, signal.SIGKILL)
    except OSError:
        pass


def _rank_main(rank: int, world: int, port: int, entry: Callable, args, presets, threads: int,
               out) -> None:
    from countr_tpu_torch import config

    _die_with_parent()
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    config.COUNTR_PRESETS.update(presets[0])
    config.MAE_PRESETS.update(presets[1])
    if torch.device(args.device).type == "cpu":
        # CPU ranks share the caller's intra-op threads
        torch.set_num_threads(max(1, threads // world))
    try:
        result = entry(args)
    finally:
        destroy()
    if rank == 0:
        out.put(result)


def launch(entry: Callable, args, n: int):
    """Run ``entry(args)`` in ``n`` spawned ranks on ``args.device`` (one
    card each, or CPU processes over gloo) and return rank 0's result. The
    ranks see the caller's preset tables; each dies with the caller; a
    rank that fails makes this raise, after the others are stopped."""
    from countr_tpu_torch import config

    check_devices(n, args.device)
    ctx = multiprocessing.get_context("spawn")
    out = ctx.SimpleQueue()
    port = free_port()
    presets = (dict(config.COUNTR_PRESETS), dict(config.MAE_PRESETS))
    procs = [ctx.Process(target=_rank_main,
                         args=(r, n, port, entry, args, presets, torch.get_num_threads(), out))
             for r in range(n)]
    for p in procs:
        p.start()
    try:
        # rank 0 puts its result before it exits: read it before joining
        while out.empty() and procs[0].exitcode is None and not _failed(procs):
            procs[0].join(timeout=0.2)
        if _failed(procs) or out.empty():
            raise RuntimeError(f"ranks failed (rank, exit code): {_failed(procs) or [(0, None)]}")
        result = out.get()
        for p in procs:
            p.join(timeout=TIMEOUT_S)
        if any(p.exitcode != 0 for p in procs):
            raise RuntimeError("ranks failed (rank, exit code): "
                               f"{[(r, p.exitcode) for r, p in enumerate(procs)]}")
        return result
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()


def _failed(procs) -> list:
    return [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
