"""The devices of a run (counterpart of ``countr_tpu/parallel/mesh.py``).

The JAX package lays a 1-D ``data`` mesh over every device and shards the
batch dimension across it. The port has two shapes of the same thing:

- training runs one process per device (``parallel/dist.py``): a rank
  loads its contiguous slice of each global batch (``data/loader.py``
  ``process_index`` / ``process_count``), draws every per-sample random
  value at the global batch's shape and keeps its rows (``rows_of``), and
  averages its gradients and metrics with the others inside the step;
- counting runs one process over several devices: ``DevicePipeline``
  splits each window chunk into one part per device, the model copied to
  each once (``replicate_to_mesh``).

``Mesh`` holds either: the devices this process drives, its rank and
world, and the groups of a distributed run.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    devices: Tuple[torch.device, ...]  # the devices this process drives, the lead first
    rank: int = 0
    world: int = 1  # processes of the run
    group: object = None  # the step's collectives (NCCL or gloo); None in one process
    host_group: object = None  # gloo: what the hosts agree on

    @property
    def device(self) -> torch.device:
        return self.devices[0]


def get_mesh(n_devices: int = 0, device="cuda") -> Mesh:
    """A one-process mesh over the first ``n_devices`` devices of
    ``device``'s type (0: every visible one, as in JAX). More CUDA devices
    than are visible raises; on the CPU every device is the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return Mesh(devices=(device,) * max(n_devices, 1))
    visible = torch.cuda.device_count()
    n = n_devices or visible
    if n > visible:
        raise ValueError(f"--n_devices {n_devices}: {visible} CUDA device(s) visible")
    first = device.index or 0
    if first + n > visible:
        raise ValueError(f"{n} devices from {device}: {visible} CUDA device(s) visible")
    return Mesh(devices=tuple(torch.device("cuda", first + i) for i in range(n)))


def rows_of(x, rank: int, world: int):
    """Rank ``rank``'s contiguous rows of a global-batch array or tensor
    (``world`` equal slices of the leading dim, as the loader slices a
    batch)."""
    if world == 1:
        return x
    b = x.shape[0] // world
    return x[rank * b:(rank + 1) * b]


def global_any(flags, mesh: Optional[Mesh]) -> bool:
    """True if any rank's flags are set: the reference's batch-level
    m_flag rule (no shot 0 when any sample of the GLOBAL batch is a
    mosaic; reference: FSC_finetune_cross.py:277-284), so that every rank
    draws the same shot from its identically seeded stream. A MAX
    all-reduce of one integer on the host's gloo group: the card is not
    synchronised."""
    local = bool(np.any(flags))
    if mesh is None or mesh.world == 1:
        return local
    import torch.distributed as dist

    t = torch.tensor([int(local)], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.host_group)
    return bool(t.item())


def replicate_to_mesh(mesh: Mesh, module: torch.nn.Module) -> list:
    """``module`` on every device of ``mesh``, in its order: the lead
    device's is ``module`` itself (moved there), each other one a copy made
    once. A training rank holds one device and builds its own copy of
    everything (the stores, ``engine/train_store.py``) there, as JAX's
    per-process copies of a replicated array (``mesh.py:52-68``)."""
    out = [module.to(mesh.device)]
    for d in mesh.devices[1:]:
        replica = copy.deepcopy(module).to(d)
        for t in (*replica.parameters(), *replica.buffers()):
            t.__dict__.pop("_countr_cast", None)  # models/vit.py cast_param's cache
        out.append(replica)
    return out
