"""One rank of the port's data-parallel tests on the CPU (gloo), started by
tests/test_torch_parallel.py and tests/test_torch_cli_parallel.py with
torchrun's environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT):

    python -m tests.torch_dist_worker SPEC.json

SPEC's ``kind`` is ``engine`` (``engine_checks``: the training steps of
countr_tpu_torch.engine.train at a tiny width, each rank on its rows of
one global batch) or ``cli`` (a training CLI's ``main`` on ``argv``, with
tiny presets registered and, where SPEC says so, the CLI's TrainConfig
given ``loss_mask_p``, as tests/test_torch_cli_finetune.py sets it). Rank
0 writes the result to SPEC's ``out`` (an .npz for ``engine``, JSON for
``cli``). A rank dies with its parent. Imports neither JAX nor
countr_tpu; the tests import this module for the same inputs and builds
in one process.
"""

import ctypes
import functools
import json
import os
import signal
import subprocess
import sys

import numpy as np
import torch

HW = 64  # the engine checks' window (tests/test_torch_train.py's)
B = 4  # the global batch
TINY = dict(img_size=HW, patch_size=16, embed_dim=32, depth=1, num_heads=2,
            decoder_embed_dim=32, decoder_depth=1, decoder_num_heads=2, head_width=32)
TINY_MAE = {k: v for k, v in TINY.items() if k != "head_width"}
LR = 1e-3
WEAK_GRAD = 1e-7  # tests/test_torch_train.py's: a gradient element that is fp32 noise


def finetune_setup(mesh=None, accum: int = 1, device_aug: bool = False):
    """(state, step, generator) of the tiny fp32 finetune build, encoder
    trained, on the CPU; a data-parallel rank's with ``mesh``."""
    from countr_tpu_torch.config import TrainConfig
    from countr_tpu_torch.engine import train as engine
    from countr_tpu_torch.models import build_countr

    model = build_countr("mae_vit_base6_patch16", dtype=torch.float32, device="cpu", seed=3,
                         training=True, freeze_encoder=False, **TINY)
    cfg = TrainConfig(batch_size=B, lr=LR, min_lr=LR, warmup_epochs=0, accum_iter=accum)
    state = engine.init_train_state(model, cfg, steps_per_epoch=10, world_batch=B, mesh=mesh)
    gen = torch.Generator().manual_seed(5)
    return state, engine.make_finetune_step(state, cfg, gen, device_aug=device_aug), gen


def pretrain_setup(mesh=None):
    from countr_tpu_torch.config import TrainConfig
    from countr_tpu_torch.engine import train as engine
    from countr_tpu_torch.models import build_mae

    model = build_mae("mae_vit_base_patch16", dtype="fp32", device="cpu", seed=3, **TINY_MAE)
    cfg = TrainConfig(batch_size=B, lr=LR, min_lr=LR, warmup_epochs=0)
    state = engine.init_train_state(model, cfg, steps_per_epoch=10, world_batch=B, mesh=mesh)
    gen = torch.Generator().manual_seed(6)
    return state, engine.make_pretrain_step(state, cfg, gen), gen


def global_batches(seed: int = 0) -> dict:
    """The global batches every check draws its rows from (numpy)."""
    rng = np.random.default_rng(seed)
    k = 12
    return {
        "image": rng.uniform(0, 1, (B, HW, HW, 3)).astype(np.float32),
        "gt_density": rng.uniform(0, 2, (B, HW, HW)).astype(np.float32),
        "boxes": rng.uniform(0, 1, (B, 3, 64, 64, 3)).astype(np.float32),
        "valid": np.array([1, 1, 1, 0], np.float32),
        "image_u8": rng.integers(0, 256, (B, HW, HW, 3)).astype(np.uint8),
        "dots": rng.integers(0, HW, (B, k, 2)).astype(np.int16),
        "n_dots": rng.integers(1, k, (B,)).astype(np.int32),
        "apply_photo": np.array([1, 0, 1, 1], np.float32),
    }


def _rows(batch: dict, keys, rank: int, world: int) -> dict:
    from countr_tpu_torch.parallel.mesh import rows_of

    return {k: torch.from_numpy(rows_of(batch[k], rank, world)) for k in keys}


def engine_checks(mesh=None) -> dict:
    """The checks' results on this rank's rows of ``global_batches`` (all
    of them without ``mesh``): one finetune step's averaged gradient and
    metrics, the eval sums, two ``--device_aug`` steps, four mini-steps at
    ``accum_iter`` 2, two pretrain steps with the masking noise drawn in
    the step, one photometric draw, and ``global_any``."""
    from countr_tpu_torch.engine import train as engine
    from countr_tpu_torch.ops.augment import draw_photometric
    from countr_tpu_torch.parallel.mesh import global_any

    rank, world = (mesh.rank, mesh.world) if mesh is not None else (0, 1)
    rows = functools.partial(_rows, global_batches(), rank=rank, world=world)
    out = {}
    state, step, _ = finetune_setup(mesh)
    m = step(rows(engine.FINETUNE_KEYS), 3)
    out["ft_grads"] = torch.cat([f.flatten() for f in state.flat]).numpy()
    out["ft_metrics"] = np.array([float(m[k]) for k in ("loss", "mae", "mse")])
    ev = engine.make_eval_step(state.model, mesh=mesh)(
        rows(("image", "gt_density", "boxes", "valid")), 2)
    out["eval_sums"] = np.array([float(ev[k]) for k in ("err_sum", "sq_sum", "nae_sum", "n")])

    def steps(name, state, step, args):
        """Each step's loss; the parameters after; where an update's
        gradient was fp32 noise (``WEAK_GRAD``)."""
        losses, weak = [], 0
        for a in args:
            losses.append(float(step(*a)["loss"]))
            if state.step % state.accum_iter == 0:
                weak = weak | (torch.cat([f.flatten() for f in state.flat]).abs() < WEAK_GRAD)
        out[f"{name}_losses"] = np.array(losses)
        out[f"{name}_params"] = torch.cat([p.detach().flatten() for p in state.params]).numpy()
        out[f"{name}_weak"] = weak.numpy()
        out[f"{name}_updates"] = np.array(state.updates)

    state, step, _ = finetune_setup(mesh, device_aug=True)
    steps("aug", state, step, [(rows(engine.DEVICE_AUG_KEYS), s) for s in (3, 1)])
    state, step, _ = finetune_setup(mesh, accum=2)
    steps("accum", state, step, [(rows(engine.FINETUNE_KEYS), s) for s in (3, 3, 1, 1)])
    state, step, _ = pretrain_setup(mesh)
    steps("pt", state, step, [(rows(("image",))["image"],)] * 2)

    draws = draw_photometric(B // world, HW, HW, torch.Generator().manual_seed(9), rank=rank,
                             world=world)
    out.update({f"draw_{k}": v.numpy() for k, v in draws.items()})
    out["any"] = np.array([global_any([rank == world - 1], mesh),
                           global_any([False], mesh)])
    return out


def _register(presets: dict) -> None:
    from countr_tpu_torch import config

    for name, (kind, kw) in presets.items():
        table, cls = ((config.MAE_PRESETS, config.MAEConfig) if kind == "mae"
                      else (config.COUNTR_PRESETS, config.CounTRConfig))
        table[name] = cls(**kw)


def run_cli(spec: dict):
    """The CLI's ``main`` on ``spec['argv']``: each epoch's stats."""
    import importlib

    from countr_tpu_torch import config

    _register(spec.get("presets", {}))
    cli = importlib.import_module(f"countr_tpu_torch.cli.{spec['cli']}")
    if "loss_mask_p" in spec:
        cli.TrainConfig = functools.partial(config.TrainConfig, loss_mask_p=spec["loss_mask_p"])
    return cli.main(cli.get_args(spec["argv"]))


def run_ranks(spec: dict, world: int, tmp_path, timeout: float = 180.0, kill_when=None):
    """Start ``world`` ranks on ``spec`` (written under ``tmp_path``),
    wait for all of them at most ``timeout`` seconds (then kill them and
    fail) and return rank 0's result. ``kill_when``: a callable polled
    while they run; once it returns True every rank is SIGKILLed and None
    is returned."""
    import time

    from countr_tpu_torch.parallel.dist import free_port

    tmp_path.mkdir(parents=True, exist_ok=True)
    out = str(tmp_path / ("ranks.npz" if spec["kind"] == "engine" else "ranks.json"))
    path = tmp_path / "spec.json"
    path.write_text(json.dumps({**spec, "out": out}))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(free_port()),
               WORLD_SIZE=str(world))
    logs = [tmp_path / f"rank{r}.log" for r in range(world)]
    procs = []
    try:
        for r in range(world):
            with open(logs[r], "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "tests.torch_dist_worker", str(path)], cwd=root,
                    env={**env, "RANK": str(r), "LOCAL_RANK": str(r)}, stdout=log,
                    stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            if kill_when is not None and kill_when():
                return None
            if time.monotonic() > deadline:
                raise AssertionError(f"ranks still running after {timeout} s")
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    codes = [p.returncode for p in procs]
    if any(codes):
        raise AssertionError(f"ranks exited {codes}:\n"
                             + "\n".join(f.read_text()[-3000:] for f in logs))
    if spec["kind"] == "engine":
        with np.load(out) as f:
            return dict(f)
    with open(out) as f:
        return json.load(f)


def main() -> None:
    from countr_tpu_torch.parallel import dist

    # PR_SET_PDEATHSIG: a rank dies with the test that started it
    ctypes.CDLL("libc.so.6", use_errno=True).prctl(1, signal.SIGKILL)
    torch.set_num_threads(1)
    with open(sys.argv[1]) as f:
        spec = json.load(f)
    try:
        if spec["kind"] == "engine":
            result = engine_checks(dist.init_distributed("cpu", timeout_s=60))
        else:
            result = run_cli(spec)
        if dist.rank() == 0:
            if spec["kind"] == "engine":
                np.savez(spec["out"], **result)
            else:
                with open(spec["out"], "w") as f:
                    json.dump(result, f)
    finally:
        dist.destroy()


if __name__ == "__main__":
    main()
