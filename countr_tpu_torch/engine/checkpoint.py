"""Weights in the reference ``.pth`` layout (counterpart of
``countr_tpu/engine/checkpoint.py``).

The port's modules carry the reference SupervisedMAE and
MaskedAutoencoderViTNoCT state_dict keys, so a released checkpoint loads
with ``load_state_dict(strict=True)``. ``state_dict_from_flax`` and
``mae_state_dict_from_flax`` are the bridges from the JAX package: they
turn its flax param trees (as numpy arrays) into the same state_dicts —
the port's own copy of the logic of ``export_countr_state_dict``, and
the inverse of ``convert_mae_state_dict``.

``save_checkpoint``, ``restore_checkpoint``, ``restore_params`` and
``latest_step`` save and resume the training state (the counterparts of
the JAX package's orbax functions, ``countr_tpu/engine/checkpoint.py``
``save_checkpoint`` ... ``latest_step``), one ``torch.save`` file per step
in the reference layout (util/misc.py:311-318): ``{"model", "optimizer",
"epoch"}``, plus the accumulator and the step counts. A restore copies
into the live tensors, so CUDA graphs captured over them stay valid.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

from countr_tpu_torch.ops.posembed import get_2d_sincos_pos_embed


def _f32(a) -> np.ndarray:
    return np.asarray(a, np.float32)


def _linear(sd, prefix: str, p) -> None:
    """flax Dense kernel [in, out] -> torch Linear weight [out, in]."""
    sd[f"{prefix}.weight"] = np.ascontiguousarray(_f32(p["kernel"]).T)
    if "bias" in p:
        sd[f"{prefix}.bias"] = _f32(p["bias"])


def _conv(sd, prefix: str, p) -> None:
    """flax Conv kernel HWIO -> torch Conv2d weight OIHW."""
    sd[f"{prefix}.weight"] = np.ascontiguousarray(_f32(p["kernel"]).transpose(3, 2, 0, 1))
    sd[f"{prefix}.bias"] = _f32(p["bias"])


def _norm(sd, prefix: str, p) -> None:
    sd[f"{prefix}.weight"] = _f32(p["scale"])
    sd[f"{prefix}.bias"] = _f32(p["bias"])


def _patch_embed(sd, p, patch: int, in_chans: int) -> int:
    """flax patch-embed matmul kernel [(p, p, c), D] -> torch conv
    [D, c, p, p]; returns D."""
    pk = _f32(p["patch_embed"]["proj"]["kernel"])
    d = pk.shape[1]
    sd["patch_embed.proj.weight"] = np.ascontiguousarray(
        pk.T.reshape(d, patch, patch, in_chans).transpose(0, 3, 1, 2)
    )
    sd["patch_embed.proj.bias"] = _f32(p["patch_embed"]["proj"]["bias"])
    return d


def _vit_blocks(sd, p, prefix: str) -> None:
    """Every ``{prefix}_{i}`` timm Block of the flax tree ->
    ``{prefix}.{i}.*``."""
    depth = len([k for k in p if k.startswith(f"{prefix}_")])
    for i in range(depth):
        blk, pre = p[f"{prefix}_{i}"], f"{prefix}.{i}"
        _norm(sd, f"{pre}.norm1", blk["norm1"])
        _linear(sd, f"{pre}.attn.qkv", blk["attn"]["qkv"])
        _linear(sd, f"{pre}.attn.proj", blk["attn"]["proj"])
        _norm(sd, f"{pre}.norm2", blk["norm2"])
        _linear(sd, f"{pre}.mlp.fc1", blk["mlp"]["fc1"])
        _linear(sd, f"{pre}.mlp.fc2", blk["mlp"]["fc2"])


def state_dict_from_flax(
    params: Mapping[str, Any], patch: int = 16, grid: int = 24, in_chans: int = 3
) -> Dict[str, np.ndarray]:
    """CounTR flax params (``{"params": ...}`` or the inner tree, numpy or
    array-like leaves) -> the port's state_dict as numpy arrays."""
    p = params.get("params", params)
    sd: Dict[str, np.ndarray] = {}
    d = _patch_embed(sd, p, patch, in_chans)
    _vit_blocks(sd, p, "blocks")
    _norm(sd, "norm", p["norm"])
    _linear(sd, "decoder_embed", p["decoder_embed"])
    sd["shot_token"] = _f32(p["shot_token"])
    for k in (1, 2, 3, 4):
        _conv(sd, f"decoder_proj{k}.0", p["exemplar_encoder"][f"conv{k}"])
    dec_depth = len([k for k in p if k.startswith("decoder_blocks_")])
    for i in range(dec_depth):
        blk, pre = p[f"decoder_blocks_{i}"], f"decoder_blocks.{i}"
        _norm(sd, f"{pre}.norm0", blk["norm0"])
        _linear(sd, f"{pre}.selfattn.qkv", blk["selfattn"]["qkv"])
        _linear(sd, f"{pre}.selfattn.proj", blk["selfattn"]["proj"])
        _norm(sd, f"{pre}.norm1", blk["norm1"])
        for w in ("wq", "wk", "wv", "proj"):
            _linear(sd, f"{pre}.attn.{w}", blk["attn"][w])
        _norm(sd, f"{pre}.norm2", blk["norm2"])
        _linear(sd, f"{pre}.mlp.fc1", blk["mlp"]["fc1"])
        _linear(sd, f"{pre}.mlp.fc2", blk["mlp"]["fc2"])
    _norm(sd, "decoder_norm", p["decoder_norm"])
    head = p["density_head"]
    for k in range(4):
        _conv(sd, f"decode_head{k}.0", head[f"conv{k}"])
        sd[f"decode_head{k}.1.weight"] = _f32(head[f"gn{k}_scale"])
        sd[f"decode_head{k}.1.bias"] = _f32(head[f"gn{k}_bias"])
    _conv(sd, "decode_head3.3", head["pred"])
    dec_dim = sd["decoder_embed.bias"].shape[0]
    sd["pos_embed"] = get_2d_sincos_pos_embed(d, grid)[None]
    sd["decoder_pos_embed"] = get_2d_sincos_pos_embed(dec_dim, grid)[None]
    return sd


def mae_state_dict_from_flax(
    params: Mapping[str, Any], patch: int = 16, grid: int = 24, in_chans: int = 3
) -> Dict[str, np.ndarray]:
    """MAE flax params (``{"params": ...}`` or the inner tree) -> the
    port's state_dict in the reference MaskedAutoencoderViTNoCT keys
    (models_mae_noct.py:11-51), numpy arrays; the fixed position
    embeddings are computed. ``convert_mae_state_dict`` of the JAX
    package is its inverse."""
    p = params.get("params", params)
    sd: Dict[str, np.ndarray] = {}
    d = _patch_embed(sd, p, patch, in_chans)
    _vit_blocks(sd, p, "blocks")
    _norm(sd, "norm", p["norm"])
    _linear(sd, "decoder_embed", p["decoder_embed"])
    sd["mask_token"] = _f32(p["mask_token"])
    _vit_blocks(sd, p, "decoder_blocks")
    _norm(sd, "decoder_norm", p["decoder_norm"])
    _linear(sd, "decoder_pred", p["decoder_pred"])
    dec_dim = sd["decoder_embed.bias"].shape[0]
    sd["pos_embed"] = get_2d_sincos_pos_embed(d, grid)[None]
    sd["decoder_pos_embed"] = get_2d_sincos_pos_embed(dec_dim, grid)[None]
    return sd


def _fetch_if_url(path: str) -> str:
    """An ``http://``, ``https://`` or ``file://`` checkpoint URL fetched
    once into ``~/.cache/countr_tpu_torch/ckpts/`` (the reference loads
    such resume paths through torch.hub, util/misc.py:340-342), named
    ``sha1(url)[:16] + "_" + basename``; the local path of the cached
    file. Local paths pass through untouched. Each process downloads to a
    temporary file of its own in the cache and renames it into place, so
    concurrent fetchers never read a partial file; on any failure the
    temporary file is removed."""
    if not path.startswith(("http://", "https://", "file://")):
        return path
    import hashlib
    import tempfile
    import urllib.request

    cache = os.path.expanduser("~/.cache/countr_tpu_torch/ckpts")
    os.makedirs(cache, exist_ok=True)
    name = hashlib.sha1(path.encode()).hexdigest()[:16] + "_" + os.path.basename(path)
    dest = os.path.join(cache, name)
    if not os.path.exists(dest):
        fd, tmp = tempfile.mkstemp(dir=cache, suffix=".part")
        os.close(fd)
        try:
            urllib.request.urlretrieve(path, tmp)
            os.replace(tmp, dest)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return dest


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A reference ``.pth`` ({'model': state_dict, ...} or a bare
    state_dict) -> its model state_dict as fp32 CPU tensors. ``path`` may
    be an ``http://``, ``https://`` or ``file://`` URL, fetched to a local
    cache first (``_fetch_if_url``)."""
    ckpt = torch.load(_fetch_if_url(path), map_location="cpu", weights_only=False)
    sd = ckpt.get("model", ckpt) if isinstance(ckpt, dict) else ckpt
    return {k: v.detach().float() for k, v in sd.items()}


def load_weights(model: torch.nn.Module, state_dict: Mapping[str, Any]) -> None:
    """Load a numpy or tensor state_dict into ``model`` with strict=True
    (onto the model's own device)."""
    sd = {k: v if torch.is_tensor(v) else torch.from_numpy(np.array(v, np.float32))
          for k, v in state_dict.items()}
    model.load_state_dict(sd, strict=True)


_CHECKPOINT = "checkpoint-{}.pth"  # the reference's file name (util/misc.py:304-335)
_CHECKPOINT_RE = re.compile(r"checkpoint-(\d+)\.pth")


def _checkpoint_path(directory: str, step: int) -> str:
    return os.path.join(directory, _CHECKPOINT.format(step))


def _steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in map(_CHECKPOINT_RE.fullmatch, os.listdir(directory))
                  if m)


def latest_step(directory: str) -> Optional[int]:
    """The highest step saved under ``directory``, or None."""
    steps = _steps(directory)
    return steps[-1] if steps else None


def save_checkpoint(directory: str, step: int, state, keep: int = 3) -> str:
    """Write ``state`` as ``directory/checkpoint-{step}.pth`` and keep the
    ``keep`` highest steps (orbax's ``max_to_keep``). ``state`` is a
    ``TrainState`` (the model, the optimizer, ``epoch`` = ``step``, and
    the state's ``step``, ``updates``, ``accum_iter`` and accumulator) or
    a module (its weights alone: a params-only file). The file is written
    under a temporary name and renamed, so a reader never sees half of
    one. The random generators are not part of the state: a caller seeds
    them per batch, as the JAX package derives its keys from the step.
    Returns the path."""
    os.makedirs(directory, exist_ok=True)
    if isinstance(state, torch.nn.Module):
        payload = {"model": state.state_dict(), "epoch": step}
    else:
        payload = {"model": state.model.state_dict(),
                   "optimizer": state.optimizer.state_dict(), "epoch": step,
                   "step": state.step, "updates": state.updates,
                   "accum_iter": state.accum_iter, "accum": list(state.acc)}
    path = _checkpoint_path(directory, step)
    torch.save(payload, path + ".tmp")
    os.replace(path + ".tmp", path)
    for old in _steps(directory)[:-keep]:
        os.remove(_checkpoint_path(directory, old))
    return path


def _resolve_step(directory: str, step: Optional[int]) -> int:
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {directory}")
    return step


def restore_checkpoint(directory: str, state, step: Optional[int] = None) -> int:
    """Restore the ``TrainState`` saved at ``step`` (default: the latest)
    into ``state`` in place: the weights, Adam's moments and step counts
    and the accumulator are copied into the live tensors (the gradient
    buffers, which every step zeroes first, are zeroed), and ``step`` and
    ``updates`` are set; no tensor is replaced, so the graphs of a
    graphed step stay valid. Returns the step restored."""
    step = _resolve_step(directory, step)
    ckpt = torch.load(_checkpoint_path(directory, step), map_location="cpu", weights_only=False)
    if "optimizer" not in ckpt:
        raise ValueError(f"{_checkpoint_path(directory, step)} holds weights only; "
                         "use restore_params")
    if ckpt["accum_iter"] != state.accum_iter:
        raise ValueError(f"the checkpoint accumulates over {ckpt['accum_iter']} mini-steps, "
                         f"the state over {state.accum_iter}")
    saved = ckpt["optimizer"]
    want = [len(g["params"]) for g in state.optimizer.param_groups]
    if [len(g["params"]) for g in saved["param_groups"]] != want \
            or len(saved["state"]) != len(state.params):
        raise ValueError("the checkpoint's optimizer groups do not match the state's")
    state.model.load_state_dict(ckpt["model"])  # copy_ into each parameter
    with torch.no_grad():
        for i, p in enumerate(state.params):
            for name, t in zip(("step", "exp_avg", "exp_avg_sq"), state.moments(p)):
                t.copy_(saved["state"][i][name])
        for a, s in zip(state.acc, ckpt["accum"], strict=True):
            a.copy_(s)
        state.zero_grads()
    state.step, state.updates = ckpt["step"], ckpt["updates"]
    return step


def restore_params(directory: str, step: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """The model weights alone, from a full or a params-only checkpoint
    at ``step`` (default: the latest), as fp32 CPU tensors (load them with
    ``load_weights``)."""
    return load_torch_checkpoint(_checkpoint_path(directory, _resolve_step(directory, step)))
