"""Weights in the reference ``.pth`` layout (counterpart of
``countr_tpu/engine/checkpoint.py``).

The port's modules carry the reference SupervisedMAE and
MaskedAutoencoderViTNoCT state_dict keys, so a released checkpoint loads
with ``load_state_dict(strict=True)``. ``state_dict_from_flax`` and
``mae_state_dict_from_flax`` are the bridges from the JAX package: they
turn its flax param trees (as numpy arrays) into the same state_dicts —
the port's own copy of the logic of ``export_countr_state_dict``, and
the inverse of ``convert_mae_state_dict``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

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


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A reference ``.pth`` ({'model': state_dict, ...} or a bare
    state_dict) -> its model state_dict as fp32 CPU tensors."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("model", ckpt) if isinstance(ckpt, dict) else ckpt
    return {k: v.detach().float() for k, v in sd.items()}


def load_weights(model: torch.nn.Module, state_dict: Mapping[str, Any]) -> None:
    """Load a numpy or tensor state_dict into ``model`` with strict=True
    (onto the model's own device)."""
    sd = {k: v if torch.is_tensor(v) else torch.from_numpy(np.array(v, np.float32))
          for k, v in state_dict.items()}
    model.load_state_dict(sd, strict=True)
