"""Fixed 2D sine-cosine position embeddings and their resampling (numpy
copies of ``countr_tpu/ops/posembed.py``: ``get_2d_sincos_pos_embed`` and
``interpolate_pos_embed``).

Built on the host in float64 and cast to fp32, in the reference's exact
channel order (reference: util/pos_embed.py:20-67).
"""

from __future__ import annotations

import numpy as np


def _sincos_1d(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    """[M] positions -> [M, embed_dim] with sin in the first half."""
    assert embed_dim % 2 == 0
    omega = np.arange(embed_dim // 2, dtype=np.float64)
    omega /= embed_dim / 2.0
    omega = 1.0 / 10000**omega
    out = np.einsum("m,d->md", pos.reshape(-1).astype(np.float64), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def _cubic_kernel(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Keys cubic convolution kernel with torch's a=-0.75."""
    ax = np.abs(x)
    return np.where(
        ax <= 1.0,
        (a + 2.0) * ax**3 - (a + 3.0) * ax**2 + 1.0,
        np.where(ax < 2.0, a * ax**3 - 5.0 * a * ax**2 + 8.0 * a * ax - 4.0 * a, 0.0),
    )


def _bicubic_resize_1d_matrix(n_src: int, n_dst: int) -> np.ndarray:
    """[n_src, n_dst] weights of torch's F.interpolate(mode='bicubic',
    align_corners=False, antialias=False) along one axis: half-pixel
    source centers, 4 taps, edge-clamped."""
    scale = n_src / n_dst
    i = np.arange(n_dst, dtype=np.float64)
    src = (i + 0.5) * scale - 0.5
    base = np.floor(src).astype(np.int64)
    frac = src - base
    mat = np.zeros((n_src, n_dst), dtype=np.float64)
    for t in range(-1, 3):
        idx = np.clip(base + t, 0, n_src - 1)
        np.add.at(mat, (idx, np.arange(n_dst)), _cubic_kernel(t - frac))
    return mat


def interpolate_pos_embed(
    pos_embed: np.ndarray, new_grid_size: int, num_extra_tokens: int = 0,
) -> np.ndarray:
    """Bicubically resample a [T, D] (or [1, T, D]) position embedding from
    its square grid to ``new_grid_size`` x ``new_grid_size``, the leading
    ``num_extra_tokens`` (cls) tokens unchanged: the reference's
    checkpoint-resolution adapter (util/pos_embed.py:75-96, torch
    F.interpolate bicubic, align_corners=False) as two separable float64
    products on the host."""
    pos = np.asarray(pos_embed, dtype=np.float64)
    squeeze = pos.ndim == 2
    if squeeze:
        pos = pos[None]
    extra = pos[:, :num_extra_tokens]
    tokens = pos[:, num_extra_tokens:]
    orig = int(round(tokens.shape[1] ** 0.5))
    if orig * orig != tokens.shape[1]:
        raise ValueError(f"pos embed token count {tokens.shape[1]} is not square")
    if orig != new_grid_size:
        d = tokens.shape[-1]
        grid = tokens.reshape(-1, orig, orig, d)
        m = _bicubic_resize_1d_matrix(orig, new_grid_size)  # [orig, new]
        grid = np.einsum("bhwd,hH->bHwd", grid, m)
        grid = np.einsum("bHwd,wW->bHWd", grid, m)
        tokens = grid.reshape(pos.shape[0], new_grid_size * new_grid_size, d)
    out = np.concatenate([extra, tokens], axis=1).astype(np.float32)
    return out[0] if squeeze else out


def get_2d_sincos_pos_embed(
    embed_dim: int, grid_size: int, cls_token: bool = False
) -> np.ndarray:
    """Return [grid_size**2(+1), embed_dim] float32 position embedding.

    The reference feeds the w-coordinate map as the first ("h") half;
    that ordering is kept for checkpoint compatibility."""
    assert embed_dim % 2 == 0
    coords = np.arange(grid_size, dtype=np.float64)
    grid_w, grid_h = np.meshgrid(coords, coords)
    emb_first = _sincos_1d(embed_dim // 2, grid_w)
    emb_second = _sincos_1d(embed_dim // 2, grid_h)
    pos = np.concatenate([emb_first, emb_second], axis=1)
    if cls_token:
        pos = np.concatenate([np.zeros([1, embed_dim]), pos], axis=0)
    return pos.astype(np.float32)
