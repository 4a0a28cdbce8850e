"""Shared helpers for the port's parity tests (tests/test_torch_*.py):
a tiny JAX CounTR with its params, and the same weights in the port's
model through the weight bridge.

Importing this module caps torch's intra-op threads at one: the suite
runs under several xdist workers, every worker imports every test file,
and each worker's torch would otherwise start a thread per core, so that
six workers on eight cores run ~48 spinning threads (the port's heaviest
files ran 2-10x slower so)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from countr_tpu.config import CounTRConfig as JaxConfig
from countr_tpu.models.countr import CounTR as JaxCounTR
from countr_tpu_torch.config import CounTRConfig as TorchConfig
from countr_tpu_torch.engine.checkpoint import load_weights, state_dict_from_flax
from countr_tpu_torch.models.countr import CounTR as TorchCounTR

torch.set_num_threads(1)

# Full 384 window geometry, skinny widths (CLAUDE.md: tiny test configs).
TINY = dict(
    img_size=384, patch_size=16, embed_dim=64, depth=2, num_heads=4,
    decoder_embed_dim=64, decoder_depth=2, decoder_num_heads=4, head_width=32,
)
BF16_FAST = dict(use_pallas_attention=True, approx_gelu=True, subpixel_head=True)


def jax_model(seed: int = 0, mode: str = "fp32", jit: bool = False, **kw):
    """(model, params) of a tiny JAX CounTR; params are randomised well
    beyond the init (non-trivial LN/GN affines and biases). ``jit`` runs
    the init compiled (seconds where the eager init takes ~15 s at 384; its
    values may differ from the eager init's in the last bits)."""
    dt = jnp.bfloat16 if mode == "bf16" else jnp.float32
    extra = BF16_FAST if mode == "bf16" else {}
    cfg = JaxConfig(**{**TINY, **kw, **extra, "dtype": dt})
    model = JaxCounTR(cfg)
    init = jax.jit(model.init, static_argnums=3) if jit else model.init
    params = init(
        jax.random.key(seed), jnp.zeros((1, 384, 384, 3)),
        jnp.zeros((1, 3, 64, 64, 3)), 3,
    )
    rng = np.random.default_rng(seed + 100)
    leaves, tree = jax.tree.flatten(params)
    leaves = [np.asarray(l) + 0.02 * rng.standard_normal(np.shape(l)).astype(np.float32)
              for l in leaves]
    return model, jax.tree.unflatten(tree, [jnp.asarray(l) for l in leaves])


def torch_model(params, mode: str = "fp32", **kw) -> TorchCounTR:
    """The port's CounTR at the same config, on the CPU, with ``params``
    loaded through state_dict_from_flax (strict)."""
    dt = torch.bfloat16 if mode == "bf16" else torch.float32
    extra = BF16_FAST if mode == "bf16" else {}
    cfg = TorchConfig(**{**TINY, **kw, **extra, "dtype": dt})
    model = TorchCounTR(cfg)
    load_weights(model, state_dict_from_flax(jax.tree.map(np.asarray, params)))
    return model.eval()

