"""Tensor ops of the port: plain PyTorch versions and the two Hopper
kernels (fused_ln: B1, fused_block: B2)."""

import functools

import torch


@functools.lru_cache(maxsize=None)
def device_constant(make, args: tuple, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """``make(*args)``, a numpy array, as a ``dtype`` tensor on ``device``:
    made once per (make, args, device, dtype) and shared by every caller,
    which only reads it. The copy to the card is a synchronous upload from
    pageable memory, which stream capture refuses, so a CUDA constant that
    is first asked for during a capture raises: an eager call (a graph's
    warm-up) makes it first. It is made outside inference mode, so that
    autograd may save it whichever mode first asked for it."""
    if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            f"device_constant: {make.__name__}{args} is not on {device} yet and the "
            "stream is capturing; run the function eagerly once before capture"
        )
    with torch.inference_mode(False):
        return torch.from_numpy(make(*args)).to(device, dtype)
