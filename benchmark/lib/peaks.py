"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the 700 W power limit): the yardstick of every
roofline and MFU share. A card set below 700 W runs slower; each result
records ``nvidia-smi``'s power limit beside its shares."""

BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def least_seconds(flops: float, nbytes: float, flops_peak: float = BF16_FLOPS) -> float:
    """The least time the card could take: the larger of the operations
    over the peak rate and the bytes over the memory bandwidth."""
    return max(flops / flops_peak, nbytes / HBM_BYTES_PER_S)
