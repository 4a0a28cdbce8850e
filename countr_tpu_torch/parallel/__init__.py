"""Data parallelism on ``torch.distributed`` (counterpart of
``countr_tpu/parallel``): process groups and rank plumbing (``dist``), and
the device mesh of a run (``mesh``)."""
