"""Command-line entry points of the port (``python -m countr_tpu_torch.cli.<name>``)."""
