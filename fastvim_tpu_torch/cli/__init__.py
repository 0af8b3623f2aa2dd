"""Command-line entry points of the port (``python -m
fastvim_tpu_torch.cli.<name>``)."""
