"""Scripts of the port: `python -m grove_tpu_torch.scripts.NAME`."""
