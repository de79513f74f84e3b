"""Examples that run on the port (``python -m repro_torch.examples.<name>``)."""
