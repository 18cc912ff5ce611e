"""Example CLIs of the port (``python -m varnet_tpu_torch.examples.<case>``)."""
