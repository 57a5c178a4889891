"""Runnable examples of the port (python -m raytpu_torch.examples.<name>)."""
