"""Measurement scripts for the card (python -m raytpu_torch.tools.<name>)."""
