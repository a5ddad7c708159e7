"""Command-line entry points of the port (the root whitebox_torch.py)."""
