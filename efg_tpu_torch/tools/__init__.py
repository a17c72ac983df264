"""Diagnostic scripts of the port, each run as `python -m efg_tpu_torch.tools.<name>`."""
