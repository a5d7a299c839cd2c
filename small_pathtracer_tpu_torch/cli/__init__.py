"""Command-line interface: ``python -m small_pathtracer_tpu_torch.cli``."""

from .main import main

__all__ = ["main"]
