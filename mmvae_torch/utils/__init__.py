"""Utilities: the profiling and timing harness, PNG image grids."""

from mmvae_torch.utils.images import save_image_grid, write_png
from mmvae_torch.utils.profiling import measure_samples_per_sec, trace

__all__ = ["trace", "measure_samples_per_sec", "save_image_grid", "write_png"]
