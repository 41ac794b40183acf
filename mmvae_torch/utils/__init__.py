"""Utilities: PNG image grids."""

from mmvae_torch.utils.images import save_image_grid, write_png

__all__ = ["save_image_grid", "write_png"]
