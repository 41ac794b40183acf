"""A PNG writer and image grids with numpy and zlib only (port of
``mmvae_tpu/utils/images.py``): the ``sample`` and ``generate`` CLI write
their images with it, with no imaging library."""

from __future__ import annotations

import struct
import zlib

import numpy as np

__all__ = ["save_image_grid", "write_png"]


def write_png(path: str, image: np.ndarray) -> None:
    """An (H, W) or (H, W, 3) uint8 array, or floats in [0, 1], as an 8-bit
    grayscale or RGB PNG file."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    if c not in (1, 3):
        raise ValueError(f"unsupported channel count {c}")
    color_type = 0 if c == 1 else 2
    # Each scanline starts with its filter byte, 0 (none).
    raw = b"".join(b"\x00" + img[row].tobytes() for row in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    png = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
           + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)


def save_image_grid(images, path: str, *, n_cols: int = 8, pad: int = 2) -> None:
    """A batch of (N, H, W) or (N, H, W, 3) images in [0, 1] tiled into one
    PNG, ``n_cols`` to a row, ``pad`` white pixels around each."""
    imgs = np.asarray(images)
    if imgs.ndim == 3:
        imgs = imgs[..., None]
    n, h, w, c = imgs.shape
    n_cols = min(n_cols, n)
    n_rows = -(-n // n_cols)
    grid = np.ones((n_rows * (h + pad) + pad, n_cols * (w + pad) + pad, c), dtype=np.float32)
    for i in range(n):
        r, col = divmod(i, n_cols)
        y, x = pad + r * (h + pad), pad + col * (w + pad)
        grid[y:y + h, x:x + w] = imgs[i]
    write_png(path, grid[..., 0] if c == 1 else grid)
