"""Seeded synthetic MNIST-shaped data (port of ``mmvae_tpu/data/synthetic.py:31-83``).

A vectorized numpy generator whose cross-modal structure is learnable: each
image is a jittered glyph of its paired label plus noise. The same seed
gives byte-identical arrays to the JAX package's generator; the port keeps
its own copy so it never imports the JAX package.
"""

from __future__ import annotations

import numpy as np

__all__ = ["make_mnist"]

# 5x7 bitmap font for digits 0-9 (rows top->bottom).
_DIGIT_FONT = np.array(
    [
        [0b01110, 0b10001, 0b10011, 0b10101, 0b11001, 0b10001, 0b01110],  # 0
        [0b00100, 0b01100, 0b00100, 0b00100, 0b00100, 0b00100, 0b01110],  # 1
        [0b01110, 0b10001, 0b00001, 0b00110, 0b01000, 0b10000, 0b11111],  # 2
        [0b01110, 0b10001, 0b00001, 0b00110, 0b00001, 0b10001, 0b01110],  # 3
        [0b00010, 0b00110, 0b01010, 0b10010, 0b11111, 0b00010, 0b00010],  # 4
        [0b11111, 0b10000, 0b11110, 0b00001, 0b00001, 0b10001, 0b01110],  # 5
        [0b01110, 0b10000, 0b11110, 0b10001, 0b10001, 0b10001, 0b01110],  # 6
        [0b11111, 0b00001, 0b00010, 0b00100, 0b01000, 0b01000, 0b01000],  # 7
        [0b01110, 0b10001, 0b10001, 0b01110, 0b10001, 0b10001, 0b01110],  # 8
        [0b01110, 0b10001, 0b10001, 0b01111, 0b00001, 0b00001, 0b01110],  # 9
    ],
    dtype=np.uint32,
)


def _digit_glyphs() -> np.ndarray:
    """(10, 7, 5) float glyph bitmaps."""
    bits = (
        _DIGIT_FONT[:, :, None] >> np.arange(4, -1, -1)[None, None, :]
    ) & 1
    return bits.astype(np.float32)


def _render_digits(labels, rng, hw: int = 28) -> np.ndarray:
    """Render each label as a jittered glyph on an hw x hw canvas."""
    glyphs = _digit_glyphs()  # (10, 7, 5)
    scale = 3
    big = np.kron(glyphs, np.ones((scale, scale), np.float32))  # (10,21,15)
    gh, gw = big.shape[1:]
    n = len(labels)
    canvases = np.zeros((n, hw, hw), dtype=np.float32)
    # Centered with a small +-2 px jitter, like center-normalized MNIST.
    cy, cx = (hw - gh) // 2, (hw - gw) // 2
    ys = np.clip(cy + rng.integers(-2, 3, size=n), 0, hw - gh)
    xs = np.clip(cx + rng.integers(-2, 3, size=n), 0, hw - gw)
    thick = rng.uniform(0.75, 1.0, size=n).astype(np.float32)
    for i in range(n):
        canvases[i, ys[i] : ys[i] + gh, xs[i] : xs[i] + gw] = (
            big[labels[i]] * thick[i]
        )
    canvases += rng.normal(0.0, 0.03, size=canvases.shape).astype(np.float32)
    return np.clip(canvases, 0.0, 1.0)


def make_mnist(n: int, seed: int = 0) -> dict[str, np.ndarray]:
    """MNIST-shaped pairs: image (n, 28, 28) f32 in [0, 1], label (n,) i32."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, size=n).astype(np.int32)
    return {"image": _render_digits(labels, rng), "label": labels}
