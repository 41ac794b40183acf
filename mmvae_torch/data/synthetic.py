"""Seeded synthetic data (port of ``mmvae_tpu/data/synthetic.py:31-83, :146-170``).

numpy generators whose cross-modal structure is learnable: an MNIST image
is a jittered glyph of its paired label plus noise; a MultiMNIST canvas
composites 1-4 glyphs left to right and its text is their digit string.
The same seed gives byte-identical arrays to the JAX package's
generators; the port keeps its own copy so it never imports the JAX
package.
"""

from __future__ import annotations

import numpy as np

from mmvae_torch.models.text import PAD, STOP

__all__ = ["make_mnist", "make_multimnist"]

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


def make_multimnist(n: int, seed: int = 0, hw: int = 50, max_digits: int = 4):
    """MultiMNIST: 1..max_digits digits composited left to right on an
    hw x hw canvas; text = token sequence (digit d -> 3+d, then STOP, PAD).
    image (n, hw, hw) f32 in [0, 1], text (n, max_digits + 1) i32."""
    rng = np.random.default_rng(seed)
    glyphs = _digit_glyphs()
    scale = 2
    big = np.kron(glyphs, np.ones((scale, scale), np.float32))  # (10,14,10)
    gh, gw = big.shape[1:]
    seq_len = max_digits + 1
    images = np.zeros((n, hw, hw), np.float32)
    tokens = np.full((n, seq_len), PAD, np.int32)
    counts = rng.integers(1, max_digits + 1, size=n)
    for i in range(n):
        k = counts[i]
        digits = rng.integers(0, 10, size=k)
        xs = np.sort(rng.integers(0, hw - gw + 1, size=k))
        ys = rng.integers(0, hw - gh + 1, size=k)
        for d, x0, y0 in zip(digits, xs, ys):
            patch = images[i, y0 : y0 + gh, x0 : x0 + gw]
            np.maximum(patch, big[d], out=patch)
        tokens[i, :k] = digits + 3
        tokens[i, k] = STOP
    images += rng.normal(0, 0.02, images.shape).astype(np.float32)
    return {"image": np.clip(images, 0, 1), "text": tokens}
