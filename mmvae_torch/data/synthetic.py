"""Seeded synthetic data (port of ``mmvae_tpu/data/synthetic.py:31-356``).

numpy generators whose cross-modal structure is learnable: an MNIST image
is a jittered glyph of its paired label plus noise; a FashionMNIST image
is its label's garment silhouette, shifted, scaled and noised; a MultiMNIST canvas
composites 1-4 glyphs left to right and its text is their digit string; a
CelebA face is drawn procedurally, each of its 18 attributes changing a
visible feature; a CUB bird's color, wing size and beak length are drawn
and named in its templated caption (23 token ids with the reserved ones).
The same seed gives byte-identical arrays to the JAX package's
generators; the port keeps its own copy so it never imports the JAX
package.
"""

from __future__ import annotations

import numpy as np

from mmvae_torch.data.vocab import Vocab
from mmvae_torch.models.text import PAD, STOP

__all__ = ["make_mnist", "make_fashionmnist", "make_multimnist", "make_celeba", "make_cub",
           "cub_vocab", "CELEBA_ATTRS"]

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


def _garment_masks(hw: int = 28) -> np.ndarray:
    """(10, hw, hw) distinct procedural garment-ish silhouettes."""
    yy, xx = np.mgrid[0:hw, 0:hw].astype(np.float32) / (hw - 1)
    masks = np.zeros((10, hw, hw), np.float32)
    masks[0] = ((abs(xx - 0.5) < 0.3) & (yy > 0.2) & (yy < 0.8)).astype(
        np.float32
    )  # t-shirt body
    masks[0] += ((abs(xx - 0.5) < 0.48) & (yy > 0.2) & (yy < 0.35)).astype(
        np.float32
    )  # sleeves
    masks[1] = (
        ((abs(xx - 0.35) < 0.1) | (abs(xx - 0.65) < 0.1)) & (yy > 0.15)
    ).astype(np.float32)  # trousers
    masks[2] = ((abs(xx - 0.5) < 0.35) & (yy > 0.15) & (yy < 0.85)).astype(
        np.float32
    )  # pullover (wide)
    masks[3] = (
        (abs(xx - 0.5) < 0.15 + 0.3 * yy) & (yy > 0.1) & (yy < 0.9)
    ).astype(np.float32)  # dress (flared)
    masks[4] = ((abs(xx - 0.5) < 0.4) & (yy > 0.1) & (yy < 0.95)).astype(
        np.float32
    ) * (0.6 + 0.4 * (xx < 0.5))  # coat (asymmetric shading)
    masks[5] = ((yy > 0.6) & (yy < 0.75) & (xx > 0.1) & (xx < 0.9)).astype(
        np.float32
    )  # sandal (flat strip)
    masks[6] = masks[0] * (0.5 + 0.5 * ((yy * 14).astype(int) % 2))  # shirt
    masks[7] = (
        ((yy > 0.55) & (yy < 0.8) & (xx > 0.05) & (xx < 0.85))
        & ((yy - 0.55) < 0.25 * (1 - xx))
    ).astype(np.float32) + ((yy > 0.7) & (yy < 0.8)).astype(
        np.float32
    ) * 0.5  # sneaker (wedge)
    masks[8] = ((abs(xx - 0.5) < 0.3) & (abs(yy - 0.6) < 0.25)).astype(
        np.float32
    ) + ((abs(xx - 0.5) < 0.15) & (abs(yy - 0.25) < 0.12)).astype(
        np.float32
    )  # bag + handle
    masks[9] = (
        ((abs(xx - 0.4) < 0.12) & (yy > 0.15) & (yy < 0.8))
        | ((yy > 0.65) & (yy < 0.8) & (xx > 0.28) & (xx < 0.8))
    ).astype(np.float32)  # boot
    return np.clip(masks, 0.0, 1.0)


def make_fashionmnist(n: int, seed: int = 0) -> dict[str, np.ndarray]:
    """FashionMNIST-shaped pairs: one of 10 garment silhouettes, shifted by
    up to 2 px, scaled in brightness and noised (image (n,28,28) f32 in
    [0,1]), and its label (n,) i32."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, size=n).astype(np.int32)
    templates = _garment_masks()
    imgs = templates[labels]
    bright = rng.uniform(0.6, 1.0, size=(n, 1, 1)).astype(np.float32)
    shift_y = rng.integers(-2, 3, size=n)
    shift_x = rng.integers(-2, 3, size=n)
    out = np.empty_like(imgs)
    for i in range(n):
        out[i] = np.roll(imgs[i], (shift_y[i], shift_x[i]), axis=(0, 1))
    out = out * bright + rng.normal(0, 0.03, out.shape).astype(np.float32)
    return {"image": np.clip(out, 0, 1), "label": labels}


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


# 18 CelebA-style binary attributes; each deterministically drives a
# visual feature of the procedural 64x64 face.
CELEBA_ATTRS = [
    "bangs", "black_hair", "blond_hair", "brown_hair", "bushy_eyebrows",
    "chubby", "eyeglasses", "heavy_makeup", "male", "mouth_open",
    "mustache", "no_beard", "pale_skin", "receding_hairline", "smiling",
    "straight_hair", "wavy_hair", "young",
]


def make_celeba(n: int, seed: int = 0, hw: int = 64):
    """CelebA-shaped pairs: image (n,64,64,3) f32 [0,1], attrs (n,18) f32.

    Every attribute visibly alters the image (hair color/shape, glasses,
    mouth, skin tone, face width, ...), so attribute<->image cross-modal
    inference is learnable.
    """
    rng = np.random.default_rng(seed)
    attrs = rng.integers(0, 2, size=(n, 18)).astype(np.float32)
    a = attrs.astype(bool)
    yy, xx = np.mgrid[0:hw, 0:hw].astype(np.float32) / (hw - 1)
    img = np.empty((n, hw, hw, 3), np.float32)
    # Background hue varies with "young".
    img[:] = np.where(
        a[:, 17, None, None, None], [0.45, 0.62, 0.78], [0.35, 0.38, 0.42]
    )
    cx = 0.5
    width = np.where(a[:, 8], 0.30, 0.24) * np.where(a[:, 5], 1.15, 1.0)
    face = (
        ((xx[None] - cx) / width[:, None, None]) ** 2
        + ((yy[None] - 0.55) / 0.33) ** 2
    ) < 1.0  # (n, hw, hw)
    skin = np.where(
        a[:, 12, None], [0.93, 0.85, 0.78], [0.78, 0.62, 0.50]
    ) + np.where(a[:, 7, None], [0.05, -0.05, 0.0], [0.0, 0.0, 0.0])
    img[face] = np.repeat(
        skin[:, None, None, :], hw * hw, axis=1
    ).reshape(n, hw, hw, 3)[face]
    # Hair: color from black/blond/brown (priority order), style from
    # straight/wavy/receding/bangs.
    hair_color = np.select(
        [a[:, 1, None], a[:, 2, None], a[:, 3, None]],
        [
            np.full((n, 3), [0.08, 0.07, 0.07]),
            np.full((n, 3), [0.85, 0.72, 0.35]),
            np.full((n, 3), [0.42, 0.26, 0.13]),
        ],
        default=np.full((n, 3), [0.25, 0.2, 0.18]),
    )
    hair_bottom = np.where(a[:, 13], 0.22, 0.34) + np.where(
        a[:, 0], 0.10, 0.0
    )
    wave = np.where(a[:, 16], 0.04, 0.0)
    hair = (yy[None] < hair_bottom[:, None, None] + wave[:, None, None]
            * np.sin(12 * np.pi * xx)[None]) & face
    img[hair] = np.repeat(
        hair_color[:, None, None, :], hw * hw, axis=1
    ).reshape(n, hw, hw, 3)[hair]
    # Eyes, eyebrows, glasses.
    eye_y = (yy[None] > 0.47) & (yy[None] < 0.52)
    eye_x = (np.abs(xx[None] - 0.38) < 0.05) | (np.abs(xx[None] - 0.62) < 0.05)
    eyes = eye_y & eye_x & face
    img[eyes] = 0.05
    brows = (
        (yy[None] > 0.42)
        & (yy[None] < 0.42 + np.where(a[:, 4], 0.035, 0.015)[:, None, None])
        & eye_x
        & face
    )
    img[brows] = 0.1
    glasses = (
        a[:, 6, None, None]
        & (
            ((np.abs(xx[None] - 0.38) < 0.09) | (np.abs(xx[None] - 0.62) < 0.09))
            & (np.abs(yy[None] - 0.495) < 0.06)
            & ~(
                ((np.abs(xx[None] - 0.38) < 0.07) | (np.abs(xx[None] - 0.62) < 0.07))
                & (np.abs(yy[None] - 0.495) < 0.045)
            )
        )
    )
    img[glasses & face] = 0.02
    # Mouth: smiling widens, open heightens.
    mouth_w = np.where(a[:, 14], 0.14, 0.07)
    mouth_h = np.where(a[:, 9], 0.045, 0.015)
    mouth = (
        (np.abs(xx[None] - 0.5) < mouth_w[:, None, None])
        & (np.abs(yy[None] - 0.75) < mouth_h[:, None, None])
        & face
    )
    mcol = np.where(a[:, 7, None], [0.8, 0.1, 0.2], [0.55, 0.25, 0.25])
    img[mouth] = np.repeat(
        mcol[:, None, None, :], hw * hw, axis=1
    ).reshape(n, hw, hw, 3)[mouth]
    # Mustache / beard shadow.
    must = (
        a[:, 10, None, None]
        & (np.abs(xx[None] - 0.5) < 0.12)
        & (np.abs(yy[None] - 0.68) < 0.02)
        & face
    )
    img[must] = 0.1
    beard = (
        (~a[:, 11])[:, None, None]
        & (yy[None] > 0.78)
        & face
    )
    img[beard] = img[beard] * 0.55
    img += rng.normal(0, 0.02, img.shape).astype(np.float32)
    return {"image": np.clip(img, 0, 1), "attrs": attrs}


_CUB_COLORS = {
    "red": (0.85, 0.15, 0.15),
    "blue": (0.2, 0.3, 0.85),
    "yellow": (0.9, 0.85, 0.2),
    "green": (0.2, 0.7, 0.3),
    "brown": (0.5, 0.33, 0.16),
    "grey": (0.55, 0.55, 0.55),
}
_CUB_SIZES = {"small": 0.16, "medium": 0.24, "large": 0.32}
_CUB_BEAKS = {"short": 0.05, "long": 0.12}


def cub_vocab() -> Vocab:
    """The synthetic caption vocabulary: 3 reserved ids and 20 words."""
    words = (
        "this bird has a body with wings and beak".split()
        + list(_CUB_COLORS)
        + list(_CUB_SIZES)
        + list(_CUB_BEAKS)
    )
    return Vocab(words)


def make_cub(n: int, seed: int = 0, hw: int = 64, max_len: int = 32):
    """CUB-shaped pairs: bird image (n, hw, hw, 3) f32 in [0, 1] and its
    caption (n, max_len) i32, "this bird has a <color> body with <size>
    wings and a <beak> beak", each named feature visible in the image."""
    rng = np.random.default_rng(seed)
    vocab = cub_vocab()
    colors = list(_CUB_COLORS)
    sizes = list(_CUB_SIZES)
    beaks = list(_CUB_BEAKS)
    yy, xx = np.mgrid[0:hw, 0:hw].astype(np.float32) / (hw - 1)
    images = np.empty((n, hw, hw, 3), np.float32)
    tokens = np.zeros((n, max_len), np.int32)
    ci = rng.integers(0, len(colors), size=n)
    si = rng.integers(0, len(sizes), size=n)
    bi = rng.integers(0, len(beaks), size=n)
    bg = rng.uniform(0.55, 0.8, size=(n, 1, 1, 1)).astype(np.float32)
    images[:] = bg * np.array([0.75, 0.9, 1.0], np.float32)
    jx = rng.uniform(-0.06, 0.06, size=n)
    jy = rng.uniform(-0.06, 0.06, size=n)
    for i in range(n):
        color = np.array(_CUB_COLORS[colors[ci[i]]], np.float32)
        body_r = 0.18
        wing_r = _CUB_SIZES[sizes[si[i]]]
        beak_len = _CUB_BEAKS[beaks[bi[i]]]
        cx, cy = 0.5 + jx[i], 0.55 + jy[i]
        body = ((xx - cx) / body_r) ** 2 + ((yy - cy) / (body_r * 1.2)) ** 2 < 1
        wing = ((xx - cx + wing_r * 0.7) / wing_r) ** 2 + (
            (yy - cy - 0.03) / (wing_r * 0.5)
        ) ** 2 < 1
        head = ((xx - cx - body_r * 0.9) / 0.08) ** 2 + (
            (yy - cy + body_r * 1.1) / 0.08
        ) ** 2 < 1
        beak = (
            (xx > cx + body_r * 0.9 + 0.06)
            & (xx < cx + body_r * 0.9 + 0.06 + beak_len)
            & (np.abs(yy - (cy - body_r * 1.1)) < 0.015)
        )
        images[i][body] = color
        images[i][wing] = color * 0.6
        images[i][head] = color
        images[i][beak] = (0.95, 0.65, 0.1)
        sent = (
            f"this bird has a {colors[ci[i]]} body with {sizes[si[i]]} "
            f"wings and a {beaks[bi[i]]} beak"
        )
        tokens[i] = vocab.encode(sent, max_len)
    images += rng.normal(0, 0.02, images.shape).astype(np.float32)
    return {"image": np.clip(images, 0, 1), "text": tokens}
