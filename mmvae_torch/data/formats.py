"""Readers of the datasets' distribution formats (port of ``mmvae_tpu/data/formats.py``).

``$MMVAE_DATA_DIR/<name>/<split>.npz`` is the drop point of real data
(``data/pipelines.py``). Where a dataset's directory holds no such file,
these readers take an unmodified download instead:

  * MNIST and FashionMNIST: the IDX pairs ``train-images-idx3-ubyte`` +
    ``train-labels-idx1-ubyte`` and ``t10k-...``, plain or gzipped;
  * MultiMNIST: composited from real MNIST digits, read from
    ``<dir>/multimnist/`` or the sibling ``<dir>/mnist/`` mount;
  * CelebA: ``list_attr_celeba.txt`` (the 18 attributes of the model picked
    by name from its 40) and ``img_align_celeba/`` (or ``images/``), each
    image center-cropped and resized to 64 x 64;
  * CUB: ``images/<class>/<name>.jpg`` paired with
    ``text_c10/<class>/<name>.txt`` (or ``text/``, ``captions/``), the
    first caption of each; the corpus's word vocabulary is built once and
    kept as ``vocab.json`` in the directory (model sizing reads it too).

Each returns a modality dict shaped as ``data/synthetic.py``'s, or None
where its files are absent. The raw CelebA and CUB readers import PIL
inside the function, so nothing else needs it. The same files give the
same arrays, to the bit, as the JAX package's readers; the port keeps its
own copy and imports nothing of that package.
"""

from __future__ import annotations

import gzip
import json
import os
import struct
from collections import Counter

import numpy as np

from mmvae_torch.data.synthetic import CELEBA_ATTRS
from mmvae_torch.data.vocab import Vocab
from mmvae_torch.models.text import PAD, STOP

__all__ = [
    "read_idx",
    "load_mnist_idx",
    "compose_multimnist",
    "load_multimnist_composite",
    "load_celeba_raw",
    "load_cub_raw",
    "cub_data_vocab",
]

# Split -> the seed of a composite's draws, as the synthetic splits take.
_SPLIT_SEEDS = {"train": 0, "test": 1_000_003}


def read_idx(path: str) -> np.ndarray:
    """One IDX file (a big-endian header: two zero bytes, the type code,
    the number of dims, then each dim), plain or ``.gz``."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        zero, dtype_code, ndim = struct.unpack(">HBB", f.read(4))
        if zero != 0:
            raise ValueError(f"{path}: bad IDX magic (leading {zero:#x})")
        dtypes = {
            0x08: np.uint8, 0x09: np.int8, 0x0B: np.int16,
            0x0C: np.int32, 0x0D: np.float32, 0x0E: np.float64,
        }
        if dtype_code not in dtypes:
            raise ValueError(f"{path}: unknown IDX dtype {dtype_code:#x}")
        shape = struct.unpack(f">{ndim}I", f.read(4 * ndim))
        data = np.frombuffer(f.read(), dtype=np.dtype(dtypes[dtype_code]).newbyteorder(">"))
    return data.reshape(shape)


_IDX_NAMES = {
    "train": ("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
    "test": ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"),
}


def _find_idx(dirpath: str, stem: str) -> str | None:
    for cand in (stem, stem + ".gz"):
        p = os.path.join(dirpath, cand)
        if os.path.exists(p):
            return p
    return None


def load_mnist_idx(dirpath: str, split: str) -> dict[str, np.ndarray] | None:
    """An MNIST-family IDX pair -> ``{image: (N, 28, 28) f32 in [0, 1],
    label: (N,) i32}``, or None if either file is absent."""
    img_stem, lab_stem = _IDX_NAMES[split]
    img_path = _find_idx(dirpath, img_stem)
    lab_path = _find_idx(dirpath, lab_stem)
    if img_path is None or lab_path is None:
        return None
    images = read_idx(img_path).astype(np.float32) / 255.0
    labels = read_idx(lab_path).astype(np.int32)
    if len(images) != len(labels):
        raise ValueError(f"{dirpath}: {len(images)} images vs {len(labels)} labels")
    return {"image": images, "label": labels}


def compose_multimnist(
    images: np.ndarray,
    labels: np.ndarray,
    n: int,
    seed: int,
    hw: int = 50,
    max_digits: int = 4,
) -> dict[str, np.ndarray]:
    """``n`` canvases of ``hw x hw``, each 1..``max_digits`` real digits
    drawn with replacement from ``images``/``labels``, placed at random
    offsets in left-to-right order and merged by per-pixel max; the text
    is their digit string (digit d is token 3 + d), then STOP, then PAD:
    the layout of ``synthetic.make_multimnist``. The draws of
    ``np.random.default_rng(seed)`` come in the JAX reader's order."""
    rng = np.random.default_rng(seed)
    gh, gw = images.shape[1:3]
    if gh > hw or gw > hw:
        raise ValueError(f"digit {gh}x{gw} larger than canvas {hw}")
    out = np.zeros((n, hw, hw), np.float32)
    tokens = np.full((n, max_digits + 1), PAD, np.int32)
    counts = rng.integers(1, max_digits + 1, size=n)
    for i in range(n):
        k = counts[i]
        idx = rng.integers(0, len(images), size=k)
        xs = np.sort(rng.integers(0, hw - gw + 1, size=k))
        ys = rng.integers(0, hw - gh + 1, size=k)
        for j, x0, y0 in zip(idx, xs, ys):
            patch = out[i, y0:y0 + gh, x0:x0 + gw]
            np.maximum(patch, images[j], out=patch)
        tokens[i, :k] = labels[idx].astype(np.int32) + 3
        tokens[i, k] = STOP
    return {"image": out, "text": tokens}


def load_multimnist_composite(
    data_dir: str,
    split: str,
    n: int | None = None,
    hw: int = 50,
    max_digits: int = 4,
) -> dict[str, np.ndarray] | None:
    """MultiMNIST composited from the MNIST IDX pair of ``split`` under
    ``<data_dir>/multimnist/``, else ``<data_dir>/mnist/``; None if neither
    holds it. Train canvases take train digits, test canvases t10k digits,
    each from the split's fixed seed, so every process makes the same
    split. ``n`` canvases (as many as there are digits by default)."""
    arrays = None
    for sub in ("multimnist", "mnist"):
        d = os.path.join(data_dir, sub)
        if os.path.isdir(d):
            arrays = load_mnist_idx(d, split)
            if arrays is not None:
                break
    if arrays is None:
        return None
    if n is None:
        n = len(arrays["image"])
    return compose_multimnist(arrays["image"], arrays["label"], n, _SPLIT_SEEDS[split],
                              hw=hw, max_digits=max_digits)


def _split_holdout(items, split: str, holdout: int):
    """The last ``holdout`` items are the test split, the rest train. A
    mount of at most ``holdout`` items holds out a fifth of them (at least
    one), so the splits never overlap."""
    n = len(items)
    if n <= holdout:
        holdout = max(1, n // 5)
    out = items[:-holdout] if split == "train" else items[-holdout:]
    if not out:
        raise ValueError(f"dataset too small to split: {n} examples, holdout {holdout}")
    return out


def _square_image(path: str, hw: int) -> np.ndarray:
    """An image as ``(hw, hw, 3)`` f32 in [0, 1]: RGB, center-cropped to a
    square, resized bilinearly."""
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("RGB")
        w, h = im.size
        s = min(w, h)
        im = im.crop(((w - s) // 2, (h - s) // 2, (w + s) // 2, (h + s) // 2)).resize(
            (hw, hw), Image.BILINEAR)
        return np.asarray(im, np.float32) / 255.0


def load_celeba_raw(
    dirpath: str, split: str, hw: int = 64, holdout: int = 2000, n: int | None = None,
) -> dict[str, np.ndarray] | None:
    """CelebA's layout -> ``{image: (N, hw, hw, 3) f32, attrs: (N, 18)
    f32 in {0, 1}}``, or None if ``list_attr_celeba.txt`` or the image
    directory is absent. The last ``holdout`` images (in the file's order)
    are the test split; ``n`` cuts the split before any image is decoded."""
    attr_path = os.path.join(dirpath, "list_attr_celeba.txt")
    img_dir = None
    for cand in ("img_align_celeba", "images"):
        d = os.path.join(dirpath, cand)
        if os.path.isdir(d):
            img_dir = d
            break
    if not os.path.exists(attr_path) or img_dir is None:
        return None
    with open(attr_path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    # The official file: a count line, a header line, then "<file> +1 -1 ...".
    if lines and lines[0].isdigit():
        lines = lines[1:]
    header = lines[0].split()
    cols = [header.index(a) for a in CELEBA_ATTRS]
    names, attrs = [], []
    for ln in lines[1:]:
        parts = ln.split()
        names.append(parts[0])
        vals = np.array([float(parts[1 + c]) for c in cols], np.float32)
        attrs.append((vals > 0).astype(np.float32))
    names = _split_holdout(names, split, holdout)
    attrs = _split_holdout(attrs, split, holdout)
    if n is not None:
        names, attrs = names[:n], attrs[:n]
    images = np.empty((len(names), hw, hw, 3), np.float32)
    for i, fname in enumerate(names):
        images[i] = _square_image(os.path.join(img_dir, fname), hw)
    return {"image": images, "attrs": np.stack(attrs)}


def _cub_pairs(dirpath: str) -> list[tuple[str, str]] | None:
    """Sorted (image, caption file) pairs of CUB's layout:
    ``images/<class>/<name>.jpg`` (or ``.jpeg``, ``.png``) with
    ``<text dir>/<class>/<name>.txt``, the text dir the first of
    ``text_c10``, ``text`` and ``captions`` that exists; None where there
    is no pair."""
    img_root = os.path.join(dirpath, "images")
    txt_root = None
    for cand in ("text_c10", "text", "captions"):
        d = os.path.join(dirpath, cand)
        if os.path.isdir(d):
            txt_root = d
            break
    if not os.path.isdir(img_root) or txt_root is None:
        return None
    pairs = []
    for root, _, files in os.walk(img_root):
        for fname in files:
            if not fname.lower().endswith((".jpg", ".jpeg", ".png")):
                continue
            rel = os.path.relpath(os.path.join(root, fname), img_root)
            txt = os.path.join(txt_root, os.path.splitext(rel)[0] + ".txt")
            if os.path.exists(txt):
                pairs.append((os.path.join(root, fname), txt))
    return sorted(pairs) or None


# (directory, max_words) -> its vocabulary: model sizing, train and test
# of one process share one scan of the corpus.
_VOCAB_CACHE: dict[tuple[str, int], Vocab] = {}


def cub_data_vocab(dirpath: str, max_words: int = 2000) -> Vocab | None:
    """The word vocabulary of a CUB caption corpus: the 3 reserved tokens,
    ``<unk>`` and the ``max_words`` most frequent words (ties in order of
    first appearance over the sorted pairs), or None without a corpus.

    A ``vocab.json`` in ``dirpath`` is read as it is. Else the corpus is
    scanned and the vocabulary written there (to a temporary file renamed
    into place, so no process reads a partial one); on a read-only mount
    the write is skipped, and every process derives the same vocabulary.
    Kept per (directory, ``max_words``) for the process."""
    key = (os.path.abspath(dirpath), max_words)
    if key in _VOCAB_CACHE:
        return _VOCAB_CACHE[key]
    vpath = os.path.join(dirpath, "vocab.json")
    if os.path.exists(vpath):
        with open(vpath) as f:
            itos = json.load(f)["itos"]
        v = Vocab([], unk=True)
        v.itos = itos
        v.stoi = {w: i for i, w in enumerate(itos)}
        _VOCAB_CACHE[key] = v
        return v
    pairs = _cub_pairs(dirpath)
    if pairs is None:
        return None
    counts: Counter = Counter()
    for _, txt in pairs:
        with open(txt) as f:
            for line in f:
                counts.update(_normalize_caption(line).split())
    v = Vocab([w for w, _ in counts.most_common(max_words)], unk=True)
    try:
        with open(vpath + ".tmp", "w") as f:
            json.dump({"itos": v.itos}, f)
        os.replace(vpath + ".tmp", vpath)
    except OSError:
        try:
            os.unlink(vpath + ".tmp")
        except OSError:
            pass
    _VOCAB_CACHE[key] = v
    return v


def _normalize_caption(line: str) -> str:
    """Lower case; letters, digits and spaces kept, ``-`` and ``/`` made
    spaces, everything else dropped; runs of spaces made one."""
    keep = []
    for ch in line.strip().lower():
        if ch.isalnum() or ch == " ":
            keep.append(ch)
        elif ch in "-/":
            keep.append(" ")
    return " ".join("".join(keep).split())


def load_cub_raw(
    dirpath: str, split: str, hw: int = 64, max_len: int = 32, holdout: int = 1000,
    n: int | None = None,
) -> dict[str, np.ndarray] | None:
    """CUB images and caption files -> ``{image: (N, hw, hw, 3) f32, text:
    (N, max_len) i32}``, or None without the layout. Each image takes the
    first non-empty line of its caption file, encoded over
    :func:`cub_data_vocab` (unknown words as ``<unk>``, then STOP, then
    PAD). The last ``holdout`` pairs are the test split; ``n`` cuts the
    split before any image is decoded."""
    pairs = _cub_pairs(dirpath)
    if pairs is None:
        return None
    vocab = cub_data_vocab(dirpath)
    pairs = _split_holdout(pairs, split, holdout)
    if n is not None:
        pairs = pairs[:n]
    images = np.empty((len(pairs), hw, hw, 3), np.float32)
    tokens = np.empty((len(pairs), max_len), np.int32)
    for i, (img_path, txt_path) in enumerate(pairs):
        images[i] = _square_image(img_path, hw)
        with open(txt_path) as f:
            first = next((ln for ln in f if ln.strip()), "")
        tokens[i] = vocab.encode(_normalize_caption(first), max_len)
    return {"image": images, "text": tokens}
