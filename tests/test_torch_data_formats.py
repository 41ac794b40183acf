"""The port's data layer against the JAX package's, on mounted data.

``mmvae_torch.data.load_dataset`` must give the arrays JAX's
``load_dataset(..., device_put=False)`` gives, to the bit, for each thing
``$MMVAE_DATA_DIR`` may hold: a ``<split>.npz``, the MNIST IDX pairs
(plain and gzipped), the MultiMNIST composite of real digits (from
``multimnist/`` and from the sibling ``mnist/``), raw CelebA (its 18
attributes picked by name, the holdout, ``n``) and raw CUB (the first
caption, ``<unk>``, ``max_len``). Beside them: the corpus vocabulary
(``cub_data_vocab``: built, persisted, read back, and on a mount that
cannot be written), the CUB config's vocabulary size following the mount,
the port's C++ generators against ``mmvae_tpu.data.native``, and a CUB
model sized by a mounted corpus against JAX's on converted weights (rtol
2e-4: XLA-CPU's transcendentals are approximate). The tests write their
fixtures themselves (PIL writes the images; nothing is downloaded).
"""

import gzip
import json
import os
import shutil
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmvae_torch import configs
from mmvae_torch.convert import from_flax_params
from mmvae_torch.data import cub_data_vocab, load_dataset
from mmvae_torch.data import native as t_native
from mmvae_torch.data.synthetic import CELEBA_ATTRS
from mmvae_tpu import configs as j_configs
from mmvae_tpu.data import load_dataset as j_load_dataset
from mmvae_tpu.data import native as j_native
from mmvae_tpu.data.formats import cub_data_vocab as j_cub_data_vocab
from torch_threads import _one_torch_thread  # noqa: F401

Image = pytest.importorskip("PIL.Image")
RTOL = 2e-4


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _same(got, want) -> None:
    """Port ``Dataset`` against JAX ``Dataset``: the same keys, shapes,
    dtypes and bits."""
    assert got.size == want.size
    assert set(got.arrays) == set(want.arrays)
    for k, v in want.arrays.items():
        v = np.asarray(v)
        assert got.arrays[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got.arrays[k], v, err_msg=k)


def _both(monkeypatch, root, name, split, **kw):
    monkeypatch.setenv("MMVAE_DATA_DIR", str(root))
    got = load_dataset(name, split, **kw)
    want = j_load_dataset(name, split, device_put=False, **kw)
    _same(got, want)
    return got


def _idx_bytes(arr: np.ndarray) -> bytes:
    return struct.pack(">HBB", 0, 0x08, arr.ndim) + struct.pack(
        f">{arr.ndim}I", *arr.shape) + arr.astype(np.uint8).tobytes()


def _write_idx_pair(d, split, n, seed, gz=False, labels=None):
    rng = np.random.default_rng(seed)
    stems = {"train": ("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
             "test": ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte")}[split]
    images = rng.integers(0, 256, (n, 28, 28)).astype(np.uint8)
    labels = rng.integers(0, 10, n).astype(np.uint8) if labels is None else labels
    for stem, arr in zip(stems, (images, labels)):
        data = _idx_bytes(arr)
        if gz:
            with gzip.open(d / (stem + ".gz"), "wb") as f:
                f.write(data)
        else:
            (d / stem).write_bytes(data)
    return images, labels


def test_mounted_npz(tmp_path, monkeypatch):
    d = tmp_path / "mnist"
    d.mkdir()
    rng = np.random.default_rng(0)
    np.savez(d / "train.npz", image=rng.random((9, 28, 28), dtype=np.float32),
             label=rng.integers(0, 10, 9).astype(np.int32))
    _both(monkeypatch, tmp_path, "mnist", "train")
    got = _both(monkeypatch, tmp_path, "mnist", "train", n=4)
    assert got.size == 4


@pytest.mark.parametrize("name", ["mnist", "fashionmnist"])
def test_idx_plain_and_gzipped(tmp_path, monkeypatch, name):
    """Train as plain IDX files, test gzipped: images / 255 in f32, labels
    int32."""
    d = tmp_path / name
    d.mkdir()
    images, labels = _write_idx_pair(d, "train", 11, 0)
    _write_idx_pair(d, "test", 5, 1, gz=True)
    got = _both(monkeypatch, tmp_path, name, "train")
    np.testing.assert_array_equal(got.arrays["image"], images.astype(np.float32) / 255.0)
    np.testing.assert_array_equal(got.arrays["label"], labels.astype(np.int32))
    _both(monkeypatch, tmp_path, name, "test")
    _both(monkeypatch, tmp_path, name, "test", n=3)


@pytest.mark.parametrize("where", ["multimnist", "mnist"])
def test_multimnist_composite(tmp_path, monkeypatch, where):
    """Composited from the IDX digits under ``multimnist/``, or under the
    sibling ``mnist/`` when ``multimnist/`` holds none; with the
    generator's ``hw`` and ``max_digits``."""
    d = tmp_path / where
    d.mkdir()
    (tmp_path / "multimnist").mkdir(exist_ok=True)
    _write_idx_pair(d, "train", 20, 2, labels=(np.arange(20) % 10).astype(np.uint8))
    _write_idx_pair(d, "test", 8, 3, gz=True)
    got = _both(monkeypatch, tmp_path, "multimnist", "train", n=16)
    assert got.arrays["image"].shape == (16, 50, 50) and got.arrays["text"].shape == (16, 5)
    _both(monkeypatch, tmp_path, "multimnist", "test")
    got = _both(monkeypatch, tmp_path, "multimnist", "train", n=6,
                gen_kwargs={"hw": 40, "max_digits": 3})
    assert got.arrays["image"].shape == (6, 40, 40) and got.arrays["text"].shape == (6, 4)


def _write_celeba(d, n, seed=1, header_count=True):
    (d / "img_align_celeba").mkdir(parents=True)
    rng = np.random.default_rng(seed)
    names = [f"attr{i}" for i in range(40 - 18)] + list(CELEBA_ATTRS)
    rng.shuffle(names)
    lines = ([str(n)] if header_count else []) + [" ".join(names)]
    for i in range(n):
        fname = f"{i:06d}.jpg"
        h, w = (78, 64) if i % 2 else (64, 90)
        Image.fromarray((rng.random((h, w, 3)) * 255).astype(np.uint8)).save(
            d / "img_align_celeba" / fname)
        lines.append(fname + " " + " ".join(rng.choice(["-1", "1"], size=40)))
    (d / "list_attr_celeba.txt").write_text("\n".join(lines) + "\n")


@pytest.mark.parametrize("header_count", [True, False])
def test_celeba_raw(tmp_path, monkeypatch, header_count):
    """The 18 attributes by name out of 40 shuffled columns, the holdout
    (a fifth of a small mount), ``n`` before decoding, crops of both
    orientations."""
    _write_celeba(tmp_path / "celeba", 7, header_count=header_count)
    got = _both(monkeypatch, tmp_path, "celeba", "train")
    assert got.arrays["image"].shape == (6, 64, 64, 3) and got.arrays["attrs"].shape == (6, 18)
    assert _both(monkeypatch, tmp_path, "celeba", "test").size == 1
    assert _both(monkeypatch, tmp_path, "celeba", "train", n=2).size == 2


# Captions: the first line of each file is the one encoded; the last is
# longer than max_len (32) words.
_CAPTIONS = [
    "A small bird, with blue wings!",
    "this bird has a red-crown and white/grey belly",
    "a large gray bird with a long beak",
    " ".join(["this very long caption keeps going"] * 8),
]


def _write_cub(d, seed=2, classes=("001.Black_footed_Albatross", "002.Laysan_Albatross")):
    rng = np.random.default_rng(seed)
    for ci, cls in enumerate(classes):
        (d / "images" / cls).mkdir(parents=True)
        (d / "text_c10" / cls).mkdir(parents=True)
        for j in range(3):
            name = f"img_{j:02d}"
            img = (rng.random((70, 60, 3)) * 255).astype(np.uint8)
            Image.fromarray(img).save(d / "images" / cls / f"{name}.jpg")
            first = _CAPTIONS[(ci * 3 + j) % len(_CAPTIONS)]
            (d / "text_c10" / cls / f"{name}.txt").write_text(
                "\n" + first + "\n" + _CAPTIONS[(j + 1) % 3] + "\n")


def test_cub_raw(tmp_path, monkeypatch):
    """Images and the first caption of each pair over the corpus
    vocabulary; a caption past ``max_len`` cut to it (STOP last)."""
    _write_cub(tmp_path / "cub")
    got = _both(monkeypatch, tmp_path, "cub", "train")
    assert got.arrays["image"].shape == (5, 64, 64, 3) and got.arrays["text"].shape == (5, 32)
    assert (got.arrays["text"][:, -1] != 0).any()  # the long caption fills every position
    assert _both(monkeypatch, tmp_path, "cub", "test").size == 1
    assert (tmp_path / "cub" / "vocab.json").exists()


def test_cub_raw_unknown_words(tmp_path, monkeypatch):
    """A persisted ``vocab.json`` without some of the corpus's words: they
    encode as ``<unk>``."""
    d = tmp_path / "cub"
    _write_cub(d)
    itos = ["<pad>", "<start>", "<stop>", "<unk>", "a", "bird", "with", "wings"]
    (d / "vocab.json").write_text(json.dumps({"itos": itos}))
    got = _both(monkeypatch, tmp_path, "cub", "train")
    assert (got.arrays["text"] == 3).any()


def test_cub_vocab_built_persisted_and_read_back(tmp_path):
    """The vocabulary scanned from a corpus equals JAX's (the most frequent
    words, ties in order of first appearance), at the default 2,000 words
    and cut to 5; the ``vocab.json`` each writes is the same file; a
    persisted file is read as it is."""
    a, b = tmp_path / "a", tmp_path / "b"
    _write_cub(a)
    shutil.copytree(a, b)
    got, want = cub_data_vocab(str(a)), j_cub_data_vocab(str(b))
    assert got.itos == want.itos and len(got) == len(want)
    assert (a / "vocab.json").read_text() == (b / "vocab.json").read_text()
    c, e = tmp_path / "c", tmp_path / "e"
    shutil.copytree(a, c)
    shutil.copytree(a, e)
    for d in (c, e):
        os.unlink(d / "vocab.json")
    assert cub_data_vocab(str(c), max_words=5).itos == j_cub_data_vocab(str(e), max_words=5).itos
    f = tmp_path / "f"
    f.mkdir()
    (f / "vocab.json").write_text(json.dumps({"itos": ["<pad>", "<start>", "<stop>", "<unk>",
                                                       "x", "y"]}))
    assert cub_data_vocab(str(f)).itos == j_cub_data_vocab(str(f)).itos
    assert cub_data_vocab(str(tmp_path / "none")) is None


def test_cub_vocab_on_a_mount_that_cannot_be_written(tmp_path, monkeypatch):
    """Where ``vocab.json`` cannot be put in place, the vocabulary is still
    built (the same as JAX's), no file is left behind, not even the
    temporary one."""
    a, b = tmp_path / "a", tmp_path / "b"
    _write_cub(a)
    shutil.copytree(a, b)

    def refuse(*args, **kwargs):
        raise OSError("read-only file system")

    monkeypatch.setattr(os, "replace", refuse)
    got, want = cub_data_vocab(str(a)), j_cub_data_vocab(str(b))
    assert got.itos == want.itos
    assert sorted(p.name for p in a.iterdir()) == ["images", "text_c10"]


def test_cub_vocab_size_follows_the_mount(tmp_path, monkeypatch):
    """The CUB model's vocabulary: the synthetic one's 23 with no mount or
    an empty ``cub/``, the corpus's with one, as in the JAX configs; the
    model built on it has that many text outputs."""
    monkeypatch.setenv("MMVAE_DATA_DIR", str(tmp_path))
    assert configs.cub_vocab_size() == j_configs._cub_vocab_size() == 23
    (tmp_path / "cub").mkdir()
    assert configs.cub_vocab_size() == j_configs._cub_vocab_size() == 23
    _write_cub(tmp_path / "cub")
    v = configs.cub_vocab_size()
    assert v == j_configs._cub_vocab_size() == len(configs.cub_text_vocab()) > 23
    cfg = configs.get_config("cub").replace(
        n_latents=8, model_kwargs=dict(conv_features=(8, 8), image_hw=(16, 16)))
    assert configs.build_model(cfg, device="cpu").vocab_size == v


@pytest.mark.parametrize("seed", [0, 5])
def test_native_generators_equal_the_jax_library(seed):
    """The port's build of ``native/datagen.cpp`` (under
    ``mmvae_torch/_build/``) gives the JAX library's arrays to the bit, and
    the same arrays twice."""
    for make_t, make_j, kw in ((t_native.make_celeba_native, j_native.make_celeba_native, {}),
                               (t_native.make_multimnist_native, j_native.make_multimnist_native,
                                {"max_digits": 3})):
        got, want = make_t(6, seed=seed, **kw), make_j(6, seed=seed, **kw)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
            np.testing.assert_array_equal(make_t(6, seed=seed, **kw)[k], got[k])
    assert t_native.build().parent.name == "_build"
    with pytest.raises(ValueError, match="max_digits"):
        t_native.make_multimnist_native(2, max_digits=9)


def test_native_library_without_openmp_makes_the_same_data(tmp_path, monkeypatch):
    """A compiler with no OpenMP runtime (one that refuses ``-fopenmp``, as a
    toolchain without libgomp does): the library is built without it, with
    a warning, and makes the same data, since each example seeds its own
    RNG."""
    cxx = tmp_path / "cxx"
    cxx.write_text('#!/bin/sh\nfor a in "$@"; do [ "$a" = -fopenmp ] && '
                   '{ echo "cannot read spec file libgomp.spec" >&2; exit 1; }; done\n'
                   'exec g++ "$@"\n')
    cxx.chmod(0o755)
    want = {**t_native.make_celeba_native(5, seed=2),
            **{f"mm_{k}": v for k, v in t_native.make_multimnist_native(5, seed=2).items()}}
    monkeypatch.setenv("CXX", str(cxx))
    monkeypatch.setattr(t_native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(t_native, "_lib", None)
    with pytest.warns(UserWarning, match="no OpenMP runtime"):
        so = t_native.build()
    assert so.parent == tmp_path / "build"
    got = {**t_native.make_celeba_native(5, seed=2),
           **{f"mm_{k}": v for k, v in t_native.make_multimnist_native(5, seed=2).items()}}
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_cub_model_on_a_mounted_corpus_matches_jax(tmp_path, monkeypatch):
    """A CUB corpus of 8 image-caption pairs over 60 words: both packages
    size the caption experts from its vocabulary, the mounted split loads
    alike, and on converted weights the port's encode (every expert) and
    decode (the image and the 32 x V caption logits, teacher-forced) of the
    split match JAX's."""
    from PIL import Image

    rng = np.random.default_rng(9)
    words = [f"w{i}" for i in range(60)]
    d = tmp_path / "cub"
    for cls in ("001.a", "002.b"):
        (d / "images" / cls).mkdir(parents=True)
        (d / "text_c10" / cls).mkdir(parents=True)
        for j in range(4):
            Image.fromarray((rng.random((40, 50, 3)) * 255).astype(np.uint8)).save(
                d / "images" / cls / f"{j}.jpg")
            caption = " ".join(rng.choice(words, size=rng.integers(4, 12)))
            (d / "text_c10" / cls / f"{j}.txt").write_text(caption + "\n")
    monkeypatch.setenv("MMVAE_DATA_DIR", str(tmp_path))
    small = dict(image_hw=(64, 64), conv_features=(8, 16))
    cfg = configs.get_config("cub").replace(n_latents=8, model_kwargs=small)
    jcfg = j_configs.get_config("cub").replace(n_latents=8, model_kwargs=small)
    tmodel, jmodel = configs.build_model(cfg, device="cpu"), j_configs.build_model(jcfg)
    v = configs.cub_vocab_size()
    assert tmodel.vocab_size == jmodel.vocab_size == v and 30 < v <= 64
    data = load_dataset("cub", "train").arrays
    batch = {kk: jnp.asarray(a) for kk, a in data.items()}
    params = _np_tree(jmodel.init(jax.random.key(0), batch, rng=jax.random.key(1))["params"])
    tmodel.load_state_dict(from_flax_params(params))

    @jax.jit
    def forward(p, b):
        mu, lv = jmodel.apply({"params": p}, b, method="encode")
        return mu, lv, jmodel.apply({"params": p}, mu[:, 1], b, method="decode")

    j_mu, j_lv, j_recon = forward(params, batch)
    with torch.no_grad():
        tb = {kk: torch.from_numpy(np.array(a)) for kk, a in data.items()}
        mu, lv = tmodel.encode(tb)
        recon = tmodel.decode(mu[:, 1], tb)
    assert recon["text"].shape[-1] == v
    for got, want in ((mu, j_mu), (lv, j_lv), *((recon[kk], j_recon[kk]) for kk in recon)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=2e-4 * np.abs(np.asarray(want)).max())
