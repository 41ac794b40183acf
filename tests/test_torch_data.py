"""The port's ``load_dataset`` against the JAX loader's choice of source.

Both read a mounted ``$MMVAE_DATA_DIR/<name>/<split>.npz`` first, then the
distribution formats of a mounted ``$MMVAE_DATA_DIR/<name>/`` directory,
then the seeded generators (the C++ ones under ``MMVAE_DATAGEN=native``
for ``multimnist`` and ``celeba``), and give the same arrays. The formats
themselves are ``tests/test_torch_data_formats.py``'s.
"""

import numpy as np
import pytest

from mmvae_torch.data import load_dataset
from mmvae_tpu.data import load_dataset as j_load_dataset


def _mount_mnist(root, n=5):
    d = root / "mnist"
    d.mkdir()
    rng = np.random.default_rng(0)
    np.savez(d / "test.npz", image=rng.random((n, 28, 28, 1), dtype=np.float32),
             label=rng.integers(0, 10, n).astype(np.int32))
    return d


def _same(got, want) -> None:
    assert got.size == want.size and set(got.arrays) == set(want.arrays)
    for k, v in want.arrays.items():
        np.testing.assert_array_equal(got.arrays[k], np.asarray(v))


def test_mounted_npz_raises_where_the_jax_loader_reads_it(tmp_path, monkeypatch):
    """A mounted ``test.npz`` is what both loaders read, as it is (its own
    dtypes and its 4-D image), and ``n`` cuts it."""
    _mount_mnist(tmp_path)
    monkeypatch.setenv("MMVAE_DATA_DIR", str(tmp_path))
    got = load_dataset("mnist", "test")
    assert got.size == 5 and got.arrays["image"].shape == (5, 28, 28, 1)
    _same(got, j_load_dataset("mnist", "test", device_put=False))
    _same(load_dataset("mnist", "test", n=3), j_load_dataset("mnist", "test", n=3,
                                                             device_put=False))


@pytest.mark.parametrize("name", ["mnist", "multimnist", "celeba"])
def test_mounted_directory_raises(tmp_path, monkeypatch, name):
    """A directory for the dataset, with no ``<split>.npz`` and none of its
    distribution files: both loaders find no format there and generate,
    and give the same arrays."""
    (tmp_path / name).mkdir()
    monkeypatch.setenv("MMVAE_DATA_DIR", str(tmp_path))
    got = load_dataset(name, "test", n=4)
    _same(got, j_load_dataset(name, "test", n=4, device_put=False))
    monkeypatch.setenv("MMVAE_DATA_DIR", "")
    _same(got, load_dataset(name, "test", n=4))


def test_other_split_of_a_mounted_dataset_raises(tmp_path, monkeypatch):
    """Only ``test.npz`` is mounted: for ``train`` both loaders turn to the
    formats in the same directory, find no IDX pair and generate."""
    _mount_mnist(tmp_path)
    monkeypatch.setenv("MMVAE_DATA_DIR", str(tmp_path))
    got = load_dataset("mnist", "train", n=4)
    _same(got, j_load_dataset("mnist", "train", n=4, device_put=False))
    assert got.arrays["image"].shape == (4, 28, 28)


@pytest.mark.parametrize("name", ["mnist", "multimnist", "celeba"])
def test_data_dir_without_the_dataset_generates(tmp_path, monkeypatch, name):
    """A data dir that holds nothing for the dataset, or an empty
    variable: both loaders generate, and give the same arrays."""
    want = load_dataset(name, "test", n=6)
    for value in (str(tmp_path), ""):
        monkeypatch.setenv("MMVAE_DATA_DIR", value)
        got = load_dataset(name, "test", n=6)
        jax_got = j_load_dataset(name, "test", n=6, device_put=False)
        for k, v in want.arrays.items():
            np.testing.assert_array_equal(got.arrays[k], v)
            np.testing.assert_array_equal(np.asarray(jax_got.arrays[k]), v)


@pytest.mark.parametrize("name", ["multimnist", "celeba"])
def test_native_generator_raises(monkeypatch, name):
    """Under ``MMVAE_DATAGEN=native`` both loaders run the C++ generator of
    ``name`` (the port its own build of it) and give the same arrays, which
    are not the numpy generator's."""
    numpy_data = load_dataset(name, "test", n=4)
    monkeypatch.setenv("MMVAE_DATAGEN", "native")
    got = load_dataset(name, "test", n=4)
    _same(got, j_load_dataset(name, "test", n=4, device_put=False))
    assert not np.array_equal(got.arrays["image"], numpy_data.arrays["image"])


def test_native_generator_leaves_mnist_on_numpy(monkeypatch):
    """The JAX loader has no native MNIST generator: under
    ``MMVAE_DATAGEN=native`` both loaders still run numpy."""
    want = load_dataset("mnist", "test", n=6)
    monkeypatch.setenv("MMVAE_DATAGEN", "native")
    got = load_dataset("mnist", "test", n=6)
    jax_got = j_load_dataset("mnist", "test", n=6, device_put=False)
    for k, v in want.arrays.items():
        np.testing.assert_array_equal(got.arrays[k], v)
        np.testing.assert_array_equal(np.asarray(jax_got.arrays[k]), v)
