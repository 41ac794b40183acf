"""The port's ``load_dataset`` against the JAX loader's choice of source.

The port runs only the seeded numpy generators. Wherever the JAX loader
(``mmvae_tpu/data/pipelines.py::load_dataset``) would read something else
-- a mounted ``$MMVAE_DATA_DIR/<name>/<split>.npz``, a mounted
``$MMVAE_DATA_DIR/<name>/`` in the distribution formats, or the C++
generators under ``MMVAE_DATAGEN=native`` -- the port raises rather than
return other data.
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


def test_mounted_npz_raises_where_the_jax_loader_reads_it(tmp_path, monkeypatch):
    _mount_mnist(tmp_path)
    monkeypatch.setenv("MMVAE_DATA_DIR", str(tmp_path))
    assert j_load_dataset("mnist", "test", device_put=False).size == 5
    with pytest.raises(NotImplementedError, match="MMVAE_DATA_DIR"):
        load_dataset("mnist", "test")


@pytest.mark.parametrize("name", ["mnist", "multimnist", "celeba"])
def test_mounted_directory_raises(tmp_path, monkeypatch, name):
    """A directory for the dataset, with no ``<split>.npz``: the JAX loader
    reads the distribution formats from it."""
    (tmp_path / name).mkdir()
    monkeypatch.setenv("MMVAE_DATA_DIR", str(tmp_path))
    with pytest.raises(NotImplementedError, match="not yet ported"):
        load_dataset(name, "test", n=4)


def test_other_split_of_a_mounted_dataset_raises(tmp_path, monkeypatch):
    """Only ``test.npz`` is mounted: for ``train`` the JAX loader turns to
    the formats in the same directory, so the port raises too."""
    _mount_mnist(tmp_path)
    monkeypatch.setenv("MMVAE_DATA_DIR", str(tmp_path))
    with pytest.raises(NotImplementedError, match="MMVAE_DATA_DIR"):
        load_dataset("mnist", "train", n=4)


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
    monkeypatch.setenv("MMVAE_DATAGEN", "native")
    with pytest.raises(NotImplementedError, match="MMVAE_DATAGEN=native"):
        load_dataset(name, "test", n=4)


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
