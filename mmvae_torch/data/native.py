"""The C++ data generators by ``ctypes`` (port of ``mmvae_tpu/data/native.py``).

``native/datagen.cpp`` holds the two loop-heavy generators, the CelebA
rasterizer and the MultiMNIST compositor, run with OpenMP over examples.
Each is deterministic for a (seed, n) with an RNG of its own: the numpy
generators' distribution and visual semantics, not their bits.
``MMVAE_DATAGEN=native`` makes ``load_dataset`` take them for ``celeba``
and ``multimnist``.

At first use the source is compiled with the flags of ``native/Makefile``
(``g++ -O3 -fPIC -shared -fopenmp -std=c++17``) into
``mmvae_torch/_build/``, named by the hash of the source and the flags;
nothing under ``native/`` is written. Where the compiler has no OpenMP
runtime the library is built without ``-fopenmp``, with a warning: each
example seeds its own RNG from (seed, index), so it makes the same data on
one core. A library that cannot be built at all raises: the numpy
generators give other data, so nothing falls back to them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import warnings
from pathlib import Path

import numpy as np

__all__ = ["SOURCE", "CXX_FLAGS", "build", "make_celeba_native", "make_multimnist_native"]

SOURCE = Path(__file__).resolve().parents[2] / "native" / "datagen.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-fopenmp", "-std=c++17", "-Wall")
# The flags tried in turn: the Makefile's, then the same without OpenMP.
_FLAG_SETS = (CXX_FLAGS, tuple(f for f in CXX_FLAGS if f != "-fopenmp"))
_lock = threading.Lock()
_lib = None


def _target(flags: tuple[str, ...]) -> Path:
    key = SOURCE.read_bytes() + " ".join(flags).encode()
    return BUILD_DIR / f"libmmvae_datagen_{hashlib.sha256(key).hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``native/datagen.cpp`` unless it is built; returns the
    library. The compiler is ``$CXX`` (``g++`` by default), with the
    Makefile's flags, else (no OpenMP runtime) without ``-fopenmp``, with a
    warning. It writes a temporary file renamed into place, so concurrent
    builds never load a partial library. A library that builds with neither
    raises ``RuntimeError``."""
    with _lock:
        for flags in _FLAG_SETS:
            if _target(flags).exists():
                return _target(flags)
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cxx = os.environ.get("CXX", "g++")
        errors = []
        for flags in _FLAG_SETS:
            so = _target(flags)
            tmp = BUILD_DIR / f"{so.stem}.{os.getpid()}.tmp"
            try:
                proc = subprocess.run([cxx, *flags, "-o", str(tmp), str(SOURCE)],
                                      capture_output=True, text=True)
            except FileNotFoundError as e:
                raise RuntimeError(f"cannot build the native data generators: no {cxx!r}") from e
            if proc.returncode == 0:
                os.replace(tmp, so)
                if flags != CXX_FLAGS:
                    warnings.warn(f"{cxx} has no OpenMP runtime: the native data generators are "
                                  f"built without -fopenmp (the same data, on one core)\n"
                                  f"{errors[0]}", stacklevel=2)
                return so
            errors.append(f"{cxx} {' '.join(flags)} failed with code {proc.returncode}:\n"
                          f"{proc.stderr[-2000:]}")
        raise RuntimeError("cannot build the native data generators:\n" + "\n".join(errors))


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.mmvae_make_celeba.argtypes = [
            ctypes.c_uint64, ctypes.c_int64, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ]
        lib.mmvae_make_multimnist.argtypes = [
            ctypes.c_uint64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
        ]
        _lib = lib
    return _lib


def _ptr(a: np.ndarray, kind):
    return a.ctypes.data_as(ctypes.POINTER(kind))


def make_celeba_native(n: int, seed: int = 0, hw: int = 64) -> dict[str, np.ndarray]:
    """``n`` CelebA-style faces: image ``(n, hw, hw, 3)`` f32 in [0, 1],
    attrs ``(n, 18)`` f32 in {0, 1}."""
    lib = _load()
    images = np.empty((n, hw, hw, 3), np.float32)
    attrs = np.empty((n, 18), np.float32)
    # seed + 1: the C++ RNG's stream is all zeros from a zero state.
    lib.mmvae_make_celeba(ctypes.c_uint64(seed + 1), ctypes.c_int64(n), ctypes.c_int(hw),
                          _ptr(images, ctypes.c_float), _ptr(attrs, ctypes.c_float))
    return {"image": images, "attrs": attrs}


def make_multimnist_native(
    n: int, seed: int = 0, hw: int = 50, max_digits: int = 4
) -> dict[str, np.ndarray]:
    """``n`` MultiMNIST canvases: image ``(n, hw, hw)`` f32, text ``(n,
    max_digits + 1)`` i32 (digit d is token 3 + d, then STOP, then PAD)."""
    if not 1 <= max_digits <= 8:
        # The C++ side composites into 8 position slots and returns early,
        # its output unwritten, for any other count.
        raise ValueError(f"max_digits must be in [1, 8], got {max_digits}")
    lib = _load()
    images = np.empty((n, hw, hw), np.float32)
    tokens = np.empty((n, max_digits + 1), np.int32)
    lib.mmvae_make_multimnist(ctypes.c_uint64(seed + 1), ctypes.c_int64(n), ctypes.c_int(hw),
                              ctypes.c_int(max_digits), _ptr(images, ctypes.c_float),
                              _ptr(tokens, ctypes.c_int32))
    return {"image": images, "text": tokens}
