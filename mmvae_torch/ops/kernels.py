"""Hand-written CUDA kernels for the two ELBO row reductions, with plain versions.

Both ops are row-wise reductions ``(N, D) -> (N,)`` over f32 rows:

  * ``kl_std_normal_kernel`` replaces ``mmvae_tpu/ops/kernels.py::
    kl_std_normal_pallas`` (K1): ``-0.5 * sum(1 + lv - mu^2 - e^lv)``;
  * ``bernoulli_nll_kernel`` replaces ``mmvae_tpu/ops/kernels.py::
    bernoulli_nll_pallas`` (K2): ``sum(max(l,0) - l*x + log1p(e^-|l|))``,
    reading its targets through a row map (``FOLD_*``) so term-tiled
    logits are scored against one untiled copy of the targets.

The kernels live in ``csrc/row_reduce.cu`` behind a plain C interface.
:func:`build` compiles it with ``nvcc`` for ``sm_90a`` into
``mmvae_torch/_build/`` at first use (again whenever the source's hash
changes) and the library is loaded with ``ctypes``. Each wrapper checks
its inputs, allocates the output, launches on PyTorch's current stream,
raises on a failed launch and adds one to ``LAUNCHES``. A wrapper never
falls back: on anything but f32 CUDA rows it raises. The plain versions
(``*_torch``) compute the same function with PyTorch ops; the CPU path
and the on-card checks use them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from mmvae_torch.core.elbo import kl_std_normal as _kl_plain
from mmvae_torch.core.likelihoods import bernoulli_nll as _bce_plain

__all__ = [
    "FOLD_NONE",
    "FOLD_T",
    "FOLD_B",
    "LAUNCHES",
    "build",
    "tile_rows",
    "kl_std_normal_kernel",
    "kl_std_normal_torch",
    "bernoulli_nll_kernel",
    "bernoulli_nll_torch",
]

# Target-row maps of the BCE kernel: rows match; t-major tiling (row
# t * n_x + b reads target b); b-major tiling (row b * k + t reads b).
FOLD_NONE, FOLD_T, FOLD_B = 0, 1, 2

# Kernel launches per wrapper, counted where each launch is made.
LAUNCHES = {"kl": 0, "bce": 0}

SOURCE = Path(__file__).resolve().parent / "csrc" / "row_reduce.cu"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(cuda_home, "bin", "nvcc")


def build() -> Path:
    """Compile ``csrc/row_reduce.cu`` unless this source is already built.

    The library is named by the hash of the source and the flags, so an
    edited source is rebuilt. ``nvcc``'s output (``-Xptxas -v``: registers
    and spills per kernel) is kept beside it with the suffix ``.log``.
    Returns the path of the shared library.
    """
    key = SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()
    so = BUILD_DIR / f"row_reduce_{hashlib.sha256(key).hexdigest()[:16]}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{so.stem}.{os.getpid()}.tmp"
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with code {proc.returncode}:\n{proc.stderr}"
        )
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, so)
    return so


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.kl_rows.argtypes = [ptr, ptr, ptr, i32, i32, ptr]
        lib.kl_rows.restype = i32
        lib.bce_rows.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32, ptr]
        lib.bce_rows.restype = i32
        lib.row_reduce_error_string.argtypes = [i32]
        lib.row_reduce_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check_rows(name: str, t: torch.Tensor) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if t.dim() != 2:
        raise ValueError(f"{name} must be 2-D rows, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if max(t.shape) >= 2**31:
        raise ValueError(f"{name} shape {tuple(t.shape)} exceeds int32")


def _launch(fn_name: str, device: torch.device, *args) -> None:
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, fn_name)(*args, stream)
    if rc != 0:
        msg = lib.row_reduce_error_string(rc).decode()
        raise RuntimeError(f"{fn_name} launch failed: {msg} (code {rc})")


def tile_rows(x: torch.Tensor, n: int, fold: int) -> torch.Tensor:
    """``x`` tiled along dim 0 to ``n`` rows in the order ``fold`` names."""
    if fold == FOLD_NONE:
        if x.shape[0] != n:
            raise ValueError(f"rows differ ({x.shape[0]} vs {n}) with no fold")
        return x
    if x.shape[0] == 0 or n % x.shape[0]:
        raise ValueError(f"{n} rows are not a tiling of {x.shape[0]}")
    k = n // x.shape[0]
    if fold == FOLD_T:
        return x.repeat((k,) + (1,) * (x.dim() - 1))
    if fold == FOLD_B:
        return x.repeat_interleave(k, dim=0)
    raise ValueError(f"unknown fold {fold!r}")


# ---------------------------------------------------------------- KL ----


def kl_std_normal_kernel(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """KL(N(mu, e^logvar) || N(0, I)) of each row of ``(N, D)`` f32 CUDA rows."""
    _check_rows("mu", mu)
    _check_rows("logvar", logvar)
    if logvar.shape != mu.shape or logvar.device != mu.device:
        raise ValueError(
            f"mu {tuple(mu.shape)} on {mu.device} and logvar "
            f"{tuple(logvar.shape)} on {logvar.device} differ"
        )
    n, d = mu.shape
    out = torch.empty(n, dtype=torch.float32, device=mu.device)
    if n == 0:
        return out
    _launch(
        "kl_rows", mu.device, mu.data_ptr(), logvar.data_ptr(),
        out.data_ptr(), n, d,
    )
    LAUNCHES["kl"] += 1
    return out


def kl_std_normal_torch(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`kl_std_normal_kernel`."""
    return _kl_plain(mu, logvar)


# --------------------------------------------------------------- BCE ----


def bernoulli_nll_kernel(
    logits: torch.Tensor, x: torch.Tensor, fold: int = FOLD_NONE
) -> torch.Tensor:
    """Summed BCE-with-logits of each row of ``(N, D)`` f32 CUDA logits.

    ``x`` holds ``(n_x, D)`` targets: ``n_x == N`` with ``FOLD_NONE``, or
    one copy of a term tiling of ``N // n_x`` terms in the order ``fold``
    names -- the tiled copy is never made.
    """
    _check_rows("logits", logits)
    _check_rows("x", x)
    if x.shape[1] != logits.shape[1] or x.device != logits.device:
        raise ValueError(
            f"logits {tuple(logits.shape)} on {logits.device} and x "
            f"{tuple(x.shape)} on {x.device} do not match"
        )
    n, d = logits.shape
    n_x = x.shape[0]
    if fold not in (FOLD_NONE, FOLD_T, FOLD_B):
        raise ValueError(f"unknown fold {fold!r}")
    if (fold == FOLD_NONE and n_x != n) or (
        fold != FOLD_NONE and (n_x == 0 or n % n_x)
    ):
        raise ValueError(f"{n} logits rows do not fold onto {n_x} target rows")
    out = torch.empty(n, dtype=torch.float32, device=logits.device)
    if n == 0:
        return out
    _launch(
        "bce_rows", logits.device, logits.data_ptr(), x.data_ptr(),
        out.data_ptr(), n, d, n_x, fold,
    )
    LAUNCHES["bce"] += 1
    return out


def bernoulli_nll_torch(
    logits: torch.Tensor, x: torch.Tensor, fold: int = FOLD_NONE
) -> torch.Tensor:
    """Plain PyTorch version of :func:`bernoulli_nll_kernel` (tiles ``x``)."""
    return _bce_plain(logits, tile_rows(x, logits.shape[0], fold), 1)
