"""Hand-written CUDA kernels for the ELBO's reductions, with plain versions.

  * ``kl_std_normal_kernel`` replaces ``mmvae_tpu/ops/kernels.py::
    kl_std_normal_pallas`` (K1): ``-0.5 * sum(1 + lv - mu^2 - e^lv)``
    per row of ``(N, D)``;
  * ``bernoulli_nll_kernel`` replaces ``mmvae_tpu/ops/kernels.py::
    bernoulli_nll_pallas`` (K2): ``sum(max(l,0) - l*x + log1p(e^-|l|))``
    per row, reading its targets through a row map (``FOLD_*``; b-major
    also over examples of several rows, the CelebA attributes' IWAE fold)
    so term-tiled logits are scored against one untiled copy of the
    targets (f32, or bf16 upcast on load), in the layout :func:`bce_plan`
    picks from the shape;
  * ``masked_seq_ce_kernel`` replaces ``mmvae_tpu/ops/kernels.py::
    masked_seq_ce_pallas`` (K3): per example of ``(N, S, V)`` logits, the
    token cross-entropy ``logsumexp(l) - l[token]`` summed over its
    non-pad tokens, in the layout :func:`seq_ce_plan` picks;
  * ``conv4x4s2_swish_kernel`` replaces ``tools/pallas_conv_probe.py::
    pallas_conv0`` (K4): ``swish(conv(x, w, SAME, stride 2) + b)`` of an
    NHWC image with 1-4 channels into F = 32 NCHW channels (or a rank's 16
    or 8 under tensor parallelism, each F a library of its own), a warp per
    32-pixel chunk of an output row, in the grid :func:`conv_plan` sizes
    (f32, bf16, or a bf16 image into f32 weights);
    ``conv4x4s2_swish_grad_kernel`` is its backward in the weight and the
    bias (XLA's gradient of stage 0 on the TPU side, which has no Pallas
    VJP; the image f32 or bf16), in the grid :func:`conv_bwd_plan` sizes, and
    ``conv4x4s2_swish_input_grad_kernel`` its backward in the image (dx),
    both products 3xTF32 on the tensor cores, in the grid :func:`conv_dx_plan`
    sizes;
  * ``poe_kl_kernel`` is the masked product of experts of the eval with
    K1's function as its epilogue: the fused ``(T, B, L)`` posteriors of
    a ``(B, M, L)`` expert stack under ``(T, M)`` subset masks, and the KL
    of each to N(0, I), in one launch, in the grid :func:`poe_kl_plan`
    sizes. On the ported paths the KL runs here, not in K1;
  * the backward kernels of training: ``kl_rows_grad_kernel`` (K1's VJP,
    ``_kl_bwd``), ``bce_rows_grad_kernel`` (K2's VJP in the logits,
    ``_bce_bwd``, the targets read through the forward's row map),
    ``masked_seq_ce_grad_kernel`` (K3's VJP, ``_seq_ce_bwd``, in the
    layout :func:`seq_ce_grad_plan` picks) and ``poe_kl_grad_kernel``
    (the fused PoE + KL's, K1's VJP carried back through the PoE to the
    expert stack, in the tiles :func:`poe_kl_bwd_plan` sizes).

K1 and K2 and their gradients live in ``csrc/row_reduce.cu``, K3 and its
gradient in ``csrc/seq_ce.cu``, K4 in ``csrc/conv_s2.cu`` (built three
times, with ``-DCONV_F`` of 32, 16 and 8), the fused PoE and KL and its
backward in ``csrc/poe_kl.cu``, each
behind a plain C interface; ``csrc/launch_floor.cu``, an empty kernel that
times the launch floor, is built only when asked for by name
(:data:`PROBE_SOURCES`). :func:`build` compiles the sources with
``nvcc`` for ``sm_90a`` into ``mmvae_torch/_build/`` at first use (again
whenever a source's hash changes), one ``nvcc`` per source, all started
together; each library is loaded with ``ctypes``. Each wrapper checks its
inputs, allocates the output, launches on PyTorch's current stream,
raises on a failed launch and adds one to ``LAUNCHES``. A wrapper never
falls back: on anything but the CUDA tensors it takes it raises. The
plain versions (``*_torch``) compute the same functions with PyTorch
ops; the CPU path and the on-card checks use them.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
from functools import lru_cache
from pathlib import Path
from typing import NamedTuple

import torch
import torch.nn.functional as F

from mmvae_torch.core.elbo import kl_std_normal as _kl_plain
from mmvae_torch.core.likelihoods import bernoulli_nll as _bce_plain
from mmvae_torch.core.likelihoods import categorical_nll as _cat_plain
from mmvae_torch.core.poe import LOGVAR_BOUND, PRECISION_EPS, clamp_logvar
from mmvae_torch.core.poe import product_of_experts as _poe_plain

__all__ = [
    "FOLD_NONE",
    "FOLD_T",
    "FOLD_B",
    "LAUNCHES",
    "SOURCES",
    "PROBE_SOURCES",
    "build",
    "tile_rows",
    "BcePlan",
    "bce_plan",
    "BceInnerPlan",
    "bce_inner_plan",
    "bce_grad_inner_plan",
    "SeqCePlan",
    "seq_ce_plan",
    "ConvPlan",
    "conv_plan",
    "kl_std_normal_kernel",
    "kl_std_normal_torch",
    "kl_rows_grad_kernel",
    "kl_rows_grad_torch",
    "bernoulli_nll_kernel",
    "bernoulli_nll_torch",
    "BceGradPlan",
    "bce_grad_plan",
    "bce_rows_grad_kernel",
    "bce_rows_grad_torch",
    "masked_seq_ce_kernel",
    "masked_seq_ce_torch",
    "SEQ_GRAD_STAGED",
    "SEQ_GRAD_WARP",
    "SEQ_GRAD_GROUPS",
    "SeqCeGradPlan",
    "seq_ce_grad_plan",
    "masked_seq_ce_grad_kernel",
    "masked_seq_ce_grad_torch",
    "same_pad",
    "conv4x4s2_swish_kernel",
    "conv4x4s2_swish_torch",
    "ConvBwdPlan",
    "conv_bwd_plan",
    "conv4x4s2_swish_grad_kernel",
    "conv4x4s2_swish_grad_torch",
    "ConvDxPlan",
    "conv_dx_plan",
    "conv4x4s2_swish_input_grad_kernel",
    "conv4x4s2_swish_input_grad_torch",
    "PoeKlPlan",
    "poe_kl_plan",
    "poe_kl_kernel",
    "masked_poe_torch",
    "poe_kl_torch",
    "PoeKlBwdPlan",
    "poe_kl_bwd_smem",
    "poe_kl_bwd_plan",
    "poe_kl_grad_kernel",
    "poe_kl_grad_torch",
]

# Target-row maps of the BCE kernel: rows match; t-major tiling (row
# t * n_x + b reads target b); b-major tiling (row b * k + t reads b).
FOLD_NONE, FOLD_T, FOLD_B = 0, 1, 2

# Kernel launches per wrapper, counted where each launch is made.
LAUNCHES = {"kl": 0, "bce": 0, "seq_ce": 0, "conv": 0, "poe_kl": 0,
            "kl_bwd": 0, "bce_bwd": 0, "bce_bwd_inner": 0, "seq_ce_bwd": 0, "poe_kl_bwd": 0,
            "conv_bwd": 0, "conv_dx": 0}

_CSRC = Path(__file__).resolve().parent / "csrc"
# Library name -> CUDA source; each library exports ``<name>_error_string``.
SOURCES = {
    "row_reduce": _CSRC / "row_reduce.cu",
    "seq_ce": _CSRC / "seq_ce.cu",
    "conv_s2": _CSRC / "conv_s2.cu",
    # K4 at 16 and 8 output channels (a rank's stage 0 under tensor
    # parallelism): the same source, compiled with CONV_F of each.
    "conv_s2_f16": _CSRC / "conv_s2.cu",
    "conv_s2_f8": _CSRC / "conv_s2.cu",
    "poe_kl": _CSRC / "poe_kl.cu",
}
# Flags of a library beside NVCC_FLAGS (its compile-time parameters).
_DEFINES = {"conv_s2_f16": ("-DCONV_F=16",), "conv_s2_f8": ("-DCONV_F=8",)}
# Built only when named: no ported path loads them.
PROBE_SOURCES = {"launch_floor": _CSRC / "launch_floor.cu"}
_ALL_SOURCES = {**SOURCES, **PROBE_SOURCES}
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_ptr, _i32, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# Library name -> {function: argtypes}; every function returns an int
# (the launch's cudaError_t) and takes the stream last.
_SIGNATURES = {
    "row_reduce": {
        "kl_rows": [_ptr, _ptr, _ptr, _i32, _i32, _ptr],
        "bce_rows": [_ptr, _ptr, _ptr, _i32, _i32, _i32, _i32, _i32, _i32, _i32, _i32, _i32,
                     _ptr],
        "bce_rows_inner": [_ptr, _ptr, _ptr, _i32, _i32, _i32, _i32, _i32, _i32, _i32, _i32,
                           _i32, _i32, _ptr],
        "kl_rows_grad": [_ptr, _ptr, _ptr, _ptr, _ptr, _i32, _i32, _ptr],
        "bce_rows_grad": [_ptr, _ptr, _ptr, _ptr, _i32, _i32, _i32, _i32, _i32, _i32, _i32, _i32,
                          _i32, _i32, _ptr],
        "bce_rows_grad_inner": [_ptr, _ptr, _ptr, _ptr, _i32, _i32, _i32, _i32, _i32, _i32,
                                _i32, _i32, _i32, _i32, _ptr],
    },
    "seq_ce": {
        "seq_ce_rows": [_ptr, _ptr, _i32, _ptr, _i32, _i32, _i32, _i64, _i32, _i32, _i32, _ptr],
        "seq_ce_rows_grad": [_ptr, _ptr, _i32, _ptr, _ptr, _i32, _i32, _i32, _i64, _i32, _i32,
                             _i32, _i32, _i32, _ptr],
    },
    "conv_s2": {
        "conv4x4s2_swish": [_ptr, _ptr, _ptr, _ptr, _i32, _i32, _i32, _i32, _i32,
                            _i32, _i32, _i32, _ptr],
        "conv4x4s2_swish_bwd": [_ptr, _ptr, _ptr, _ptr, _i64, _i64, _i64, _i64, _ptr, _ptr,
                                _ptr, _i32, _i32, _i32, _i32, _i32, _i32, _i32, _i32, _i32,
                                _ptr],
        "conv4x4s2_swish_dx": [_ptr, _ptr, _ptr, _ptr, _i64, _i64, _i64, _i64, _ptr, _i32,
                               _i32, _i32, _i32, _i32, _i32, _i32, _i32, _i32, _ptr],
    },
    "poe_kl": {
        "poe_kl": [_ptr, _ptr, _ptr, _ptr, _ptr, _ptr, _ptr, _i32, _i32, _i32, _i32, _i32,
                   _i32, _i32, _i32, _ptr],
        "poe_kl_bwd": [_ptr, _ptr, _ptr, _ptr, _ptr, _ptr, _ptr, _ptr, _ptr, _ptr, _ptr,
                       _i32, _i32, _i32, _i32, _i32, _i32, _i32, _i32, _i32, _ptr],
    },
    "launch_floor": {"empty_launch": [_i32, _i32, _ptr]},
}
_SIGNATURES["conv_s2_f16"] = _SIGNATURES["conv_s2_f8"] = _SIGNATURES["conv_s2"]
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(cuda_home, "bin", "nvcc")


def _flags(name: str) -> tuple[str, ...]:
    return (*NVCC_FLAGS, *_DEFINES.get(name, ()))


def _target(name: str) -> Path:
    key = _ALL_SOURCES[name].read_bytes() + " ".join(_flags(name)).encode()
    return BUILD_DIR / f"{name}_{hashlib.sha256(key).hexdigest()[:16]}.so"


def build(*names: str) -> dict[str, Path]:
    """Compile the named sources (all of :data:`SOURCES` by default; a
    name of :data:`PROBE_SOURCES` too) unless each is already built; the
    ``nvcc`` runs start together.

    A library is named by the hash of its source and the flags, so an
    edited source is rebuilt. ``nvcc``'s output (``-Xptxas -v``:
    registers and spills per kernel) is kept beside it with the suffix
    ``.log``. Returns each name's shared library.
    """
    names = names or tuple(SOURCES)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = {}
    for name in names:
        so = _target(name)
        if so.exists():
            continue
        tmp = BUILD_DIR / f"{so.stem}.{os.getpid()}.tmp"
        proc = subprocess.Popen(
            [_nvcc(), *_flags(name), "-o", str(tmp), str(_ALL_SOURCES[name])],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        running[name] = (proc, tmp, so)
    failed = []
    for name, (proc, tmp, so) in running.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc {_ALL_SOURCES[name].name} failed with code "
                          f"{proc.returncode}:\n{err}")
            continue
        so.with_suffix(".log").write_text(out + err)
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: _target(name) for name in names}


def _library(name: str) -> ctypes.CDLL:
    if name not in _libs:
        lib = ctypes.CDLL(str(build(name)[name]))
        for fn, argtypes in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = _i32
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [_i32]
        err.restype = ctypes.c_char_p
        _libs[name] = lib
    return _libs[name]


# The types the row kernels read data in (K2's and its VJP's targets), and
# the code each C interface takes for it.
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _check_rows(name: str, t: torch.Tensor, dtypes=(torch.float32,)) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        names = " or ".join(str(d).removeprefix("torch.") for d in dtypes)
        raise TypeError(f"{name} must be {names}, got {t.dtype}")
    if t.dim() != 2:
        raise ValueError(f"{name} must be 2-D rows, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if max(t.shape) >= 2**31:
        raise ValueError(f"{name} shape {tuple(t.shape)} exceeds int32")


@lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch(lib_name: str, fn_name: str, device: torch.device, *args) -> None:
    lib = _library(lib_name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, fn_name)(*args, stream)
    if rc != 0:
        msg = getattr(lib, f"{lib_name}_error_string")(rc).decode()
        raise RuntimeError(f"{fn_name} launch failed: {msg} (code {rc})")


def tile_rows(x: torch.Tensor, n: int, fold: int, inner: int = 1) -> torch.Tensor:
    """``x`` tiled along dim 0 to ``n`` rows in the order ``fold`` names.

    ``inner > 1`` (b-major only): the rows of ``x`` are examples of
    ``inner`` rows each, and each example is repeated whole, so row ``(b
    * k + t) * inner + a`` of the result is row ``b * inner + a`` of
    ``x``."""
    if fold == FOLD_NONE:
        if x.shape[0] != n:
            raise ValueError(f"rows differ ({x.shape[0]} vs {n}) with no fold")
        return x
    if x.shape[0] == 0 or n % x.shape[0]:
        raise ValueError(f"{n} rows are not a tiling of {x.shape[0]}")
    if inner != 1 and (fold != FOLD_B or inner < 1 or x.shape[0] % inner):
        raise ValueError(f"inner={inner} needs the b-major fold and whole examples "
                         f"of {x.shape[0]} rows")
    k = n // x.shape[0]
    if fold == FOLD_T:
        return x.repeat((k,) + (1,) * (x.dim() - 1))
    if fold == FOLD_B:
        # A broadcast and a copy, as JAX's ``_tile_terms``: no host sync,
        # so it can be captured in a CUDA graph.
        examples = x.reshape((-1, 1, inner) + x.shape[1:])
        return examples.expand((-1, k, inner) + x.shape[1:]).reshape((n,) + x.shape[1:])
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
        "row_reduce", "kl_rows", mu.device, mu.data_ptr(), logvar.data_ptr(),
        out.data_ptr(), n, d,
    )
    LAUNCHES["kl"] += 1
    return out


def kl_std_normal_torch(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`kl_std_normal_kernel`."""
    return _kl_plain(mu, logvar)


def _check_grad_of(g: torch.Tensor, rows: torch.Tensor) -> None:
    """``g`` must be the ``(N,)`` f32 contiguous gradient of ``rows``' sums."""
    if not g.is_cuda or g.device != rows.device:
        raise ValueError(f"g must be a CUDA tensor on {rows.device}, got {g.device}")
    if g.dtype != torch.float32 or g.shape != rows.shape[:1] or not g.is_contiguous():
        raise ValueError(
            f"g must be contiguous float32 of shape {tuple(rows.shape[:1])}, got "
            f"{g.dtype} {tuple(g.shape)}"
        )


def kl_rows_grad_kernel(
    mu: torch.Tensor, logvar: torch.Tensor, g: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """K1's VJP on ``(N, D)`` f32 CUDA rows and their ``(N,)`` upstream
    gradient: ``(g * mu, 0.5 * g * (e^logvar - 1))``, as ``_kl_bwd``."""
    _check_rows("mu", mu)
    _check_rows("logvar", logvar)
    if logvar.shape != mu.shape or logvar.device != mu.device:
        raise ValueError(
            f"mu {tuple(mu.shape)} on {mu.device} and logvar "
            f"{tuple(logvar.shape)} on {logvar.device} differ"
        )
    _check_grad_of(g, mu)
    dmu, dlv = torch.empty_like(mu), torch.empty_like(logvar)
    if mu.numel() == 0:
        return dmu, dlv
    n, d = mu.shape
    _launch(
        "row_reduce", "kl_rows_grad", mu.device, mu.data_ptr(), logvar.data_ptr(),
        g.data_ptr(), dmu.data_ptr(), dlv.data_ptr(), n, d,
    )
    LAUNCHES["kl_bwd"] += 1
    return dmu, dlv


def kl_rows_grad_torch(
    mu: torch.Tensor, logvar: torch.Tensor, g: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`kl_rows_grad_kernel` (any leading
    dims; ``g`` has ``mu``'s shape without the last dim)."""
    g = g[..., None]
    return g * mu, g * 0.5 * (torch.exp(logvar) - 1.0)


# --------------------------------------------------------------- BCE ----

# Layouts of ``bce_rows``: a warp per row; a row split over a cluster of
# blocks (a block per row at split 1); a thread per row.
BCE_WARP, BCE_SPLIT, BCE_THREAD = 0, 1, 2
H100_SMS = 132
GRID_YZ_MAX = 65535  # gridDim.y and gridDim.z
_MAX_BLOCKS = 4096  # grid of the grid-strided layouts
_MAX_SPLIT = 8  # the portable cluster size
# Rows of at most THREAD_MAX_D elements take a thread each. Rows shorter
# than LONG_ROW_D take a warp each when there are at least
# WARP_MIN_ROWS_PER_SM of them an SM. Other rows take a block each, or a
# cluster of blocks when few.
THREAD_MAX_D = 8
LONG_ROW_D = 2048
WARP_MIN_ROWS_PER_SM = 8


class BcePlan(NamedTuple):
    """Launch of ``bce_rows``: layout, threads a block, blocks a row
    (the cluster size of ``BCE_SPLIT``) and blocks in all."""

    layout: int
    threads: int
    split: int
    blocks: int


def bce_plan(n: int, d: int, sms: int = H100_SMS) -> BcePlan:
    """The layout of K2 for ``n`` rows of ``d`` on a card of ``sms`` SMs.

    Rows of a few elements take a thread each, and many short rows a
    warp each: both fill the card. Fewer rows, or long ones, take a block
    each, so that every row has hundreds of threads with loads in flight;
    when the blocks would still leave half the SMs idle a row is split
    over a cluster of up to 8 blocks, as many as keep one block an SM. A
    block has 256 threads, 512 when its chunk holds 2048 float4s or more.
    ``kernel_plans.py`` times the alternatives."""
    if d <= THREAD_MAX_D:
        return BcePlan(BCE_THREAD, 256, 1, min(-(-n // 256), _MAX_BLOCKS))
    if d < LONG_ROW_D and n >= WARP_MIN_ROWS_PER_SM * sms:
        return BcePlan(BCE_WARP, 256, 1, min(-(-n // 8), _MAX_BLOCKS))
    split = 1
    while split < _MAX_SPLIT and n * split * 2 <= sms:
        split *= 2
    chunk = -(-d // (4 * split))  # float4s a block, or scalars in fours
    return BcePlan(BCE_SPLIT, 512 if chunk >= 2048 else 256, split, n * split)


class BceInnerPlan(NamedTuple):
    """Launch of ``bce_rows_inner``: a block of ``lanes`` x ``rows``
    threads, a row each, over a grid of (x: the inner rows, y: the terms,
    z: the examples)."""

    lanes: int
    rows: int
    grid_x: int
    grid_y: int
    grid_z: int


BCE_INNER_THREADS = 256


def bce_inner_plan(n_b: int, k: int, inner: int) -> BceInnerPlan:
    """The launch of K2's b-major map over ``n_b`` examples of ``inner``
    rows, each tiled ``k`` times: a thread a row, a block ``inner`` lanes
    wide (at most ``BCE_INNER_THREADS``) and as many terms deep as fill
    about that many threads, a block row of the grid per example. CelebA's
    IWAE (64 examples, k = 64, 18 attributes): blocks of 18 x 14 over a
    (1, 5, 64) grid."""
    lanes = min(inner, BCE_INNER_THREADS)
    rows = max(1, min(k, BCE_INNER_THREADS // lanes))
    return BceInnerPlan(lanes, rows, -(-inner // lanes), min(-(-k // rows), GRID_YZ_MAX),
                        min(n_b, GRID_YZ_MAX))


def bce_grad_inner_plan(n_b: int, k: int, inner: int) -> BceInnerPlan:
    """The launch of K2's VJP at the b-major map over ``n_b`` examples of
    ``inner`` rows (``bce_rows_grad_inner``): the forward's grid, a thread
    a row (:func:`bce_inner_plan`). CelebA's train step under the ``"b"``
    fold (64 examples, 23 attribute terms, 18 rows): blocks of 18 x 14
    over a (1, 2, 64) grid."""
    return bce_inner_plan(n_b, k, inner)


def bernoulli_nll_kernel(
    logits: torch.Tensor, x: torch.Tensor, fold: int = FOLD_NONE,
    plan: BcePlan | BceInnerPlan | None = None, inner: int = 1,
) -> torch.Tensor:
    """Summed BCE-with-logits of each row of ``(N, D)`` f32 CUDA logits.

    ``x`` holds ``(n_x, D)`` targets, float32 or bfloat16 (upcast as they
    are loaded; the sums stay f32): ``n_x == N`` with ``FOLD_NONE``, or
    one copy of a term tiling of ``N // n_x`` terms in the order ``fold``
    names -- the tiled copy is never made. ``inner > 1`` with ``FOLD_B``:
    the targets are examples of ``inner`` rows each (as :func:`tile_rows`
    tiles them), launched as ``bce_rows_inner`` in the grid
    :func:`bce_inner_plan` sizes. ``plan`` overrides :func:`bce_plan` (or
    :func:`bce_inner_plan`) of the shape and the card.
    """
    _check_rows("logits", logits)
    _check_rows("x", x, tuple(_DTYPE_CODES))
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
    if inner != 1 and (fold != FOLD_B or inner < 1 or n_x % inner):
        raise ValueError(f"inner={inner} needs FOLD_B and whole examples of {n_x} rows")
    out = torch.empty(n, dtype=torch.float32, device=logits.device)
    if n == 0:
        return out
    if inner != 1:
        plan = plan or bce_inner_plan(n_x // inner, n // n_x, inner)
        if not isinstance(plan, BceInnerPlan):
            raise TypeError(f"inner={inner} takes a BceInnerPlan, got {plan!r}")
        _launch(
            "row_reduce", "bce_rows_inner", logits.device, logits.data_ptr(), x.data_ptr(),
            out.data_ptr(), n_x // inner, n // n_x, inner, d, _DTYPE_CODES[x.dtype],
            *plan,
        )
    else:
        plan = plan or bce_plan(n, d, _sm_count(logits.device.index or 0))
        if not isinstance(plan, BcePlan):
            raise TypeError(f"bce_rows takes a BcePlan, got {plan!r}")
        _launch(
            "row_reduce", "bce_rows", logits.device, logits.data_ptr(), x.data_ptr(),
            out.data_ptr(), n, d, n_x, fold, _DTYPE_CODES[x.dtype], *plan,
        )
    LAUNCHES["bce"] += 1
    return out


def bernoulli_nll_torch(
    logits: torch.Tensor, x: torch.Tensor, fold: int = FOLD_NONE, inner: int = 1
) -> torch.Tensor:
    """Plain PyTorch version of :func:`bernoulli_nll_kernel` (tiles ``x``,
    a bf16 ``x`` upcast to the logits' type)."""
    return _bce_plain(logits, tile_rows(x, logits.shape[0], fold, inner), 1)


# A row of more than BCE_GRAD_LANES units is cut into chunks of that many,
# a block a chunk; a shorter row takes as many lanes as it has units, and a
# block of about BCE_GRAD_THREADS threads as many rows as fill whole warps.
# ``kernel_plans.py`` measured both on the H100 (PERF.md, section 6).
BCE_GRAD_LANES = 128
BCE_GRAD_THREADS = 128


class BceGradPlan(NamedTuple):
    """Launch of ``bce_rows_grad``: threads a block, lanes (the threads
    along a row, a unit each; a block holds threads // lanes rows), and the
    grid: x the chunks of a row, y the groups of target rows, z the
    terms."""

    threads: int
    lanes: int
    grid_x: int
    grid_y: int
    grid_z: int


def bce_grad_units(d: int) -> int:
    """Units of a row of ``bce_rows_grad``: float4s where ``d % 4 == 0``,
    else floats (the kernel takes floats also where a view is not 16-byte
    aligned)."""
    return d // 4 if d % 4 == 0 else d


def bce_grad_plan(
    n: int, d: int, n_x: int | None = None, threads: int | None = None,
    lanes: int | None = None,
) -> BceGradPlan:
    """The launch of K2's VJP for ``n`` rows of ``d`` against ``n_x``
    target rows (``n`` by default).

    A unit a thread. A row of more than 128 units takes blocks of 128
    lanes, a chunk of the row each (MNIST's 196 float4s: two chunks); a
    shorter row takes as many lanes as it has units (CelebA's attribute
    rows: one), and a block the fewest rows of lanes that fill whole warps,
    repeated up to about 128 threads. The grid is (chunks of a row, groups
    of target rows up to 65,535, terms ``n // n_x`` up to 65,535); the
    kernel strides past it. The rule takes no SM count: the grid follows
    the shape, and the card runs as many blocks at once as it holds.
    ``threads`` and ``lanes`` override the choice; ``kernel_plans.py``
    times the alternatives."""
    n_x = n if n_x is None else n_x
    units = bce_grad_units(d)
    if lanes is None:
        lanes = units if units <= 32 else min(BCE_GRAD_LANES, -(-units // 32) * 32)
    whole = lanes * 32 // math.gcd(lanes, 32)  # the fewest rows of lanes in whole warps
    threads = whole * max(1, (threads or BCE_GRAD_THREADS) // whole)
    rows = threads // lanes
    return BceGradPlan(threads, lanes, -(-units // lanes), min(-(-n_x // rows), GRID_YZ_MAX),
                       min(n // n_x, GRID_YZ_MAX))


def bce_rows_grad_kernel(
    logits: torch.Tensor, x: torch.Tensor, g: torch.Tensor, fold: int = FOLD_NONE,
    plan: BceGradPlan | BceInnerPlan | None = None, inner: int = 1,
) -> torch.Tensor:
    """K2's VJP in the logits on ``(N, D)`` f32 CUDA rows: ``g[r] *
    (sigmoid(logits[r]) - x[map(r)])``, as ``_bce_bwd``, with ``x`` (float32
    or bfloat16), ``fold`` and ``inner`` as :func:`bernoulli_nll_kernel`
    takes them (the tiled copy is never made) and ``g`` the ``(N,)``
    upstream gradient, in the launch :func:`bce_grad_plan` gives the shape
    (or ``plan``). ``inner > 1`` with ``FOLD_B`` launches
    ``bce_rows_grad_inner`` in the grid :func:`bce_grad_inner_plan` sizes,
    counted as ``LAUNCHES["bce_bwd_inner"]``."""
    _check_rows("logits", logits)
    _check_rows("x", x, tuple(_DTYPE_CODES))
    if x.shape[1] != logits.shape[1] or x.device != logits.device:
        raise ValueError(
            f"logits {tuple(logits.shape)} on {logits.device} and x "
            f"{tuple(x.shape)} on {x.device} do not match"
        )
    _check_grad_of(g, logits)
    n, d = logits.shape
    n_x = x.shape[0]
    if fold not in (FOLD_NONE, FOLD_T, FOLD_B):
        raise ValueError(f"unknown fold {fold!r}")
    if (fold == FOLD_NONE and n_x != n) or (
        fold != FOLD_NONE and (n_x == 0 or n % n_x)
    ):
        raise ValueError(f"{n} logits rows do not fold onto {n_x} target rows")
    if inner != 1 and (fold != FOLD_B or inner < 1 or n_x % inner):
        raise ValueError(f"inner={inner} needs FOLD_B and whole examples of {n_x} rows")
    out = torch.empty_like(logits)
    if out.numel() == 0:
        return out
    if inner != 1:
        plan = plan or bce_grad_inner_plan(n_x // inner, n // n_x, inner)
        if not isinstance(plan, BceInnerPlan):
            raise TypeError(f"inner={inner} takes a BceInnerPlan, got {plan!r}")
        _launch(
            "row_reduce", "bce_rows_grad_inner", logits.device, logits.data_ptr(),
            x.data_ptr(), g.data_ptr(), out.data_ptr(), n_x // inner, n // n_x, inner, d,
            _DTYPE_CODES[x.dtype], *plan,
        )
        LAUNCHES["bce_bwd_inner"] += 1
        return out
    plan = plan or bce_grad_plan(n, d, n_x)
    if not isinstance(plan, BceGradPlan):
        raise TypeError(f"bce_rows_grad takes a BceGradPlan, got {plan!r}")
    _launch(
        "row_reduce", "bce_rows_grad", logits.device, logits.data_ptr(), x.data_ptr(),
        g.data_ptr(), out.data_ptr(), n, d, n_x, fold, _DTYPE_CODES[x.dtype], *plan,
    )
    LAUNCHES["bce_bwd"] += 1
    return out


def bce_rows_grad_torch(
    logits: torch.Tensor, x: torch.Tensor, g: torch.Tensor, fold: int = FOLD_NONE,
    inner: int = 1,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`bce_rows_grad_kernel` (tiles ``x``)."""
    x = tile_rows(x, logits.shape[0], fold, inner).to(logits.dtype)
    return g[:, None] * (torch.sigmoid(logits) - x)


# ------------------------------------------------------------ seq CE ----

# Tokens of a call below which K3 is bound by latency (32 an SM): there a
# lane holds about SEQ_FEW_LOGITS logits of its token row, elsewhere
# about SEQ_MANY_LOGITS, so that fewer lanes share the per-token work.
SEQ_FEW_TOKENS_PER_SM = 32
SEQ_FEW_LOGITS, SEQ_MANY_LOGITS = 1, 12


class SeqCePlan(NamedTuple):
    """Launch of ``seq_ce_rows``: lanes a token row (32: a warp, float4
    loads), warps a block, blocks in all (one per example)."""

    lanes: int
    warps: int
    blocks: int


def seq_ce_plan(n: int, s: int, v: int, sms: int = H100_SMS) -> SeqCePlan:
    """The layout of K3 for ``(n, s, v)`` logits on a card of ``sms`` SMs.

    A block per example; a token row to the power-of-two group of lanes
    (up to a warp) that holds about 1 logit a lane when the call has few
    tokens, about 12 when it has many; enough warps for the example's
    tokens to run at once, up to 8, or up to 32 when the examples are
    fewer than the SMs. ``kernel_plans.py`` times the alternatives."""
    few = n * s < SEQ_FEW_TOKENS_PER_SM * sms
    per_lane = SEQ_FEW_LOGITS if few else SEQ_MANY_LOGITS
    lanes = min(32, 1 << max(0, -(-v // per_lane) - 1).bit_length())
    cap = 32 if n < sms else 8
    warps = max(1, min(cap, -(-s * lanes // 32)))
    return SeqCePlan(lanes, warps, n)


def _check_seq(logits: torch.Tensor, tokens: torch.Tensor) -> None:
    """``(N, S, V)`` f32 logits and ``(N, S)`` int32 or int64 tokens, both
    contiguous on one CUDA device."""
    if not logits.is_cuda or not tokens.is_cuda:
        raise ValueError(
            f"logits and tokens must be CUDA tensors, got {logits.device} "
            f"and {tokens.device}"
        )
    if logits.dtype != torch.float32:
        raise TypeError(f"logits must be float32, got {logits.dtype}")
    if tokens.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"tokens must be int32 or int64, got {tokens.dtype}")
    if logits.dim() != 3 or tokens.shape != logits.shape[:2]:
        raise ValueError(
            f"logits {tuple(logits.shape)} and tokens {tuple(tokens.shape)} "
            "are not (N, S, V) and (N, S)"
        )
    if tokens.device != logits.device:
        raise ValueError(f"logits on {logits.device}, tokens on {tokens.device}")
    if not logits.is_contiguous() or not tokens.is_contiguous():
        raise ValueError("logits and tokens must be contiguous")
    if max(logits.shape) >= 2**31:
        raise ValueError(f"logits shape {tuple(logits.shape)} exceeds int32")


def masked_seq_ce_kernel(
    logits: torch.Tensor, tokens: torch.Tensor, pad_token: int = 0,
    plan: SeqCePlan | None = None,
) -> torch.Tensor:
    """Token cross-entropy of ``(N, S, V)`` f32 CUDA logits against
    ``(N, S)`` int32 or int64 CUDA tokens, summed over the non-pad
    tokens of each row -> ``(N,)``. A pad token contributes exactly 0.
    ``plan`` overrides :func:`seq_ce_plan` of the shape and the card."""
    _check_seq(logits, tokens)
    n, s, v = logits.shape
    out = torch.empty(n, dtype=torch.float32, device=logits.device)
    if n == 0:
        return out
    plan = plan or seq_ce_plan(n, s, v, _sm_count(logits.device.index or 0))
    _launch(
        "seq_ce", "seq_ce_rows", logits.device, logits.data_ptr(),
        tokens.data_ptr(), tokens.element_size(), out.data_ptr(), n, s, v,
        int(pad_token), *plan,
    )
    LAUNCHES["seq_ce"] += 1
    return out


def masked_seq_ce_torch(
    logits: torch.Tensor, tokens: torch.Tensor, pad_token: int = 0
) -> torch.Tensor:
    """Plain PyTorch version of :func:`masked_seq_ce_kernel` (any leading
    dims): log-softmax, gather, pad mask, sum over S."""
    per_tok = _cat_plain(logits.to(torch.float32), tokens)
    return torch.sum(per_tok * (tokens != pad_token).to(per_tok.dtype), dim=-1)


# Paths of ``seq_ce_rows_grad``: a block stages a chunk of examples' logits,
# pad rows too, in shared memory (STAGED); a warp a token row, read twice
# (WARP); the lane-group layout, a group of lanes a token row read from
# device memory, a block an example (GROUPS). Vocabularies up to
# SEQ_GRAD_SMALL_V take GROUPS in a call of fewer tokens than
# SEQ_FEW_TOKENS_PER_SM an SM, else STAGED when one example's slab fits in
# SEQ_GRAD_MAX_SMEM bytes, up to SEQ_GRAD_LOGITS logits a lane (twice that
# at an odd V); a chunk holds about SEQ_GRAD_SLAB_FLOATS logits, but no
# fewer chunks than the SMs. Larger vocabularies take a warp a row.
# ``kernel_plans.py`` measured each limit on the H100 (PERF.md, section 6).
SEQ_GRAD_STAGED, SEQ_GRAD_WARP, SEQ_GRAD_GROUPS = 0, 1, 2
SEQ_GRAD_SMALL_V = 128
SEQ_GRAD_LOGITS = 16
SEQ_GRAD_SLAB_FLOATS = 1024
SEQ_GRAD_MAX_SMEM = 48 * 1024
SEQ_GRAD_MAX_WARPS = 16  # the gradient kernels' __launch_bounds__


class SeqCeGradPlan(NamedTuple):
    """Launch of ``seq_ce_rows_grad``: path, lanes a token row (staged
    and group paths), examples a chunk, warps a block and blocks (at most
    the chunks, which they walk with the grid's stride)."""

    path: int
    lanes: int
    examples: int
    warps: int
    blocks: int


def seq_ce_grad_smem(examples: int, s: int, v: int) -> int:
    """Shared memory of a staged block of ``seq_ce_rows_grad``, in bytes:
    the chunk's row labels and g rounded up to a float4, its slab, and 3
    floats of 16-byte phase (rounded to 4), as ``staged_floats`` in
    ``seq_ce.cu``."""
    rows = examples * s
    return 4 * (-(-(rows + examples) // 4) * 4 + rows * v + 4)


def seq_ce_grad_plan(
    n: int, s: int, v: int, sms: int = H100_SMS, path: int | None = None,
    examples: int | None = None,
) -> SeqCeGradPlan:
    """The layout of K3's VJP for ``(n, s, v)`` logits on a card of ``sms``
    SMs.

    A vocabulary of up to 128 takes, in a call of fewer tokens than 32 an SM
    (bound by latency), the lane-group layout with the forward's lanes and
    warps (:func:`seq_ce_plan`: a block an example, a group of lanes a token
    row; up to 16 warps); otherwise, where its example slab fits in 48 KB,
    it is staged: a block takes a chunk of examples of about 1,024 logits,
    or fewer so that the chunks are at least the SMs; a token row goes to
    the smallest power-of-two group of lanes that holds at most 16 logits a
    lane, or 32 at an odd V, whose rows start on every bank of shared
    memory; the warps give each of the chunk's rows a group, up to 16. The
    others take a warp a token row, a warp for each of the example's rows up
    to 16. ``path`` and ``examples`` override the choice; ``kernel_plans.py``
    times the alternatives. Raises where a staged chunk exceeds 48 KB of
    shared memory."""
    s1 = max(s, 1)
    if path is None:
        small = v <= SEQ_GRAD_SMALL_V and seq_ce_grad_smem(1, s1, v) <= SEQ_GRAD_MAX_SMEM
        few = n * s < SEQ_FEW_TOKENS_PER_SM * sms
        path = (SEQ_GRAD_GROUPS if few and v <= SEQ_GRAD_SMALL_V
                else SEQ_GRAD_STAGED if small else SEQ_GRAD_WARP)
    if path == SEQ_GRAD_GROUPS:
        lanes, warps, _ = seq_ce_plan(n, s, v, sms)
        return SeqCeGradPlan(path, lanes, 1, min(warps, SEQ_GRAD_MAX_WARPS), n)
    if path == SEQ_GRAD_WARP:
        examples = examples or 1
        warps = min(SEQ_GRAD_MAX_WARPS, examples * s1)
        return SeqCeGradPlan(path, 32, examples, warps, max(1, -(-n // examples)))
    if examples is None:
        examples = max(1, min(SEQ_GRAD_SLAB_FLOATS // (s1 * v), n // sms))
    examples = max(1, min(examples, n))
    if seq_ce_grad_smem(examples, s1, v) > SEQ_GRAD_MAX_SMEM:
        raise ValueError(
            f"seq_ce_rows_grad: {examples} examples of ({s}, {v}) logits take "
            f"{seq_ce_grad_smem(examples, s1, v)} bytes of shared memory, above "
            f"{SEQ_GRAD_MAX_SMEM}"
        )
    per_lane = SEQ_GRAD_LOGITS * (2 if v % 2 else 1)
    lanes = min(32, 1 << max(0, -(-v // per_lane) - 1).bit_length())
    warps = max(1, min(SEQ_GRAD_MAX_WARPS, -(-examples * s1 * lanes // 32)))
    return SeqCeGradPlan(path, lanes, examples, warps, max(1, -(-n // examples)))


def masked_seq_ce_grad_kernel(
    logits: torch.Tensor, tokens: torch.Tensor, pad_token: int, g: torch.Tensor,
    plan: SeqCeGradPlan | None = None,
) -> torch.Tensor:
    """K3's VJP (``_seq_ce_bwd``) on the arguments of
    :func:`masked_seq_ce_kernel` and the ``(N,)`` f32 upstream gradient:
    ``g[n] * (softmax(logits[n, s]) - onehot(tokens[n, s]))`` on the non-pad
    tokens, 0 on the pad ones -> ``(N, S, V)``, in the layout of
    :func:`seq_ce_grad_plan` (or ``plan``)."""
    _check_seq(logits, tokens)
    _check_grad_of(g, logits)
    n, s, v = logits.shape
    out = torch.empty_like(logits)
    if out.numel() == 0:
        return out
    plan = plan or seq_ce_grad_plan(n, s, v, _sm_count(logits.device.index or 0))
    _launch(
        "seq_ce", "seq_ce_rows_grad", logits.device, logits.data_ptr(),
        tokens.data_ptr(), tokens.element_size(), g.data_ptr(), out.data_ptr(), n, s, v,
        int(pad_token), *plan,
    )
    LAUNCHES["seq_ce_bwd"] += 1
    return out


def masked_seq_ce_grad_torch(
    logits: torch.Tensor, tokens: torch.Tensor, pad_token: int, g: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch version of :func:`masked_seq_ce_grad_kernel` (any
    leading dims; ``g`` has the tokens' shape without S), written as
    ``_seq_ce_bwd``: softmax less the one-hot of the token (none for a
    token outside the vocabulary), times the pad mask and ``g``."""
    logits = logits.to(torch.float32)
    v = logits.shape[-1]
    onehot = tokens.long()[..., None] == torch.arange(v, device=logits.device)
    mask = (tokens != pad_token).to(logits.dtype)[..., None]
    return g[..., None, None] * (torch.softmax(logits, dim=-1) - onehot.to(logits.dtype)) * mask


# -------------------------------------------------------- conv + swish ----

# Output channels of K4 (the CelebA image encoder's first stage), and all
# the output channels it takes: a rank's 32 / tp under tensor parallelism
# (tp = 1, 2, 4), each F a library of its own (``_CONV_LIBS``).
CONV_OUT = 32
CONV_OUTS = (32, 16, 8)
_CONV_LIBS = {32: "conv_s2", 16: "conv_s2_f16", 8: "conv_s2_f8"}
# (x's type, the weight's, bias's and output's type) -> K4's dtype code: all
# f32, all bf16, or a bf16 image into f32 weights and output (a
# data_dtype="bfloat16" batch meeting the f32 model).
_CONV_DTYPES = {(torch.float32, torch.float32): 0, (torch.bfloat16, torch.bfloat16): 1,
                (torch.bfloat16, torch.float32): 2}
# A warp of K4 computes one unit: 32 output pixels of one output row (8
# lanes x 4 pixels), all F channels (4 lanes x F / 4), from 4 staged input
# rows of CONV_TILE_COLS columns.
CONV_TILE_W = 32
CONV_TILE_COLS = 2 * CONV_TILE_W + 2
# The kernel's launch bound, 256 threads and 2 blocks an SM, caps a
# thread at 128 registers, and a block takes at most 42 KB of shared
# memory: 2 blocks of CONV_MAX_WARPS always fit on an SM.
CONV_MAX_WARPS = 8
CONV_WARPS = CONV_MAX_WARPS
CONV_BLOCKS_PER_SM = 2


class ConvPlan(NamedTuple):
    """Launch of ``conv4x4s2_swish``: warps a block, blocks (each walks
    units with the grid's stride), and the block's dynamic shared memory
    in bytes."""

    warps: int
    blocks: int
    smem: int


def conv_row_floats(c: int) -> int:
    """Floats of one staged input row of K4: ``(-c) % 4`` floats of lead
    (so the image's column 0 starts a float4), then CONV_TILE_COLS
    columns of ``c``, rounded up to a float4."""
    return -(-((-c) % 4 + CONV_TILE_COLS * c) // 4) * 4


def conv_units(b: int, h: int, w: int) -> int:
    """Units of K4 for a (b, h, w) batch: b x ceil(h/2) output rows x
    chunks of CONV_TILE_W output pixels."""
    w_out = -(-w // 2)
    return b * -(-h // 2) * -(-w_out // CONV_TILE_W)


@lru_cache(maxsize=256)  # the wrapper asks once a call; the shapes repeat
def conv_plan(
    b: int, h: int, w: int, c: int, sms: int = H100_SMS,
    blocks_per_sm: int = CONV_BLOCKS_PER_SM, warps: int | None = None, f: int = CONV_OUT,
) -> ConvPlan:
    """The launch of K4 for an NHWC ``(b, h, w, c)`` batch on a card of
    ``sms`` SMs: ``warps`` warps a block, as many blocks as keep
    ``blocks_per_sm`` an SM busy, or fewer when there are fewer units (a
    warp a unit); shared memory for the ``[tap][c][o]`` weights, the bias
    and each warp's 4 staged rows. By default a block has 8 warps; it
    has half as many, and an SM twice the blocks, when the units fit in
    one pass of the grid and the smaller blocks leave fewer units on the
    busiest SM (a ragged or small batch: 37 images take 12 units an SM,
    not 16). ``f`` is the output channels. ``kernel_plans.py`` times the
    alternatives."""
    units = conv_units(b, h, w)
    if warps is None:
        warps, half = CONV_WARPS, CONV_WARPS // 2
        one_pass = units <= sms * blocks_per_sm * warps
        if one_pass and half * -(-units // (half * sms)) < warps * -(-units // (warps * sms)):
            warps, blocks_per_sm = half, 2 * blocks_per_sm
    blocks = max(1, min(-(-units // warps), sms * blocks_per_sm))
    smem = 4 * (16 * c * f + f + warps * 4 * conv_row_floats(c))
    return ConvPlan(warps, blocks, smem)


def same_pad(hw, k: int = 4, s: int = 2) -> list[int]:
    """``F.pad`` widths of XLA's SAME for a k x k stride-s conv over the
    spatial dims ``hw``. Per dim the total is ``max((ceil(d/s) - 1) * s +
    k - d, 0)`` and the low side gets ``total // 2``: at odd sizes the pad
    is asymmetric (25 -> 13 pads (1, 2)), which ``Conv2d(padding=)``
    cannot express."""
    pads = []
    for d in reversed(tuple(hw)):  # F.pad takes (w_lo, w_hi, h_lo, h_hi)
        total = max((-(-d // s) - 1) * s + k - d, 0)
        pads += [total // 2, total - total // 2]
    return pads


def _check_conv_shapes(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> int:
    """K4's shapes: ``x`` ``(B, H, W, C)`` with 1 <= C <= 4, ``weight`` ``(F,
    C, 4, 4)`` and ``bias`` ``(F,)`` with F one of :data:`CONV_OUTS`.
    Returns F."""
    if x.dim() != 4 or not 1 <= x.shape[3] <= 4:
        raise ValueError(f"x must be (B, H, W, C) with 1 <= C <= 4, got {tuple(x.shape)}")
    c, f = x.shape[3], weight.shape[0] if weight.dim() else 0
    if f not in CONV_OUTS or weight.shape != (f, c, 4, 4) or bias.shape != (f,):
        raise ValueError(
            f"weight {tuple(weight.shape)} and bias {tuple(bias.shape)} are not "
            f"(F, {c}, 4, 4) and (F,) with F in {CONV_OUTS}"
        )
    return f


def conv4x4s2_swish_kernel(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
    plan: ConvPlan | None = None,
) -> torch.Tensor:
    """``swish(conv(x, weight, SAME, stride 2) + bias)`` on the card.

    ``x``: ``(B, H, W, C)`` NHWC with 1 <= C <= 4; ``weight``: ``(F, C, 4,
    4)`` OIHW, F one of :data:`CONV_OUTS` (32, or a rank's 16 or 8 under
    tensor parallelism); ``bias``: ``(F,)``; all contiguous CUDA tensors,
    of one dtype, float32 or bfloat16, or a bfloat16 ``x`` with float32
    weight and bias. Returns ``(B, F, ceil(H/2), ceil(W/2))`` NCHW in the
    weight's dtype, accumulated in f32 (all bf16: the conv, the bias add,
    the sigmoid and the product each rounded to bf16, as Flax's bf16 conv
    and swish round). Another F raises. ``plan`` overrides
    :func:`conv_plan` of the shape and the card.
    """
    dtypes = (x.dtype, weight.dtype)
    if dtypes not in _CONV_DTYPES or bias.dtype != weight.dtype:
        raise TypeError(
            f"x, weight and bias must be all float32, all bfloat16, or a bfloat16 x with "
            f"float32 weight and bias, got {x.dtype}, {weight.dtype}, {bias.dtype}"
        )
    for name, t in (("x", x), ("weight", weight), ("bias", bias)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
    f = _check_conv_shapes(x, weight, bias)
    b, h, w, c = x.shape
    if max(x.shape) >= 2**31 or x.numel() >= 2**31:
        raise ValueError(f"x shape {tuple(x.shape)} exceeds int32")
    out = torch.empty(
        (b, f, -(-h // 2), -(-w // 2)), dtype=weight.dtype, device=x.device
    )
    if out.numel() == 0:
        return out
    plan = plan or conv_plan(b, h, w, c, _sm_count(x.device.index or 0), f=f)
    _launch(
        _CONV_LIBS[f], "conv4x4s2_swish", x.device, x.data_ptr(), weight.data_ptr(),
        bias.data_ptr(), out.data_ptr(), b, h, w, c, _CONV_DTYPES[dtypes], *plan,
    )
    LAUNCHES["conv"] += 1
    return out


def conv4x4s2_swish_torch(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch version of :func:`conv4x4s2_swish_kernel` (any output
    channels): SAME pad, ``F.conv2d`` at stride 2 and swish in f32, cast
    to the type ``x`` and ``weight`` promote to. All bf16, in Flax's order
    with each op rounded to bf16, as the kernel rounds: the conv (summed in
    f32), then the bias add, the sigmoid and the product."""
    h = x.permute(0, 3, 1, 2).to(torch.float32)
    out_dtype = torch.promote_types(x.dtype, weight.dtype)
    pad = same_pad(h.shape[-2:])
    if out_dtype == torch.bfloat16:
        y = F.conv2d(F.pad(h, pad), weight.to(torch.float32), stride=2).to(out_dtype)
        y = y + bias.to(out_dtype)[:, None, None]
        return y * torch.sigmoid(y)
    y = F.conv2d(F.pad(h, pad), weight.to(torch.float32), bias.to(torch.float32), stride=2)
    return (y * torch.sigmoid(y)).to(out_dtype)


# The backward of K4 walks tiles of CONV_TILE_W output pixels by ``rows``
# output rows of one image, the grid's blocks taking every blocks-th tile.
# Per tile and per 16 channels and 16 pixels, a warp forms pre^T = W .
# patches^T and S = g swish'(pre + b) in registers (g read from global
# memory), then adds S . patches to its partial dW, both products 3xTF32
# on the tensor cores. Its launch bound, 128 registers a thread, lets 16
# warps stay on an SM (2 blocks of 8 warps, or 4 of 4).
CONV_BWD_MAX_WARPS = 8
CONV_BWD_WARPS = CONV_BWD_MAX_WARPS
CONV_BWD_BLOCKS_PER_SM = 2
CONV_BWD_ROWS = 4


class ConvBwdPlan(NamedTuple):
    """Launch of ``conv4x4s2_swish_bwd``: warps a block (4 or 8), blocks
    (each walks tiles with the grid's stride and writes one row of partial
    sums), the block's dynamic shared memory in bytes, and the output rows
    of a tile (2 or 4)."""

    warps: int
    blocks: int
    smem: int
    rows: int


def conv_bwd_tiles(b: int, h: int, w: int, rows: int = CONV_BWD_ROWS) -> int:
    """Tiles of K4's backward for a (b, h, w) batch: b x ceil(ceil(h/2) /
    rows) x chunks of CONV_TILE_W output pixels."""
    h_out, w_out = -(-h // 2), -(-w // 2)
    return b * -(-h_out // rows) * -(-w_out // CONV_TILE_W)


def conv_bwd_row_floats(c: int) -> int:
    """Floats of one staged input row of K4's backward: the forward's
    :func:`conv_row_floats`, padded to 4 past a multiple of 32 (at C = 1
    and 3 the second product's fragment loads, which may span two rows,
    then fall on distinct banks)."""
    return (conv_row_floats(c) + 27) // 32 * 32 + 4


def conv_bwd_m_tiles(f: int = CONV_OUT) -> int:
    """m-tiles of 16 output channels of K4's backward: 2 at F = 32, 1 at 16,
    and 1 at 8 (padded: rows 8-15 zero); the warps of a group, which take
    the same pixels."""
    return max(1, f // 16)


def conv_bwd_smem(c: int, rows: int, warps: int, f: int = CONV_OUT) -> int:
    """Bytes of K4's backward's shared memory: the weights as the first
    product's A fragments (hi and lo, :func:`conv_bwd_m_tiles` x 2 c k steps
    x 32 lanes x 8 floats), the input tile (2 rows + 2 of
    :func:`conv_bwd_row_floats`) split into TF32 hi and lo planes, and the
    next tile's raw copy (2 rows + 2 of :func:`conv_row_floats`); or, if
    more, the block's sums at the end (16 c x F a group of warps, F for each
    of 4 lane quarters of a group)."""
    mt = conv_bwd_m_tiles(f)
    staging = (mt * 2 * c * 32 * 8 + 2 * (2 * rows + 2) * conv_bwd_row_floats(c)
               + (2 * rows + 2) * conv_row_floats(c))
    return 4 * max(staging, warps // mt * (16 * c + 4) * f)


def conv_bwd_workspace_floats(plan: ConvBwdPlan, c: int, f: int = CONV_OUT) -> int:
    """The partial sums' workspace: a row of (16 c + 1) x F floats a block."""
    return plan.blocks * (16 * c + 1) * f


@lru_cache(maxsize=256)  # the wrapper asks once a call; the shapes repeat
def conv_bwd_plan(
    b: int, h: int, w: int, c: int, sms: int = H100_SMS, rows: int = CONV_BWD_ROWS,
    warps: int = CONV_BWD_WARPS, blocks_per_sm: int = CONV_BWD_BLOCKS_PER_SM,
    f: int = CONV_OUT,
) -> ConvBwdPlan:
    """The launch of K4's backward for an NHWC ``(b, h, w, c)`` batch on a
    card of ``sms`` SMs: blocks of ``warps`` warps, ``blocks_per_sm`` an
    SM, or one a tile when there are fewer tiles (:func:`conv_bwd_tiles`);
    shared memory by :func:`conv_bwd_smem`. ``kernel_plans.py`` times the
    alternatives."""
    blocks = max(1, min(conv_bwd_tiles(b, h, w, rows), sms * blocks_per_sm))
    return ConvBwdPlan(warps, blocks, conv_bwd_smem(c, rows, warps, f), rows)


def _check_conv_grad(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, g: torch.Tensor,
    codes: tuple[int, ...] = (0, 1, 2),
) -> tuple[int, int]:
    """The arguments K4's backward kernels take: CUDA tensors on one
    device, ``x`` ``(B, H, W, C)`` with 1 <= C <= 4, ``weight`` and ``bias``
    of its shapes (F in :data:`CONV_OUTS`), all contiguous, and ``g`` (any strides) of the output's
    shape, in the forward's types (:data:`_CONV_DTYPES`) whose code is in
    ``codes``: ``bias`` and ``g`` in the weight's type. Returns the code and F."""
    code = _CONV_DTYPES.get((x.dtype, weight.dtype))
    if code not in codes or bias.dtype != weight.dtype or g.dtype != weight.dtype:
        allowed = ", ".join(f"{a} x with {w} weight" for (a, w), c in _CONV_DTYPES.items()
                            if c in codes)
        raise TypeError(
            f"x, weight, bias and g must be one of: {allowed} (bias and g in the weight's "
            f"type), got {x.dtype}, {weight.dtype}, {bias.dtype}, {g.dtype}"
        )
    for name, t in (("x", x), ("weight", weight), ("bias", bias), ("g", g)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
        if name != "g" and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    f = _check_conv_shapes(x, weight, bias)
    b, h, w, c = x.shape
    out_shape = (b, f, -(-h // 2), -(-w // 2))
    if tuple(g.shape) != out_shape:
        raise ValueError(f"g is {tuple(g.shape)}, not the output's {out_shape}")
    if max(x.shape) >= 2**31 or x.numel() >= 2**31:
        raise ValueError(f"x shape {tuple(x.shape)} exceeds int32")
    return code, f


def conv4x4s2_swish_grad_kernel(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, g: torch.Tensor,
    plan: ConvBwdPlan | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The gradient of :func:`conv4x4s2_swish_kernel`'s output in its
    weight and bias, on the card: ``(dW, db)``, ``(F, C, 4, 4)`` and
    ``(F,)``, for the upstream gradient ``g`` ``(B, F, ceil(H/2),
    ceil(W/2))`` (F = 32, 16 or 8), in the forward's types: all float32, all bfloat16, or a
    bfloat16 ``x`` with the rest float32 (``bias`` and ``g`` always in the
    weight's type). ``pre = conv + bias`` is recomputed in f32 from the
    operands, which the kernel upcasts on load; ``g`` may be any strided
    view. ``dW`` and ``db`` come in the weight's type, rounded once from
    f32 sums over ``B x ceil(H/2) x ceil(W/2)``, taken in a fixed order (no
    atomics): the same plan gives the same bits. ``plan`` overrides
    :func:`conv_bwd_plan`."""
    code, f = _check_conv_grad(x, weight, bias, g)
    b, h, w, c = x.shape
    d_w = torch.empty((f, c, 4, 4), dtype=weight.dtype, device=x.device)
    d_b = torch.empty(f, dtype=weight.dtype, device=x.device)
    if g.numel() == 0:
        return d_w.zero_(), d_b.zero_()
    plan = plan or conv_bwd_plan(b, h, w, c, _sm_count(x.device.index or 0), f=f)
    ws = torch.empty(conv_bwd_workspace_floats(plan, c, f), dtype=torch.float32,
                     device=x.device)
    _launch(
        _CONV_LIBS[f], "conv4x4s2_swish_bwd", x.device, x.data_ptr(), weight.data_ptr(),
        bias.data_ptr(), g.data_ptr(), *g.stride(), ws.data_ptr(), d_w.data_ptr(),
        d_b.data_ptr(), b, h, w, c, code, *plan,
    )
    LAUNCHES["conv_bwd"] += 1
    return d_w, d_b


def _conv_bwd_terms(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, g: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The padded NCHW input, its 4 x 4 / 2 patches ``(B, 16 C, L)`` (in
    ``(c, ky, kx)`` order, as ``weight`` flattens) and ``g * swish'(pre)``
    ``(B, F, L)``, all float32 (from any operand types), ``L`` the output
    pixels."""
    h = x.permute(0, 3, 1, 2).to(torch.float32)
    padded = F.pad(h, same_pad(h.shape[-2:]))
    patches = F.unfold(padded, 4, stride=2)
    w_flat = weight.reshape(weight.shape[0], -1).to(torch.float32)
    pre = torch.einsum("ok,bkl->bol", w_flat, patches) + bias.to(torch.float32)[:, None]
    sig = torch.sigmoid(pre)
    s = g.to(torch.float32).reshape(pre.shape) * sig * (1.0 + pre * (1.0 - sig))
    return padded, patches, s


def conv4x4s2_swish_grad_torch(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, g: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`conv4x4s2_swish_grad_kernel` (any
    output channels), with explicit tensor ops: the SAME-padded patches,
    ``pre`` from them, ``s = g * swish'(pre)`` with ``swish'(u) = sig(u)
    (1 + u (1 - sig(u)))``, ``dW = s . patches`` and ``db = sum(s)``, in
    float32, then in the weight's type."""
    _, patches, s = _conv_bwd_terms(x, weight, bias, g)
    d_w = torch.einsum("bol,bkl->ok", s, patches).reshape(weight.shape)
    return d_w.to(weight.dtype), s.sum((0, 2)).to(weight.dtype)


# K4's input gradient walks tiles of ``rows`` output rows by CONV_TILE_W
# output columns of one image with the grid's stride; its warps take the
# tile's items of 32 S pixels in turn (the rows + 2 rows of S, and the
# ring's columns as one more item where the tile has them), both products
# 3xTF32 on the tensor cores, then fold T into dx. Its launch bound, 168
# registers a thread, admits 12 warps a block; a block takes at most
# CONV_DX_MAX_SMEM of shared memory.
CONV_DX_COLS = CONV_TILE_W + 2
CONV_DX_MAX_ROWS = 8
CONV_DX_FEW_ROWS = 2
CONV_DX_MAX_WARPS = 12
CONV_DX_BLOCKS_PER_SM = 1
CONV_DX_MAX_SMEM = 227 * 1024


class ConvDxPlan(NamedTuple):
    """Launch of ``conv4x4s2_swish_dx``: warps a block (1 to 12), blocks
    (each walks tiles with the grid's stride), the block's dynamic shared
    memory in bytes, and the output rows of a tile (1 to 8)."""

    warps: int
    blocks: int
    smem: int
    rows: int


def conv_dx_tiles(b: int, h: int, w: int, rows: int) -> int:
    """Tiles of K4's input gradient for a (b, h, w) batch: b x ceil(ceil(h/2)
    / rows) x chunks of CONV_TILE_W output columns."""
    h_out, w_out = -(-h // 2), -(-w // 2)
    return b * -(-h_out // rows) * -(-w_out // CONV_TILE_W)


def conv_dx_row_floats(c: int) -> int:
    """Floats of one staged input row of K4's input gradient: 2 x 34 + 2 = 70
    columns from 2 j0 - 3 on, after ``(4 - 3 c % 4) % 4`` floats that put the
    image's 16-byte chunks on 16 bytes, rounded up to a multiple of 4."""
    return ((4 - 3 * c % 4) % 4 + (2 * CONV_DX_COLS + 2) * c + 3) // 4 * 4


def conv_dx_t_pitch(c: int) -> int:
    """Floats of one S pixel's entries of T: 16 c, padded by 2 (odd c) or 4
    (even c) so that a warp's stores fall on distinct banks."""
    return 16 * c + (2 if c % 2 else 4)


def conv_dx_smem(c: int, rows: int, f: int = CONV_OUT) -> int:
    """Bytes of K4's input gradient's shared memory: the weights as both
    products' fragments (hi and lo, 2 x 32 c F floats); the next tile's raw
    input and the tile's TF32 hi and lo planes (2 rows + 6 of
    :func:`conv_dx_row_floats` each); and T, rows + 2 rows of CONV_DX_COLS
    S pixels of :func:`conv_dx_t_pitch` floats."""
    t = (rows + 2) * CONV_DX_COLS * conv_dx_t_pitch(c)
    return 4 * (64 * c * f + 3 * (2 * rows + 6) * conv_dx_row_floats(c) + t)


@lru_cache(maxsize=256)  # the wrapper asks once a call; the shapes repeat
def conv_dx_plan(
    b: int, h: int, w: int, c: int, sms: int = H100_SMS, rows: int | None = None,
    warps: int | None = None, blocks_per_sm: int = CONV_DX_BLOCKS_PER_SM,
    f: int = CONV_OUT,
) -> ConvDxPlan:
    """The launch of K4's input gradient for an NHWC ``(b, h, w, c)`` batch
    on a card of ``sms`` SMs: tiles of 8 output rows and a warp for each of
    their 10 rows of S where such tiles fill the SMs (a tile's ring columns
    then go to warp 0, whose top ring row is the cheapest item); else tiles
    of CONV_DX_FEW_ROWS rows, for more blocks, and CONV_DX_MAX_WARPS warps,
    the spare ones sharing the copy, the split and the fold. Blocks:
    ``blocks_per_sm`` an SM, or one a tile when there are fewer tiles
    (:func:`conv_dx_tiles`); shared memory by :func:`conv_dx_smem` (at most
    CONV_DX_MAX_SMEM). ``rows`` and ``warps`` override the rule;
    ``kernel_plans.py conv_dx`` times the alternatives."""
    if rows is None:
        fills = conv_dx_tiles(b, h, w, CONV_DX_MAX_ROWS) >= sms
        rows = CONV_DX_MAX_ROWS if fills else CONV_DX_FEW_ROWS
    if warps is None:
        fills = conv_dx_tiles(b, h, w, rows) >= sms
        warps = min(rows + 2, CONV_DX_MAX_WARPS) if fills else CONV_DX_MAX_WARPS
    blocks = max(1, min(conv_dx_tiles(b, h, w, rows), sms * blocks_per_sm))
    return ConvDxPlan(warps, blocks, conv_dx_smem(c, rows, f), rows)


def conv4x4s2_swish_input_grad_kernel(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, g: torch.Tensor,
    plan: ConvDxPlan | None = None,
) -> torch.Tensor:
    """The gradient of :func:`conv4x4s2_swish_kernel`'s output in its image,
    on the card: dx ``(B, H, W, C)`` NHWC for the upstream gradient ``g``
    ``(B, F, ceil(H/2), ceil(W/2))`` (any strided view; F = 32, 16 or 8),
    ``pre``
    recomputed from ``x``, ``weight`` and ``bias``: all float32, or all
    bfloat16 (``g`` too, and dx then bfloat16, computed in f32 and rounded
    once). Each entry sums its covering taps in a fixed order (no atomics):
    two calls give the same bits, whatever the plan. ``plan`` overrides
    :func:`conv_dx_plan`."""
    code, f = _check_conv_grad(x, weight, bias, g, codes=(0, 1))
    b, h, w, c = x.shape
    d_x = torch.empty_like(x)
    if d_x.numel() == 0:
        return d_x
    plan = plan or conv_dx_plan(b, h, w, c, _sm_count(x.device.index or 0), f=f)
    _launch(
        _CONV_LIBS[f], "conv4x4s2_swish_dx", x.device, x.data_ptr(), weight.data_ptr(),
        bias.data_ptr(), g.data_ptr(), *g.stride(), d_x.data_ptr(), b, h, w, c, code, *plan,
    )
    LAUNCHES["conv_dx"] += 1
    return d_x


def conv4x4s2_swish_input_grad_torch(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, g: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch version of :func:`conv4x4s2_swish_input_grad_kernel`
    (any output channels): the gradient of :func:`conv4x4s2_swish_torch`'s
    output in ``x``, NHWC in ``x``'s dtype: ``s = g * swish'(pre)`` back
    through the patches (``F.fold`` sums the overlapping taps), the pad cut
    off."""
    padded, _, s = _conv_bwd_terms(x, weight, bias, g)
    w_flat = weight.reshape(weight.shape[0], -1).to(s.dtype)
    d_padded = F.fold(torch.einsum("ok,bol->bkl", w_flat, s), padded.shape[-2:], 4, stride=2)
    w_lo, _, h_lo, _ = same_pad(x.shape[1:3])
    d_x = d_padded[:, :, h_lo:h_lo + x.shape[1], w_lo:w_lo + x.shape[2]]
    return d_x.permute(0, 2, 3, 1).to(x.dtype)


# ------------------------------------------------------- PoE + KL ----

# A block of the fused PoE holds the expert slab of its batch row and the
# weights of its terms in at most 48 KB of shared memory, and takes a warp
# a term, at most POE_MAX_WARPS.
POE_MAX_SMEM = 48 * 1024
POE_MAX_WARPS = 32


class PoeKlPlan(NamedTuple):
    """Launch of ``poe_kl``: terms a block, warps a block, blocks in all
    (batch rows x term groups) and the block's dynamic shared memory in
    bytes."""

    terms: int
    warps: int
    blocks: int
    smem: int


def poe_kl_plan(
    t: int, b: int, m: int, l: int, sms: int = H100_SMS, groups: int | None = None
) -> PoeKlPlan:
    """The launch of the fused PoE + KL for ``t`` terms of ``b`` batch
    rows of ``m`` experts of ``l`` latents, on a card of ``sms`` SMs.

    A block per batch row and group of terms, a warp per term. The terms
    of a row are split into as many groups as keep one block an SM
    (CelebA's 64 rows: 2 groups of 10 terms on 128 SMs; 100 rows or more:
    one group), at most one group a term; ``groups`` overrides the count.
    Raises where one block's slab exceeds 48 KB of shared memory.
    ``kernel_plans.py`` times the alternatives."""
    if groups is None:
        groups = sms // max(b, 1)
    groups = max(1, min(t, groups))
    terms = -(-t // groups)
    smem = 4 * (2 * m * l + terms * m)  # the mu and precision slabs, the weights
    if smem > POE_MAX_SMEM:
        raise ValueError(
            f"poe_kl: the slab of {m} experts x {l} latents and {terms} terms takes "
            f"{smem} bytes of shared memory, above {POE_MAX_SMEM}"
        )
    return PoeKlPlan(terms, min(terms, POE_MAX_WARPS), b * -(-t // terms), smem)


def _check_f32(name: str, x: torch.Tensor, shape: tuple, device) -> None:
    if not x.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {x.dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} is {tuple(x.shape)}, not {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if x.device != device:
        raise ValueError(f"{name} on {x.device}, mu_e on {device}")


def poe_kl_kernel(
    mu_e: torch.Tensor, lv_e: torch.Tensor, masks: torch.Tensor,
    presence: torch.Tensor | None = None, plan: PoeKlPlan | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The PoE of ``(B, M, L)`` f32 CUDA experts under ``(T, M)`` subset
    masks and an optional ``(B, M)`` presence mask, with the unit-Gaussian
    prior and eps 1e-8, and the KL of each fused posterior to N(0, I), in
    one launch.

    Returns ``(mu_f, lv_f, kl)``: ``(T, B, L)``, ``(T, B, L)`` and ``(T,
    B)``, as :func:`poe_kl_torch`. ``plan`` overrides :func:`poe_kl_plan`
    of the shape and the card."""
    if mu_e.dim() != 3:
        raise ValueError(f"mu_e must be (B, M, L), got shape {tuple(mu_e.shape)}")
    b, m, l = mu_e.shape
    _check_f32("mu_e", mu_e, (b, m, l), mu_e.device)
    _check_f32("lv_e", lv_e, (b, m, l), mu_e.device)
    if masks.dim() != 2:
        raise ValueError(f"masks must be (T, M), got shape {tuple(masks.shape)}")
    t = masks.shape[0]
    _check_f32("masks", masks, (t, m), mu_e.device)
    if presence is not None:
        _check_f32("presence", presence, (b, m), mu_e.device)
    if max(t * b * l, b * m * l) >= 2**31:
        raise ValueError(f"poe_kl shape {(t, b, m, l)} exceeds int32")
    mu_f = torch.empty((t, b, l), dtype=torch.float32, device=mu_e.device)
    lv_f = torch.empty_like(mu_f)
    kl = torch.empty((t, b), dtype=torch.float32, device=mu_e.device)
    if mu_f.numel() == 0:
        return mu_f, lv_f, kl
    plan = plan or poe_kl_plan(t, b, m, l, _sm_count(mu_e.device.index or 0))
    _launch(
        "poe_kl", "poe_kl", mu_e.device, mu_e.data_ptr(), lv_e.data_ptr(),
        masks.data_ptr(), None if presence is None else presence.data_ptr(),
        mu_f.data_ptr(), lv_f.data_ptr(), kl.data_ptr(), t, b, m, l, *plan,
    )
    LAUNCHES["poe_kl"] += 1
    return mu_f, lv_f, kl


def masked_poe_torch(
    mu_e: torch.Tensor, lv_e: torch.Tensor, masks: torch.Tensor,
    presence: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The fused ``(T, B, L)`` posteriors of :func:`poe_kl_torch`: the term
    masks times the presence, then the masked PoE of the expert stack
    against each term."""
    n_terms, n_mod = masks.shape
    eff = masks[:, None, :]  # (T, 1, M)
    if presence is not None:
        eff = eff * presence[None]  # (T, B, M)
    else:
        eff = eff.expand(n_terms, mu_e.shape[0], n_mod)
    return _poe_plain(mu_e[None], lv_e[None], mask=eff)


def poe_kl_torch(
    mu_e: torch.Tensor, lv_e: torch.Tensor, masks: torch.Tensor,
    presence: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`poe_kl_kernel`: the masked PoE,
    then the KL of each fused posterior."""
    mu_f, lv_f = masked_poe_torch(mu_e, lv_e, masks, presence)
    return mu_f, lv_f, _kl_plain(mu_f, lv_f)


# ------------------------------------------------- PoE + KL backward ----

# A block of ``poe_kl_bwd`` has at most 512 threads (its __launch_bounds__).
# It takes float4s where a term's sums take POE_BWD_VEC_TM terms x experts,
# else scalars in tiles of POE_BWD_SCALAR_TILE latents.
POE_BWD_MAX_THREADS = 512
POE_BWD_VEC_TM = 16
POE_BWD_SCALAR_TILE = 32
POE_BWD_VEC_THREADS = 256  # the fewest threads of a float4 block


class PoeKlBwdPlan(NamedTuple):
    """Launch of ``poe_kl_bwd``: latents a tile, float4 loads (1) or
    scalars (0), threads a block, blocks (batch rows x latent tiles) and
    the block's dynamic shared memory in bytes."""

    tile: int
    vec: int
    threads: int
    blocks: int
    smem: int


def poe_kl_bwd_smem(t: int, m: int, tile: int) -> int:
    """Shared memory of a ``poe_kl_bwd`` block: the tile's precisions (m x
    tile), the term weights (t x m, rounded up to a float4) and three (t x
    tile) term arrays, in bytes."""
    return 4 * (m * tile + -(-t * m // 4) * 4 + 3 * t * tile)


def poe_kl_bwd_plan(
    t: int, b: int, m: int, l: int, sms: int = H100_SMS, tile: int | None = None,
    vec: bool | None = None,
) -> PoeKlBwdPlan:
    """The launch of the fused PoE + KL's backward for ``t`` terms of ``b``
    batch rows of ``m`` experts of ``l`` latents, on a card of ``sms`` SMs.

    A block per batch row and tile of latents. Float4s (``vec``) where
    ``l % 4 == 0`` and a term's sums take at least POE_BWD_VEC_TM terms
    times experts (CelebA's 380), scalars otherwise, so that a small
    shape's work spreads over more threads (MNIST's and MultiMNIST's train
    steps). A row's latents split into as many tiles as keep the blocks
    within two an SM (CelebA's 64 rows: 4 tiles of 28 latents, 256
    blocks), a float4 tile a multiple of 4, a scalar tile at most
    POE_BWD_SCALAR_TILE latents (MNIST's and MultiMNIST's: 32). A tile is
    halved while the block's shared memory exceeds 48 KB. A thread a
    (term, column) or (expert, column), a column 4 latents with float4s,
    up to 512, and at least 256 with float4s. ``tile`` and ``vec``
    override the choice. Raises where no tile fits. ``kernel_plans.py``
    times the alternatives."""
    if vec is None:
        vec = l % 4 == 0 and t * m >= POE_BWD_VEC_TM
    vec = bool(vec) and l % 4 == 0
    if tile is None:
        step = 4 if vec else 1
        tile = -(-l // max(1, 2 * sms // max(b, 1)))
        tile = -(-tile // step) * step if vec else min(tile, POE_BWD_SCALAR_TILE)
        while tile > step and poe_kl_bwd_smem(t, m, tile) > POE_MAX_SMEM:
            tile = max(step, -(-(tile // 2) // step) * step)
    smem = poe_kl_bwd_smem(t, m, tile)
    if smem > POE_MAX_SMEM:
        raise ValueError(
            f"poe_kl_bwd: {m} experts and {t} terms take {smem} bytes of shared memory "
            f"at a tile of {tile} latents, above {POE_MAX_SMEM}"
        )
    vec = vec and tile % 4 == 0
    cols = -(-min(tile, l) // (4 if vec else 1))
    least = POE_BWD_VEC_THREADS if vec else 32
    threads = min(POE_BWD_MAX_THREADS, max(least, -(-max(t, m) * cols // 32) * 32))
    return PoeKlBwdPlan(tile, int(vec), threads, b * -(-l // tile), smem)


def _clamp_grad(lv: torch.Tensor) -> torch.Tensor:
    """The gradient of the forward's clamp (:func:`clamp_logvar`) at
    ``lv``, written out as the kernel computes it: 1 inside, 0.5 at
    exactly the bound, 0 beyond (and 0 at a NaN)."""
    a = lv.abs()
    return torch.where(
        a < LOGVAR_BOUND, 1.0, torch.where(a == LOGVAR_BOUND, 0.5, 0.0)
    ).to(lv.dtype)


def poe_kl_grad_torch(
    mu_e: torch.Tensor, lv_e: torch.Tensor, masks: torch.Tensor,
    presence: torch.Tensor | None, mu_f: torch.Tensor, lv_f: torch.Tensor,
    g_mu: torch.Tensor, g_lv: torch.Tensor, g_kl: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The gradients of :func:`poe_kl_torch`'s expert stack ``(d mu_e, d
    lv_e)``, ``(B, M, L)`` each, from its inputs, its outputs ``mu_f``,
    ``lv_f`` and the output gradients ``g_mu``, ``g_lv`` ``(T, B, L)`` and
    ``g_kl`` ``(T, B)``, written out in the kernel's order: the total
    precision S of each term recomputed as the forward sums it, K1's VJP
    added to the posteriors' gradients, then each expert's share summed
    over the terms."""
    n_terms, n_mod = masks.shape
    e = torch.exp(clamp_logvar(lv_e))
    p = 1.0 / (e + PRECISION_EPS)  # (B, M, L)
    w = masks[:, None, :]  # (T, 1, M)
    w = w * presence[None] if presence is not None else w.expand(n_terms, mu_e.shape[0], n_mod)
    big_p = p[None] * w[..., None]  # (T, B, M, L)
    tot = 1.0 + torch.sum(big_p, dim=-2)  # (T, B, L)
    g_kl = g_kl[..., None]
    a = (g_mu + g_kl * mu_f) / tot
    q = (g_lv + 0.5 * g_kl * (torch.exp(lv_f) - 1.0)) / tot
    d_mu = torch.sum(a[:, :, None] * big_p, dim=0)
    d_p = a[:, :, None] * (mu_e[None] - mu_f[:, :, None]) - q[:, :, None]
    d_q = torch.sum(w[..., None] * d_p, dim=0)
    return d_mu, d_q * -(e * p * p) * _clamp_grad(lv_e)


def poe_kl_grad_kernel(
    mu_e: torch.Tensor, lv_e: torch.Tensor, masks: torch.Tensor,
    presence: torch.Tensor | None, mu_f: torch.Tensor, lv_f: torch.Tensor,
    g_mu: torch.Tensor, g_lv: torch.Tensor, g_kl: torch.Tensor,
    plan: PoeKlBwdPlan | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`poe_kl_grad_torch` in one launch of ``poe_kl_bwd``, on f32
    contiguous CUDA tensors of one device (scalar loads where a pointer is
    not 16-byte aligned). ``plan`` overrides :func:`poe_kl_bwd_plan` of the
    shape and the card."""
    if mu_e.dim() != 3 or masks.dim() != 2:
        raise ValueError(
            f"mu_e must be (B, M, L) and masks (T, M), got {tuple(mu_e.shape)} and "
            f"{tuple(masks.shape)}"
        )
    b, m, l = mu_e.shape
    t = masks.shape[0]
    dev = mu_e.device
    for name, x, shape in (
        ("mu_e", mu_e, (b, m, l)), ("lv_e", lv_e, (b, m, l)), ("masks", masks, (t, m)),
        ("mu_f", mu_f, (t, b, l)), ("lv_f", lv_f, (t, b, l)), ("g_mu", g_mu, (t, b, l)),
        ("g_lv", g_lv, (t, b, l)), ("g_kl", g_kl, (t, b)),
    ):
        _check_f32(name, x, shape, dev)
    if presence is not None:
        _check_f32("presence", presence, (b, m), dev)
    if max(t * b * l, b * m * l) >= 2**31:
        raise ValueError(f"poe_kl_bwd shape {(t, b, m, l)} exceeds int32")
    d_mu, d_lv = torch.empty_like(mu_e), torch.empty_like(lv_e)
    if d_mu.numel() == 0 or t == 0:
        return d_mu.zero_(), d_lv.zero_()
    plan = plan or poe_kl_bwd_plan(t, b, m, l, _sm_count(dev.index or 0))
    _launch(
        "poe_kl", "poe_kl_bwd", dev, mu_e.data_ptr(), lv_e.data_ptr(), masks.data_ptr(),
        None if presence is None else presence.data_ptr(), mu_f.data_ptr(), lv_f.data_ptr(),
        g_mu.data_ptr(), g_lv.data_ptr(), g_kl.data_ptr(), d_mu.data_ptr(), d_lv.data_ptr(),
        t, b, m, l, *plan,
    )
    LAUNCHES["poe_kl_bwd"] += 1
    return d_mu, d_lv
