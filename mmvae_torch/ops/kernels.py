"""Hand-written CUDA kernels for the ELBO's reductions, with plain versions.

  * ``kl_std_normal_kernel`` replaces ``mmvae_tpu/ops/kernels.py::
    kl_std_normal_pallas`` (K1): ``-0.5 * sum(1 + lv - mu^2 - e^lv)``
    per row of ``(N, D)``;
  * ``bernoulli_nll_kernel`` replaces ``mmvae_tpu/ops/kernels.py::
    bernoulli_nll_pallas`` (K2): ``sum(max(l,0) - l*x + log1p(e^-|l|))``
    per row, reading its targets through a row map (``FOLD_*``) so
    term-tiled logits are scored against one untiled copy of the targets,
    in the layout :func:`bce_plan` picks from the shape;
  * ``masked_seq_ce_kernel`` replaces ``mmvae_tpu/ops/kernels.py::
    masked_seq_ce_pallas`` (K3): per example of ``(N, S, V)`` logits, the
    token cross-entropy ``logsumexp(l) - l[token]`` summed over its
    non-pad tokens, in the layout :func:`seq_ce_plan` picks;
  * ``conv4x4s2_swish_kernel`` replaces ``tools/pallas_conv_probe.py::
    pallas_conv0`` (K4): ``swish(conv(x, w, SAME, stride 2) + b)`` of an
    NHWC image with 1-4 channels into 32 NCHW channels, a warp per
    32-pixel chunk of an output row, in the grid :func:`conv_plan` sizes.

K1 and K2 live in ``csrc/row_reduce.cu``, K3 in ``csrc/seq_ce.cu``, K4 in
``csrc/conv_s2.cu``, each behind a plain C interface. :func:`build` compiles the sources with
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

__all__ = [
    "FOLD_NONE",
    "FOLD_T",
    "FOLD_B",
    "LAUNCHES",
    "SOURCES",
    "build",
    "tile_rows",
    "BcePlan",
    "bce_plan",
    "SeqCePlan",
    "seq_ce_plan",
    "ConvPlan",
    "conv_plan",
    "kl_std_normal_kernel",
    "kl_std_normal_torch",
    "bernoulli_nll_kernel",
    "bernoulli_nll_torch",
    "masked_seq_ce_kernel",
    "masked_seq_ce_torch",
    "same_pad",
    "conv4x4s2_swish_kernel",
    "conv4x4s2_swish_torch",
]

# Target-row maps of the BCE kernel: rows match; t-major tiling (row
# t * n_x + b reads target b); b-major tiling (row b * k + t reads b).
FOLD_NONE, FOLD_T, FOLD_B = 0, 1, 2

# Kernel launches per wrapper, counted where each launch is made.
LAUNCHES = {"kl": 0, "bce": 0, "seq_ce": 0, "conv": 0}

_CSRC = Path(__file__).resolve().parent / "csrc"
# Library name -> CUDA source; each library exports ``<name>_error_string``.
SOURCES = {
    "row_reduce": _CSRC / "row_reduce.cu",
    "seq_ce": _CSRC / "seq_ce.cu",
    "conv_s2": _CSRC / "conv_s2.cu",
}
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
        "bce_rows": [_ptr, _ptr, _ptr, _i32, _i32, _i32, _i32, _i32, _i32, _i32, _i32, _ptr],
    },
    "seq_ce": {
        "seq_ce_rows": [_ptr, _ptr, _i32, _ptr, _i32, _i32, _i32, _i64, _i32, _i32, _i32, _ptr],
    },
    "conv_s2": {
        "conv4x4s2_swish": [_ptr, _ptr, _ptr, _ptr, _i32, _i32, _i32, _i32, _i32,
                            _i32, _i32, _i32, _ptr],
    },
}
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(cuda_home, "bin", "nvcc")


def _target(name: str) -> Path:
    key = SOURCES[name].read_bytes() + " ".join(NVCC_FLAGS).encode()
    return BUILD_DIR / f"{name}_{hashlib.sha256(key).hexdigest()[:16]}.so"


def build(*names: str) -> dict[str, Path]:
    """Compile the named sources (all of :data:`SOURCES` by default)
    unless each is already built; the ``nvcc`` runs start together.

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
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        running[name] = (proc, tmp, so)
    failed = []
    for name, (proc, tmp, so) in running.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc {SOURCES[name].name} failed with code "
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
        "row_reduce", "kl_rows", mu.device, mu.data_ptr(), logvar.data_ptr(),
        out.data_ptr(), n, d,
    )
    LAUNCHES["kl"] += 1
    return out


def kl_std_normal_torch(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`kl_std_normal_kernel`."""
    return _kl_plain(mu, logvar)


# --------------------------------------------------------------- BCE ----

# Layouts of ``bce_rows``: a warp per row; a row split over a cluster of
# blocks (a block per row at split 1); a thread per row.
BCE_WARP, BCE_SPLIT, BCE_THREAD = 0, 1, 2
H100_SMS = 132
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


def bernoulli_nll_kernel(
    logits: torch.Tensor, x: torch.Tensor, fold: int = FOLD_NONE,
    plan: BcePlan | None = None,
) -> torch.Tensor:
    """Summed BCE-with-logits of each row of ``(N, D)`` f32 CUDA logits.

    ``x`` holds ``(n_x, D)`` targets: ``n_x == N`` with ``FOLD_NONE``, or
    one copy of a term tiling of ``N // n_x`` terms in the order ``fold``
    names -- the tiled copy is never made. ``plan`` overrides
    :func:`bce_plan` of the shape and the card.
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
    plan = plan or bce_plan(n, d, _sm_count(logits.device.index or 0))
    _launch(
        "row_reduce", "bce_rows", logits.device, logits.data_ptr(), x.data_ptr(),
        out.data_ptr(), n, d, n_x, fold, *plan,
    )
    LAUNCHES["bce"] += 1
    return out


def bernoulli_nll_torch(
    logits: torch.Tensor, x: torch.Tensor, fold: int = FOLD_NONE
) -> torch.Tensor:
    """Plain PyTorch version of :func:`bernoulli_nll_kernel` (tiles ``x``)."""
    return _bce_plain(logits, tile_rows(x, logits.shape[0], fold), 1)


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


def masked_seq_ce_kernel(
    logits: torch.Tensor, tokens: torch.Tensor, pad_token: int = 0,
    plan: SeqCePlan | None = None,
) -> torch.Tensor:
    """Token cross-entropy of ``(N, S, V)`` f32 CUDA logits against
    ``(N, S)`` int32 or int64 CUDA tokens, summed over the non-pad
    tokens of each row -> ``(N,)``. A pad token contributes exactly 0.
    ``plan`` overrides :func:`seq_ce_plan` of the shape and the card."""
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


# -------------------------------------------------------- conv + swish ----

# Output channels of K4 (the CelebA image encoder's first stage).
CONV_OUT = 32
_CONV_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# A warp of K4 computes one unit: 32 output pixels of one output row (8
# lanes x 4 pixels), all 32 channels (4 lanes x 8), from 4 staged input
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
    blocks_per_sm: int = CONV_BLOCKS_PER_SM, warps: int | None = None,
) -> ConvPlan:
    """The launch of K4 for an NHWC ``(b, h, w, c)`` batch on a card of
    ``sms`` SMs: ``warps`` warps a block, as many blocks as keep
    ``blocks_per_sm`` an SM busy, or fewer when there are fewer units (a
    warp a unit); shared memory for the ``[tap][c][o]`` weights, the bias
    and each warp's 4 staged rows. By default a block has 8 warps; it
    has half as many, and an SM twice the blocks, when the units fit in
    one pass of the grid and the smaller blocks leave fewer units on the
    busiest SM (a ragged or small batch: 37 images take 12 units an SM,
    not 16). ``kernel_plans.py`` times the alternatives."""
    units = conv_units(b, h, w)
    if warps is None:
        warps, half = CONV_WARPS, CONV_WARPS // 2
        one_pass = units <= sms * blocks_per_sm * warps
        if one_pass and half * -(-units // (half * sms)) < warps * -(-units // (warps * sms)):
            warps, blocks_per_sm = half, 2 * blocks_per_sm
    blocks = max(1, min(-(-units // warps), sms * blocks_per_sm))
    smem = 4 * (16 * c * CONV_OUT + CONV_OUT + warps * 4 * conv_row_floats(c))
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


def conv4x4s2_swish_kernel(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
    plan: ConvPlan | None = None,
) -> torch.Tensor:
    """``swish(conv(x, weight, SAME, stride 2) + bias)`` on the card.

    ``x``: ``(B, H, W, C)`` NHWC with 1 <= C <= 4; ``weight``: ``(32, C, 4,
    4)`` OIHW; ``bias``: ``(32,)``; all contiguous CUDA tensors of one
    dtype, float32 or bfloat16. Returns ``(B, 32, ceil(H/2), ceil(W/2))``
    NCHW in that dtype, accumulated in f32. ``plan`` overrides
    :func:`conv_plan` of the shape and the card.
    """
    for name, t in (("x", x), ("weight", weight), ("bias", bias)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype not in _CONV_DTYPES or t.dtype != x.dtype:
            raise TypeError(
                f"x, weight and bias must share a dtype of float32 or bfloat16, "
                f"got {x.dtype}, {weight.dtype}, {bias.dtype}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
    if x.dim() != 4 or not 1 <= x.shape[3] <= 4:
        raise ValueError(f"x must be (B, H, W, C) with 1 <= C <= 4, got {tuple(x.shape)}")
    b, h, w, c = x.shape
    if weight.shape != (CONV_OUT, c, 4, 4) or bias.shape != (CONV_OUT,):
        raise ValueError(
            f"weight {tuple(weight.shape)} and bias {tuple(bias.shape)} are not "
            f"({CONV_OUT}, {c}, 4, 4) and ({CONV_OUT},)"
        )
    if max(x.shape) >= 2**31 or x.numel() >= 2**31:
        raise ValueError(f"x shape {tuple(x.shape)} exceeds int32")
    out = torch.empty(
        (b, CONV_OUT, -(-h // 2), -(-w // 2)), dtype=x.dtype, device=x.device
    )
    if out.numel() == 0:
        return out
    plan = plan or conv_plan(b, h, w, c, _sm_count(x.device.index or 0))
    _launch(
        "conv_s2", "conv4x4s2_swish", x.device, x.data_ptr(), weight.data_ptr(),
        bias.data_ptr(), out.data_ptr(), b, h, w, c, _CONV_DTYPES[x.dtype], *plan,
    )
    LAUNCHES["conv"] += 1
    return out


def conv4x4s2_swish_torch(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch version of :func:`conv4x4s2_swish_kernel` (any output
    channels): SAME pad, ``F.conv2d`` at stride 2 and swish in f32, cast
    to ``x``'s dtype."""
    h = x.permute(0, 3, 1, 2).to(torch.float32)
    y = F.conv2d(
        F.pad(h, same_pad(h.shape[-2:])), weight.to(torch.float32),
        bias.to(torch.float32), stride=2,
    )
    return (y * torch.sigmoid(y)).to(x.dtype)
