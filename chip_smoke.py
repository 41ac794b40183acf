"""Smoke run of the PyTorch/CUDA port (``mmvae_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is non-zero:

1. device and build: the card's name and power limit, TF32 off, and the
   hand-written kernels built from ``mmvae_torch/ops/csrc`` with ``nvcc``;
2. each kernel held against its plain PyTorch version on the card, at the
   main path's shapes and at ragged and large ones (rtol 1e-5, atol
   1e-5 * D: the kernel sums a row in another order);
3. the main path at full width -- the ``mnist`` config (n_latents 64, 512
   wide experts) with seeded random weights: ``eval_elbo`` over the
   2,000-example synthetic test split, ``generate`` from labels and
   ``sample`` -- with the launch counts read around it; then the same
   eval with the plain ``torch`` backend (rel 1e-5) and a CPU reference on
   a small split (rel 1e-4: CPU and card matmuls round differently);
4. timings: each kernel and its plain version on the device (CUDA-graph
   replay, median of 50) and eagerly (host overhead included), the wall
   time of one ``eval_elbo``, and a profile of where its device time goes.

It prints one JSON line per result, the ``nvidia-smi`` line, the kernel
summary, and as the last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time
from pathlib import Path

import torch

from mmvae_torch import api, configs, ops
from mmvae_torch.data import load_dataset
from mmvae_torch.ops import kernels

ROOT = Path(__file__).resolve().parent
# NVIDIA H100 SXM data sheet: HBM3 rate and f32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# Per element: KL 4 flops + exp; BCE 5 flops + exp + log1p.
OPS_PER_ELEM = {"kl": 5, "bce": 7}
META = {
    "kl": {
        "name": "kl_std_normal",
        "route": "cuda",
        "source": "mmvae_torch/ops/csrc/row_reduce.cu",
        "replaces": "mmvae_tpu/ops/kernels.py:139",
    },
    "bce": {
        "name": "bernoulli_nll",
        "route": "cuda",
        "source": "mmvae_torch/ops/csrc/row_reduce.cu",
        "replaces": "mmvae_tpu/ops/kernels.py:168",
    },
}
# (N, D, n_x, fold) of each kernel at the main path's shape (one eval
# batch of 100: T=3 terms of KL; 2 member terms of image BCE against one
# untiled copy of the targets) and at a large shape.
EVAL_SHAPE = {"kl": (300, 64, 300, None), "bce": (200, 784, 100, kernels.FOLD_T)}
LARGE_SHAPE = {"kl": (12288, 64, 12288, None), "bce": (8192, 784, 4096, kernels.FOLD_T)}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def inputs(op: str, shape, gen: torch.Generator):
    n, d, n_x, fold = shape
    dev = gen.device
    if op == "kl":
        return (torch.randn(n, d, generator=gen, device=dev),
                torch.randn(n, d, generator=gen, device=dev))
    logits = 3.0 * torch.randn(n, d, generator=gen, device=dev)
    x = torch.rand(n_x, d, generator=gen, device=dev)
    return (logits, x, fold)


def kernel_fn(op):
    return kernels.kl_std_normal_kernel if op == "kl" else kernels.bernoulli_nll_kernel


def plain_fn(op):
    return kernels.kl_std_normal_torch if op == "kl" else kernels.bernoulli_nll_torch


def bound(op: str, shape) -> tuple[float, str]:
    """Least time on the card: each input read once, the output written once."""
    n, d, n_x, _ = shape
    n_bytes = 4 * (n * d + n_x * d + n)
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = OPS_PER_ELEM[op] * n * d / F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


# ------------------------------------------------------------ phase 1 ----


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": kind, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    so = kernels.build()
    ptxas = [
        line.strip() for line in so.with_suffix(".log").read_text().splitlines()
        if "registers" in line or "spill" in line
    ]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": str(so.relative_to(ROOT)), "ptxas": ptxas})
    return kind


# ------------------------------------------------------------ phase 2 ----


def phase_check() -> dict[str, float]:
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = {
        "kl": [EVAL_SHAPE["kl"], (37, 100, 37, None), LARGE_SHAPE["kl"]],
        "bce": [
            (200, 784, 200, kernels.FOLD_NONE),
            EVAL_SHAPE["bce"],
            (200, 784, 100, kernels.FOLD_B),
            (37, 1000, 37, kernels.FOLD_NONE),
            LARGE_SHAPE["bce"],
        ],
    }
    max_err = {}
    for op, shapes in cases.items():
        max_err[op] = 0.0
        for shape in shapes:
            args = inputs(op, shape, gen)
            got = kernel_fn(op)(*args)
            want = plain_fn(op)(*args)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * shape[1])
            max_err[op] = max(max_err[op], err)
            emit({"phase": "check", "kernel": META[op]["name"],
                  "shape": list(shape[:3]), "fold": shape[3], "max_abs_err": err})
    return max_err


# ------------------------------------------------------------ phase 3 ----


def phase_main_path() -> dict[str, int]:
    model = configs.build_model("mnist", seed=0)
    test = load_dataset("mnist", "test")
    assert test.size == 2000
    gen = torch.Generator(device="cuda").manual_seed(0)

    # The main path, as a user calls it, with the "kernel" backend: every
    # reduction runs in its kernel or raises.
    ops.set_backend("kernel")
    try:
        for k in kernels.LAUNCHES:
            kernels.LAUNCHES[k] = 0
        elbo = api.eval_elbo("mnist", model=model, dataset=test)
        gen_out = api.generate("mnist", {"label": [3, 5, 7]}, model=model)
        samples = api.sample("mnist", n=64, model=model, generator=gen)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
    finally:
        ops.set_backend("auto")
    emit({"phase": "main_path", "eval_elbo": elbo, "launches": launches})
    if launches != {"kl": 20, "bce": 20}:
        raise AssertionError(f"expected 20 launches of each kernel, got {launches}")

    for out, n in ((gen_out, 3), (samples, 64)):
        img, lab = out["image"], out["label"]
        if img.shape != (n, 28, 28) or lab.shape != (n,):
            raise AssertionError(f"bad shapes {img.shape} {lab.shape}")
        if not (torch.isfinite(img).all() and img.min() >= 0 and img.max() <= 1):
            raise AssertionError("generated image not finite or outside [0, 1]")
        if not (lab.min() >= 0 and lab.max() < 10):
            raise AssertionError("generated label out of range")

    ops.set_backend("torch")
    try:
        elbo_plain = api.eval_elbo("mnist", model=model, dataset=test)
    finally:
        ops.set_backend("auto")
    if kernels.LAUNCHES != launches:
        raise AssertionError("the torch backend launched a kernel")
    rel = abs(elbo - elbo_plain) / abs(elbo_plain)
    emit({"phase": "kernel_vs_torch_backend", "eval_elbo_kernel": elbo,
          "eval_elbo_torch": elbo_plain, "rel": rel})
    if not rel <= 1e-5:
        raise AssertionError(f"kernel and torch backends differ: rel {rel}")

    small = load_dataset("mnist", "test", n=250)
    cpu_model = configs.build_model("mnist", seed=0, device="cpu")
    on_card = api.eval_elbo("mnist", model=model, dataset=small)
    on_cpu = api.eval_elbo("mnist", model=cpu_model, dataset=small, device="cpu")
    gen_cpu = api.generate("mnist", {"label": [3, 5, 7]}, model=cpu_model, device="cpu")
    rel_cpu = abs(on_card - on_cpu) / abs(on_cpu)
    img_err = (gen_out["image"].cpu() - gen_cpu["image"]).abs().max().item()
    emit({"phase": "card_vs_cpu", "eval_elbo_card": on_card, "eval_elbo_cpu": on_cpu,
          "rel": rel_cpu, "generate_image_max_abs_err": img_err})
    if not rel_cpu <= 1e-4 or not img_err <= 1e-4:
        raise AssertionError(f"card and CPU differ: rel {rel_cpu}, image {img_err}")
    if not torch.equal(gen_out["label"].cpu(), gen_cpu["label"]):
        raise AssertionError("generated labels differ between card and CPU")
    return launches


# ------------------------------------------------------------ phase 4 ----


def device_ms(fn, reps: int = 50, inner: int = 20) -> float:
    """Device time of one call: CUDA-graph replay of ``inner`` calls,
    timed by CUDA events, median over ``reps`` replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def eager_ms(fn, reps: int = 50, inner: int = 20) -> float:
    """Time of one eager call, host overhead included (median of ``reps``)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def phase_timings(launches: dict[str, int]) -> dict[str, dict]:
    gen = torch.Generator(device="cuda").manual_seed(1)
    at_eval = {}
    for op in ("kl", "bce"):
        for label, shape in (("eval", EVAL_SHAPE[op]), ("large", LARGE_SHAPE[op])):
            args = inputs(op, shape, gen)
            k, p = kernel_fn(op), plain_fn(op)
            row = {
                "kernel_ms": device_ms(lambda: k(*args)),
                "plain_ms": device_ms(lambda: p(*args)),
                "kernel_eager_ms": eager_ms(lambda: k(*args)),
                "plain_eager_ms": eager_ms(lambda: p(*args)),
            }
            row["bound_ms"], row["bound_by"] = bound(op, shape)
            emit({"phase": "timing", "kernel": META[op]["name"], "shape": label,
                  "n_d_nx": list(shape[:3]), **row,
                  "launches_per_eval": launches[op]})
            if label == "eval":
                at_eval[op] = row
    return at_eval


def phase_eval_wall() -> None:
    model = configs.build_model("mnist", seed=0)
    test = load_dataset("mnist", "test")
    api.eval_elbo("mnist", model=model, dataset=test)  # warm-up
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        api.eval_elbo("mnist", model=model, dataset=test)  # ends in a sync
        walls.append(1e3 * (time.perf_counter() - t0))
    emit({"phase": "eval_wall", "examples": test.size, "batches": 20,
          "wall_ms_median": statistics.median(walls), "wall_ms": walls})

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        api.eval_elbo("mnist", model=model, dataset=test)
        wall_us = 1e6 * (time.perf_counter() - t0)

    def dev_us(e):
        return getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)

    # Device-side events only (kernels, copies): a CPU op's device time
    # repeats that of the kernels it launched.
    rows = sorted(
        ((dev_us(e), e.key, e.count) for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA),
        reverse=True,
    )
    busy = sum(r[0] for r in rows)
    emit({"phase": "eval_profile", "wall_us": wall_us,
          "device_busy_us": busy if busy else "not measured",
          "device_idle_share": 1 - busy / wall_us if busy else "not measured",
          "device_events": sum(r[2] for r in rows),
          "top": [{"name": k[:80], "device_us": us, "count": c}
                  for us, k, c in rows[:10] if us > 0]})


def main() -> None:
    kind = phase_device()
    max_err = phase_check()
    launches = phase_main_path()
    at_eval = phase_timings(launches)
    phase_eval_wall()
    emit({"kernels": [
        {**META[op], "launches": launches[op], "max_abs_err": max_err[op],
         "ms": at_eval[op]["kernel_ms"], "plain_ms": at_eval[op]["plain_ms"],
         "bound_ms": at_eval[op]["bound_ms"], "bound_by": at_eval[op]["bound_by"],
         "library_ms": None}
        for op in ("kl", "bce")
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
