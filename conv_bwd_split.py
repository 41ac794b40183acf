"""Splits the time of K4's backward (``conv4x4s2_swish_bwd``) on one NVIDIA
card, and measures the two costs its design answers to.

    python3 conv_bwd_split.py

1. Builds of ``mmvae_torch/ops/csrc/conv_s2.cu`` with one part of the
   partial-sum kernel's tile loop compiled but never run (``no_product1``,
   ``no_product2``: the product skipped; ``no_g``: g not read, constants in
   its place; ``empty``: no tile at all, the launches, the set-up and the
   block's sums alone), each timed at CelebA's train shape (64, 64, 64, 3)
   with the plan the wrapper picks: both launches replayed in a CUDA graph
   (median of 15 replays of 20 calls) and each kernel's device time from
   the profiler. The differences to ``full`` are what each part costs.
2. ``mma.sync.m16n8k8`` in TF32 with 1 to 8 independent accumulator chains
   a warp at 16 warps an SM: the wait of a dependent product, and the
   rate the chains reach.
3. Splitting an f32 into TF32 hi and lo by ``cvt.rna.tf32.f32`` and by
   integer rounding: splits a nanosecond an SM.

Prints one JSON line each and writes them to
``chiprun_out/conv_bwd_split.jsonl``. Exits non-zero without a card.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
from pathlib import Path

import torch

import chip_smoke as cs
from mmvae_torch.ops import kernels as K

SHAPE = (64, 64, 64, 3)
P1 = "      // Product 1: B of n-tile e (k x pixel)"
S = "      // S at (o0, o0 + 8) x pixels"
P2 = "      // Product 2: B of n-tile e = patch"
P2_END = ("          for (int nt = 0; nt < KS; ++nt) "
          "mma_tf32(acc[nt], term == 0 ? s_lo[e] : s_hi[e], b[nt]);\n        }\n      }\n")
G = ("        gv[0][i] = ok ? __ldg(gp + i * sw) : 0.0f;\n"
     "        gv[1][i] = ok ? __ldg(gp + 8 * so + i * sw) : 0.0f;\n")
LOOP = "  for (; t < tiles; t += gridDim.x) {"
PRE = "      float pre[3][2][4] = {};\n"
SKIP = "      if (tiles < 0) {\n"

BENCH = r'''
#include <cuda_runtime.h>
__global__ void mma_chains(float* out, int iters, int chains) {
  unsigned a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(1.0f + threadIdx.x * 1e-3f + i);
  b[0] = a[1];
  b[1] = a[2];
  float d[8][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      if (c < chains) {
        asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
            "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
            : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
      }
    }
  }
  float s = 0.0f;
  for (int c = 0; c < 8; ++c) s += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
__global__ void splits(float* out, int iters, int integer) {
  float v[8];
  for (int c = 0; c < 8; ++c) v[c] = threadIdx.x * 1.1e-3f + c * 0.37f;
  unsigned acc = 0;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      unsigned hi, lo;
      if (integer) {
        hi = (__float_as_uint(v[c]) + 0x1000u) & 0xffffe000u;
        lo = (__float_as_uint(v[c] - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;
      } else {
        asm volatile("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(v[c]));
        asm volatile("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(v[c] - __uint_as_float(hi)));
      }
      acc += hi ^ lo;
      v[c] = __uint_as_float(lo) + v[c];
    }
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = v[0] + acc;
}
extern "C" int bench(float* out, int which, int blocks, int threads, int iters, int arg) {
  if (which == 0) mma_chains<<<blocks, threads>>>(out, iters, arg);
  else splits<<<blocks, threads>>>(out, iters, arg);
  return static_cast<int>(cudaGetLastError());
}
'''


def variant(src: str, name: str) -> str:
    """``src`` with one part of the tile loop compiled but never run."""
    for needle in (P1, S, P2, P2_END, G, LOOP, PRE):
        if src.count(needle) != 1:
            raise SystemExit(f"conv_bwd_split: the source no longer has {needle!r}")
    if name == "no_product1":
        i, j = src.index(P1), src.index(S)
        return src[:i] + PRE + SKIP + src[i:j].replace(PRE, "") + "      }\n" + src[j:]
    if name == "no_product2":
        i, j = src.index(P2), src.index(P2_END) + len(P2_END)
        return src[:i] + SKIP + src[i:j] + "      }\n" + src[j:]
    if name == "no_g":
        return src.replace(G, "        gv[0][i] = ok ? 1.0f : 0.0f;\n"
                              "        gv[1][i] = ok ? 0.5f : 0.0f;\n")
    if name == "empty":
        return src.replace(LOOP, "  for (; t < tiles && tiles < 0; t += gridDim.x) {")
    return src


def build(out: Path, sources: dict[str, str]) -> None:
    """``nvcc`` of each source into ``out``, started together."""
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        (out / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [K._nvcc(), *K.NVCC_FLAGS, "-o", str(out / f"{name}.so"), str(out / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"conv_bwd_split: nvcc {name} failed:\n{err}")


def load_conv(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in K._SIGNATURES["conv_s2"].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.conv_s2_error_string.argtypes = [ctypes.c_int]
    lib.conv_s2_error_string.restype = ctypes.c_char_p
    return lib


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("conv_bwd_split: torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = K.BUILD_DIR / "conv_bwd_split"
    src = K.SOURCES["conv_s2"].read_text()
    names = ("full", "no_product1", "no_product2", "no_g", "empty")
    build(out, {**{n: variant(src, n) for n in names}, "bench": BENCH})
    lines = []

    def emit(obj):
        lines.append(obj)
        print(json.dumps(obj), flush=True)

    gen = torch.Generator(device="cuda").manual_seed(1)
    args = cs.inputs("conv_bwd", SHAPE, gen)
    plan = K.conv_bwd_plan(*SHAPE, torch.cuda.get_device_properties(0).multi_processor_count)
    for name in names:
        K._libs["conv_s2"] = load_conv(out / f"{name}.so")
        def call():
            return K.conv4x4s2_swish_grad_kernel(*args, plan=plan)
        call()
        torch.cuda.synchronize()
        prof = cs.profile_summary(lambda: [call() for _ in range(20)])
        emit({"part": name, "shape": list(SHAPE), "plan": plan._asdict(),
              "both_launches_us": 1e3 * cs.device_ms(call),
              "kernel_us": {re.search(r"conv_s2_bwd_\w+", k["name"]).group(0):
                            k["device_us"] / k["count"]
                            for k in prof["port_kernels"] if k["count"]}})
    K._libs.pop("conv_s2")

    lib = ctypes.CDLL(str(out / "bench.so"))
    lib.bench.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 5
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, threads, iters = 2 * sms, 256, 4096
    buf = torch.empty(blocks * threads, device="cuda")

    def timed(which, arg):
        lib.bench(buf.data_ptr(), which, blocks, threads, 64, arg)
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        rc = lib.bench(buf.data_ptr(), which, blocks, threads, iters, arg)
        end.record()
        end.synchronize()
        if rc:
            raise SystemExit(f"conv_bwd_split: bench launch failed ({rc})")
        return start.elapsed_time(end)

    for chains in (1, 2, 4, 8):
        ms = timed(0, chains)
        warps = blocks * threads // 32
        emit({"part": "mma_tf32_chains", "chains": chains, "warps_per_sm": warps // sms,
              "ms": ms, "tflops": warps * iters * chains * 2 * 16 * 8 * 8 / (ms * 1e-3) / 1e12,
              "ns_per_dependent_mma": 1e6 * ms / iters})
    for integer in (0, 1):
        ms = timed(1, integer)
        emit({"part": "tf32_split", "by": "integer rounding" if integer else "cvt.rna.tf32.f32",
              "ms": ms, "splits_per_ns_per_sm": blocks * threads * iters * 8 / (ms * 1e6) / sms})
    path = Path(cs.ROOT) / "chiprun_out" / "conv_bwd_split.jsonl"
    path.parent.mkdir(exist_ok=True)
    path.write_text("".join(json.dumps(line) + "\n" for line in lines))


if __name__ == "__main__":
    main()
