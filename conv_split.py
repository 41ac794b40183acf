"""Splits the time of K4 into staging, compute and stores, on one NVIDIA
card: the single-pass kernel of commit 5583475 (a block per image band,
one output pixel a thread) and the tiled kernel of
``mmvae_torch/ops/csrc/conv_s2.cu`` (a warp per 32-pixel row chunk).

    python3 conv_split.py [--source PATH]

``--source`` is the single-pass kernel's ``conv_s2.cu`` (default: the
copy a ``git archive 5583475`` unpacked into ``.stage/parent/`` holds).
The script writes edited copies of both sources beside the build, builds
them with ``nvcc`` (one each, started together) and times each, as
``chip_smoke.py`` times a kernel, at the CelebA eval shape (64, 64, 64,
3) f32 and the probe's (256, 64, 64, 3) bf16. Single-pass variants:

- ``today``: the source as it is;
- ``staging_conflict_free``: each thread writes consecutive ``[tap][c][o]``
  addresses of the staged weights and reads the source in that order;
- ``no_stores``: the 32 stores a pixel are gone; the swish outputs are
  summed, and the sum is stored only when it equals 1e30 times a runtime
  argument, which it never does. The condition reads the sum, so the
  compute stays (a condition on the argument alone lets the compiler
  drop the whole loop);
- ``stage_only``: neither compute nor stores, staging and launch only,
  and ``stage_only_conflict_free`` the same with the staging above;
- ``two_px``: two output pixels a thread (bands of twice the rows), so
  each float4 of weights read from shared memory feeds 8 FMAs, not 4.

Tiled variants, at the wrapper's plan:

- ``tiled``: the source as it is;
- ``tiled_empty``: returns at once (the launch of this grid);
- ``tiled_no_fma``: no tap loop (staging, swish and stores);
- ``tiled_no_fma_no_stores``: staging and swish, the stores kept only
  under a condition on their values that never holds;
- ``tiled_no_swish``: bias only, no swish.

A probe then reads shared memory in float4s (``ld.volatile.shared.v4``,
which neither the compiler nor ptxas may drop, merge or narrow) from every warp of
one block of 16 warps an SM, 8 independent loads in flight a lane, and gives
the SM's cycles per warp-wide LDS.128 (``clock64``) when the 32 lanes read
1, 4, 8 or 32 distinct float4s: the broadcast K4's weights take (1), and
the patterns of a tile of 8 lanes x 4 channel groups (4 and 8).

It prints one JSON line per (variant, shape), with ``-Xptxas -v``'s lines,
and one per probe pattern. The variants that store are held against the
plain version. Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import torch

import chip_smoke as cs
from mmvae_torch.ops import kernels as K

ROOT = Path(__file__).resolve().parent
OUT = K.BUILD_DIR / "conv_split"
SHAPES = {"celeba_eval": (64, 64, 64, 3, torch.float32),
          "probe": (256, 64, 64, 3, torch.bfloat16)}

STAGING = """  for (int i = threadIdx.x; i < kCout * C * kTaps; i += blockDim.x) {
    const int o = i / (C * kTaps);
    const int c = (i / kTaps) % C;
    const int tap = i % kTaps;
    s_w[(tap * C + c) * kCout + o] = to_f32(w[i]);
  }"""
STAGING_CONFLICT_FREE = """  for (int i = threadIdx.x; i < kCout * C * kTaps; i += blockDim.x) {
    const int o = i % kCout;
    const int c = (i / kCout) % C;
    const int tap = i / (kCout * C);
    s_w[i] = to_f32(w[(o * C + c) * kTaps + tap]);
  }"""
STORES = """#pragma unroll
    for (int o = 0; o < kCout; ++o) {
      const float v = acc[o] + s_b[o];
      yn[o * plane + pix] = from_f32<T>(v * (1.0f / (1.0f + expf(-v))));
    }"""
NO_STORES = """    float sum = 0.0f;
#pragma unroll
    for (int o = 0; o < kCout; ++o) {
      const float v = acc[o] + s_b[o];
      sum += v * (1.0f / (1.0f + expf(-v)));
    }
    if (sum == 1e30f * pad_left) yn[pix] = from_f32<T>(sum);"""
COMPUTE_START = "  const size_t plane"
COMPUTE_END = "\n}\n\nsize_t smem_bytes"
STAGE_ONLY = """  if (pad_left == 12345) {
    y[blockIdx.x * blockDim.x + threadIdx.x] =
        from_f32<T>(s_x[threadIdx.x] + s_w[threadIdx.x] + s_b[threadIdx.x % kCout]);
  }"""
TWO_PX = """  const size_t plane = static_cast<size_t>(h_out) * w_out;
  T* yn = y + static_cast<size_t>(n) * kCout * plane;
  const int n_pix = rows * w_out;
  for (int p0 = threadIdx.x; p0 < n_pix; p0 += 2 * blockDim.x) {
    const bool has1 = p0 + static_cast<int>(blockDim.x) < n_pix;
    const int p1 = has1 ? p0 + static_cast<int>(blockDim.x) : p0;
    const int r0 = p0 / w_out, ox0 = p0 % w_out;
    const int r1 = p1 / w_out, ox1 = p1 % w_out;
    float acc0[kCout], acc1[kCout];
#pragma unroll
    for (int o = 0; o < kCout; ++o) {
      acc0[o] = 0.0f;
      acc1[o] = 0.0f;
    }
#pragma unroll 1
    for (int ky = 0; ky < 4; ++ky) {
      const float* xrow0 = s_x + ((2 * r0 + ky) * wp + 2 * ox0) * C;
      const float* xrow1 = s_x + ((2 * r1 + ky) * wp + 2 * ox1) * C;
#pragma unroll 1
      for (int kx = 0; kx < 4; ++kx) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float xv0 = xrow0[kx * C + c];
          const float xv1 = xrow1[kx * C + c];
          const float4* w4 =
              reinterpret_cast<const float4*>(s_w + ((ky * 4 + kx) * C + c) * kCout);
#pragma unroll
          for (int q = 0; q < kCout / 4; ++q) {
            const float4 wv = w4[q];
            acc0[4 * q + 0] = fmaf(xv0, wv.x, acc0[4 * q + 0]);
            acc0[4 * q + 1] = fmaf(xv0, wv.y, acc0[4 * q + 1]);
            acc0[4 * q + 2] = fmaf(xv0, wv.z, acc0[4 * q + 2]);
            acc0[4 * q + 3] = fmaf(xv0, wv.w, acc0[4 * q + 3]);
            acc1[4 * q + 0] = fmaf(xv1, wv.x, acc1[4 * q + 0]);
            acc1[4 * q + 1] = fmaf(xv1, wv.y, acc1[4 * q + 1]);
            acc1[4 * q + 2] = fmaf(xv1, wv.z, acc1[4 * q + 2]);
            acc1[4 * q + 3] = fmaf(xv1, wv.w, acc1[4 * q + 3]);
          }
        }
      }
    }
    const size_t pix0 = static_cast<size_t>(oy0 + r0) * w_out + ox0;
    const size_t pix1 = static_cast<size_t>(oy0 + r1) * w_out + ox1;
#pragma unroll
    for (int o = 0; o < kCout; ++o) {
      const float v0 = acc0[o] + s_b[o];
      yn[o * plane + pix0] = from_f32<T>(v0 * (1.0f / (1.0f + expf(-v0))));
      if (has1) {
        const float v1 = acc1[o] + s_b[o];
        yn[o * plane + pix1] = from_f32<T>(v1 * (1.0f / (1.0f + expf(-v1))));
      }
    }
  }"""
LDS_PROBE = r"""
#include <cuda_runtime.h>
__global__ void lds_probe_kernel(int* out, long long* cycles, int iters, int distinct) {
  __shared__ __align__(16) int s[4096];
  for (int i = threadIdx.x; i < 4096; i += blockDim.x) s[i] = i * 7;
  __syncthreads();
  const int lane = threadIdx.x % 32;
  // Lanes that share a float4: 32 / distinct of them, neighbours.
  const int off = 4 * (lane / (32 / distinct));
  int a0 = 0, a1 = 0, a2 = 0, a3 = 0;
  const unsigned base = static_cast<unsigned>(__cvta_generic_to_shared(s + off));
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
    // ld.volatile: neither the compiler nor ptxas may drop, merge or
    // narrow the loads. Two XORs a load keep the loop bound by the loads.
    const unsigned a = base + 4 * ((i * 512) & 2047);
    int4 v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      asm volatile("ld.volatile.shared.v4.s32 {%0, %1, %2, %3}, [%4];"
                   : "=r"(v[k].x), "=r"(v[k].y), "=r"(v[k].z), "=r"(v[k].w)
                   : "r"(a + 1024 * k));
    }
    a0 ^= v[0].x ^ v[0].w ^ v[1].x ^ v[1].w;
    a1 ^= v[2].x ^ v[2].w ^ v[3].x ^ v[3].w;
    a2 ^= v[4].x ^ v[4].w ^ v[5].x ^ v[5].w;
    a3 ^= v[6].x ^ v[6].w ^ v[7].x ^ v[7].w;
  }
  __syncthreads();  // every warp of the block has finished
  const long long t1 = clock64();
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
  out[blockIdx.x * blockDim.x + threadIdx.x] = a0 ^ a1 ^ a2 ^ a3;
}
extern "C" int lds_probe(int* out, long long* cycles, int blocks, int threads, int iters,
                         int distinct, cudaStream_t stream) {
  lds_probe_kernel<<<blocks, threads, 0, stream>>>(out, cycles, iters, distinct);
  return static_cast<int>(cudaGetLastError());
}
"""
BAND = "int band = std::min({std::max(kThreads / w_out, 1), kMaxBandRows, h_out});"
BAND_TWO_PX = "int band = std::min({std::max(2 * kThreads / w_out, 1), 2 * kMaxBandRows, h_out});"


def _replace(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise SystemExit(f"conv_split: the source does not hold the expected text:\n{old}")
    return src.replace(old, new)


def _compute(src: str, new: str) -> str:
    start = src.index(COMPUTE_START)
    end = src.index(COMPUTE_END)
    return src[:start] + new + src[end:]


TILED_TOP = "  constexpr int kStride = row_floats(C);\n  constexpr int kW = kTaps * C * kCout;"
TILED_FMA_START = "    // The input rows stay rolled"
TILED_FMA_END = "    const int ox = chunk * kTileW"
TILED_STORE = "      if (valid > 0) store4(yo + o * plane, r, valid, vec_out != 0);"
TILED_SWISH = "      for (int p = 0; p < kPx; ++p) r[p] = swish(acc[p][o] + b);"


def tiled_variants(src: str) -> dict[str, str]:
    start, end = src.index(TILED_FMA_START), src.index(TILED_FMA_END)
    no_fma = src[:start] + "    acc[0][0] = buf[lane] + s_w[lane];\n" + src[end:]
    return {
        "tiled": src,
        "tiled_empty": _replace(src, TILED_TOP, "  if (h > 0) return;\n" + TILED_TOP),
        "tiled_no_fma": no_fma,
        "tiled_no_fma_no_stores": _replace(no_fma, TILED_STORE, TILED_STORE.replace(
            "if (valid > 0)", "if (r[0] + r[1] + r[2] + r[3] == 1e30f * valid)")),
        "tiled_no_swish": _replace(src, TILED_SWISH, TILED_SWISH.replace(
            "swish(acc[p][o] + b)", "acc[p][o] + b")),
    }


def variants(src: str) -> dict[str, str]:
    cf = _replace(src, STAGING, STAGING_CONFLICT_FREE)
    two = _replace(_compute(src, TWO_PX), BAND, BAND_TWO_PX)
    return {
        "today": src,
        "staging_conflict_free": cf,
        "no_stores": _replace(src, STORES, NO_STORES),
        "stage_only": _compute(src, STAGE_ONLY),
        "stage_only_conflict_free": _compute(cf, STAGE_ONLY),
        "two_px": two,
    }


def build(sources: dict[str, str]) -> dict[str, tuple[Path, list[str]]]:
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        cu = OUT / f"{name}.cu"
        cu.write_text(text)
        so = OUT / f"{name}.so"
        procs[name] = (so, subprocess.Popen(
            [K._nvcc(), *K.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    built = {}
    for name, (so, proc) in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"conv_split: nvcc {name} failed:\n{err}")
        built[name] = (so, [line.strip() for line in (out + err).splitlines()
                            if "registers" in line or "spill" in line])
    return built


def caller(so: Path, tiled: bool):
    lib = ctypes.CDLL(str(so))
    fn = lib.conv4x4s2_swish
    # x, w, b, y, batch, h, w, c, dtype[, the plan's warps, blocks, smem],
    # stream: the C entry of each kernel.
    fn.argtypes = K._SIGNATURES["conv_s2"]["conv4x4s2_swish"] if tiled else (
        [K._ptr] * 4 + [K._i32] * 5 + [K._ptr])
    fn.restype = K._i32
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def call(x, w, b):
        n, h, wd, c = x.shape
        y = torch.empty((n, K.CONV_OUT, -(-h // 2), -(-wd // 2)), dtype=x.dtype, device=x.device)
        plan = tuple(K.conv_plan(n, h, wd, c, sms)) if tiled else ()
        rc = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), n, h, wd, c,
                0 if x.dtype == torch.float32 else 1, *plan,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{so.stem}: launch failed with code {rc}")
        return y

    return call


def lds_probe(so: Path, smi: str) -> list[dict]:
    """Cycles an SM spends per warp-wide LDS.128, by distinct float4s a warp."""
    lib = ctypes.CDLL(str(so))
    lib.lds_probe.argtypes = [K._ptr, K._ptr, K._i32, K._i32, K._i32, K._i32, K._ptr]
    lib.lds_probe.restype = K._i32
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    threads, iters, loads = 512, 4096, 8
    out = torch.empty(sms * threads, dtype=torch.int32, device="cuda")
    cycles = torch.empty(sms, dtype=torch.int64, device="cuda")
    lines = []
    for distinct in (1, 4, 8, 32):
        for _ in range(2):  # the first launch warms up
            rc = lib.lds_probe(out.data_ptr(), cycles.data_ptr(), sms, threads, iters, distinct,
                               torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"lds_probe: launch failed with code {rc}")
        torch.cuda.synchronize()
        per_sm = cycles.double().median().item()
        lines.append({"probe": "lds128", "distinct_float4s_a_warp": distinct, "nvidia_smi": smi,
                      "warps_an_sm": threads // 32, "cycles_median": per_sm,
                      "cycles_per_warp_lds128": per_sm / (threads // 32 * iters * loads)})
    return lines


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--source", type=Path,
                        default=ROOT / ".stage/parent/mmvae_torch/ops/csrc/conv_s2.cu")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("conv_split: torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    tiled = tiled_variants(K.SOURCES["conv_s2"].read_text())
    built = build({**variants(args.source.read_text()), **tiled, "lds_probe": LDS_PROBE})
    probe_so, probe_ptxas = built.pop("lds_probe")
    gen = torch.Generator(device="cuda").manual_seed(1)
    for label, shape in SHAPES.items():
        xs = cs.inputs("conv", shape, gen)
        want = K.conv4x4s2_swish_torch(*xs)
        rtol, atol = cs.tolerance("conv", shape)
        copies = cs.cold_copies(xs)
        for name, (so, ptxas) in built.items():
            call = caller(so, name in tiled)
            got = call(*xs)
            torch.cuda.synchronize()
            stores = name in ("today", "staging_conflict_free", "two_px", "tiled")
            if stores:
                torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
            line = {"variant": name, "label": label, **cs.describe("conv", shape),
                    "nvidia_smi": smi, "checked": stores,
                    "ms": cs.device_ms(lambda: call(*xs)),
                    "cold_ms": cs.cold_ms(lambda a: (lambda: call(*a)), xs, copies),
                    "bound_ms": cs.bound("conv", xs)[0], "ptxas": ptxas}
            print(json.dumps(line), flush=True)
    for line in lds_probe(probe_so, smi):
        print(json.dumps({**line, "ptxas": probe_ptxas}), flush=True)


if __name__ == "__main__":
    main()
