// 4x4 stride-2 SAME conv + bias + swish, NHWC in, NCHW out, for Hopper
// (sm_90a).
//
// conv4x4s2_swish replaces tools/pallas_conv_probe.py:pallas_conv0 (the
// kernel through its pallas_call): for an image x (B, H, W, C) in NHWC, a
// weight w (F, C, 4, 4) in PyTorch's OIHW and a bias b (F,),
//     y[n, o, i, j] = swish(b[o] + sum_{ky,kx,c} x[n, 2i+ky-pt, 2j+kx-pl, c]
//                                                * w[o, c, ky, kx]),
// with XLA's SAME padding: per dim the total pad is
// max((ceil(d/2) - 1) * 2 + 4 - d, 0), and the low side (pt, pl) gets half
// of it, rounded down, which is 1 at every size. Out of range input reads
// as 0. y is (B, F, ceil(H/2), ceil(W/2)), NCHW, so the next stage (a
// cuDNN conv) takes it as it is. It is the first stage of the CelebA image
// encoder: F = 32, or under tensor parallelism a rank's 32 / tp channels of
// the column-parallel stage (F = 16 at tp = 2, 8 at tp = 4). F is fixed when
// the source is compiled (CONV_F), one library for each F; the numbers
// below are F = 32's, and the designs at 16 and 8 are said where they
// differ.
//
// The TPU kernel padded the input and pre-split it into the four stride
// parities with XLA, so that every tap read a contiguous window (C = 3
// lanes pad to 128 in VMEM, and strided loads were out), then accumulated
// 16 taps x 3 channels of broadcast FMAs per block of 8 images. Here
// nothing is pre-split: x is read once, straight from the batch.
//
// What bounds it: at the CelebA eval shape (64, 64, 64, 3) f32 it reads
// 3.15 MB and writes 8.39 MB, 3.4 us at 3.35 TB/s; its 48 FMAs and the
// swish per output (210 MFLOP) take 3.1 us at 67 TFLOP/s of f32 on the CUDA
// cores, and the swish's exp and IEEE divide add about a third to the
// instructions. So the kernel has to overlap its loads, FMAs and stores.
//
// Design. A unit of work is one output row of one image, 32 output pixels
// wide (a chunk of the row), all F channels: one warp. Its input is 4 rows
// of 66 columns (2 * 32 + 2, the SAME pad and the image edges zero-filled),
// staged f32 in the warp's own slice of shared memory as NHWC rows, each
// shifted by `lead` floats so that the image's 16-byte chunks land on
// 16-byte boundaries. Lane (t, g) = (lane % 8, lane / 8) owns 4 adjacent
// output pixels (4t..4t+3) x 8 channels (8g..8g+7): 32 accumulators. Per
// input row a lane reads its window of 10 columns x C as float4s (the 4
// pixels' 4 taps), and per (tap, c) the 8 weights of its channels as two
// float4s: 32 FMAs per weight pair, 12 FMAs per shared-memory load. At F =
// 16 and 8 the warp keeps its 32 pixels and every lane stays busy with
// fewer channels: lane (t, g) owns F / 4 channels (4 from one float4, or 2
// from one float2), so the staging, the loads of x and the stores are
// F = 32's, and a lane does F / 2 FMAs per weight load.
// A block of `warps` warps stages the weights once ([tap][c][o], each
// thread writing consecutive addresses) and then walks units with the
// grid's stride, so the grid is sized to the card (a few blocks an SM) and
// not to the work. Every global load of a unit is issued before the first
// is used, and a unit's loads are issued into registers before the previous
// unit is computed: one load latency per warp, not one per element.
// Bias and swish are fused into the one store; a warp's stores of one
// channel cover the 128-byte run of its 32 pixels (float4 for f32, 8 bytes
// for bf16, where the row length allows). Accumulation is f32 FMAs in a
// fixed order for f32 and bf16 inputs, no atomics: two calls give the same
// bits. The output is written in the weights' type (round to nearest even
// for bf16): x, w, b and y all f32 or all bf16, or a bf16 x (a
// data_dtype="bfloat16" batch) with f32 w, b and y, its loads upcast as
// they are staged. All bf16 (a bf16 model's stage 0), the epilogue rounds
// where Flax's bf16 conv, bias add and swish round: the conv sum to bf16,
// then the bias add, the sigmoid and the product. No fast-math: expf tracks the plain PyTorch version to
// rounding.
//
// The backward, conv4x4s2_swish_bwd: the gradient of the weight and the
// bias (not of x) given the upstream gradient g (B, 32, ceil(H/2),
// ceil(W/2)) of y, in the forward's types: all f32, all bf16 (a bf16
// model's stage 0: w, b, g, dw and db bf16, dw and db rounded once from
// f32 sums, as XLA's gradient of a bf16 conv gives them in the weight's
// type), or a bf16 image with the rest f32 (a data_dtype="bfloat16"
// batch). Every operand is upcast on load and everything is computed in
// f32. With pre = b[o] + the conv sum,
//     dw[o, c, ky, kx] = sum_{n,i,j} g[n,o,i,j] * swish'(pre[n,o,i,j])
//                                     * x[n, 2i+ky-pt, 2j+kx-pl, c],
//     db[o] = sum_{n,i,j} g[n,o,i,j] * swish'(pre[n,o,i,j]),
// swish'(u) = s(u) * (1 + u * (1 - s(u))), s the logistic sigmoid; the same
// SAME pad (out of range reads 0). The TPU side has no Pallas VJP for K4:
// the JAX package leaves stage 0's gradient to XLA (mmvae_tpu/models/
// experts.py:220-229; tools/pallas_conv_probe.py:xla_conv0 is its form).
// pre is recomputed from x, w and b rather than written by the forward, so
// the forward stays as it is.
//
// What bounds it: at the CelebA train shape (64, 64, 64, 3) it reads x
// (3.15 MB) and g (8.39 MB), 3.4 us at 3.35 TB/s. Its two products, pre =
// patches . W^T and dW = S^T . patches, are 2 x 100.7 M multiply-adds: in
// f32 on the CUDA cores 6.0-6.3 us at 67 TFLOP/s; here in 3xTF32 on the
// tensor cores, 3 products each, 1.21 GFLOP, 2.4 us at 495 TFLOP/s of dense
// TF32. So the bytes bound it, at 3.4 us.
//
// Design. Both products run on the tensor cores as mma.sync m16n8k8 in
// 3xTF32: each operand split as hi = tf32(a), lo = tf32(a - hi) (rounded
// to nearest by integer operations) and each product taken as lo . hi' +
// hi . lo' + hi . hi', which keeps f32's precision (TF32 alone keeps about
// three digits). A bf16 operand (the image, or the weights) is exact in
// TF32: its lo part is 0, and the products that would read it are not
// taken; S is f32 and keeps its split. A block walks tiles of 32 output
// pixels by TR output rows of one image with the grid's stride. A tile's 2
// TR + 2 input rows are copied raw into shared memory with cp.async while
// the previous tile is computed, then split once into hi and lo planes;
// the weights are staged once a block as the first product's A fragments.
// A warp takes 16 output
// channels and groups of 16 pixels, as two n-tiles of 8 (the even pixels,
// the odd ones, so that at C = 3 its loads fall on distinct banks). At F =
// 16 one m-tile holds every channel, so each warp takes its own groups of
// pixels; F = 8 is below mma.sync's m16, and its one m-tile is padded: rows
// 8-15 take zero weights and a zero g, so their S is 0, and they are not
// stored. Per
// group: pre^T = W . patches^T into three accumulators (one per product of
// the split); S = g swish'(pre + b) on the accumulator fragments, g read
// from global memory through its strides; then S's fragments, taken as the
// A fragments of dW += S . patches over the pixels in the order 0, 2, 4,
// 6, 1, 3, 5, 7, go straight into the second product, so S never leaves
// the registers. dW and db are summed in registers over the tiles, then a
// block adds its warps' sums in a fixed order into its row of a workspace,
// and a second launch adds the rows in a fixed order (32 chains of every
// 32nd row, then the chains) into dw and db. No atomics: two calls with
// the same plan give the same bits. What holds it at several times its
// bound is latency: a dependent mma.sync waits about 200 cycles, the warp
// can keep only a few independent products in flight at 128 registers a
// thread (16 warps an SM), and the launches and a block's set-up and sums
// cost several microseconds of their own (conv_bwd_split.py splits the
// time).
//
// The input gradient, conv4x4s2_swish_dx: with S = g swish'(pre), pre
// recomputed from x, w and b as the backward above recomputes it,
//     dx[n, h, w, c] = sum_{o, ky, kx} S[n, o, i, j] * w[o, c, ky, kx]
// over the output pixels with 2i + ky - 1 = h and 2j + kx - 1 = w (taps
// that fall into the pad add nothing), f32, or all bf16 (x, w, b, g and
// dx; computed in f32, dx rounded once). It is the input half of
// XLA's gradient of stage 0 (tools/pallas_conv_probe.py:xla_conv0); only
// the cycle term's re-encode of a rendered image needs it.
//
// What bounds it: at CUB's train shape (64, 64, 64, 3) it reads x (3.15
// MB) and g (8.39 MB) and writes dx (3.15 MB), 14.68 MB, 4.38 us at 3.35
// TB/s. Its two products, the recompute of pre and T = S W (per output
// pixel the 16 C entries it gives the input), are 2 x 100.7 M
// multiply-adds: here in 3xTF32 on the tensor cores, 1.21 GFLOP, 2.44 us at
// 495 TFLOP/s of dense TF32 (6.0 us in f32 on the CUDA cores). So the bytes
// bound it.
//
// Design, on the backward's route. A block walks tiles of TR output rows
// by 32 output columns of one image with the grid's stride (TR = 8: one
// block an SM); a tile writes dx for its input rows 2 m0 .. 2 m0 + 2 TR - 1
// and columns 2 j0 .. 2 j0 + 63, which read S on the tile's output pixels
// and the ring around them, so S is recomputed for TR + 2 rows of 34
// pixels (its neighbours compute the ring too: no block reads another's
// results, no atomics). The tile's 2 TR + 6 input rows are copied raw with
// cp.async while the previous tile is computed, then split once into TF32
// hi and lo planes; the weights are staged once a block as both products'
// fragments. A warp takes an item of 32 S pixels, a row of S (the ring's
// columns are one more item where the tile has them): product 1, pre =
// patches . W^T with the pixels as the M side (two m-tiles, F / 8 n-tiles
// of output channels); S = g swish'(pre + b) on the accumulator fragments, g
// read through its strides; product 2, T^T = W^T . S^T, whose B fragments
// are product 1's accumulator fragments when a k step takes the channels
// in the order 0, 2, 4, 6, 1, 3, 5, 7, so S never leaves the registers
// (F / 8 k steps: at F = 8 one k8 step of m16n8k8). T goes to shared
// memory; the ring's rows need one tap row of it each,
// which lies in one m-tile of product 2. Then a thread an input pixel sums
// its 2 x 2 covering entries of T in a fixed order: two launches give the
// same bits, whatever the plan. What holds it at several times its bound
// is, as in the backward, the wait of dependent mma.sync products and the
// block's phases (copy and split, products, fold) following each other
// (conv_dx_split.py splits the time; PERF.md has the numbers).
//
// C interface (bound with ctypes): conv4x4s2_swish launches on `stream`
// with the plan it is given (warps a block, blocks, dynamic shared memory),
// does not synchronise, and returns cudaGetLastError() of its launch (or
// cudaErrorInvalidValue for arguments it does not take);
// conv4x4s2_swish_bwd likewise, for its two launches, and
// conv4x4s2_swish_dx for its one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

// The output channels F, fixed when a library is compiled (-DCONV_F=16 or
// -DCONV_F=8; 32 by default), one library each: a rank's share of stage 0's
// 32 channels under tensor parallelism (32 / tp, tp = 1, 2 or 4).
#ifndef CONV_F
#define CONV_F 32
#endif
static_assert(CONV_F == 32 || CONV_F == 16 || CONV_F == 8, "K4 takes F = 32, 16 or 8");
constexpr int kCout = CONV_F;
constexpr int kTaps = 16;
constexpr int kPx = 4;                     // output pixels a lane
constexpr int kCh = kCout / 4;             // output channels a lane (8, 4 or 2)
constexpr int kTileW = 8 * kPx;            // output pixels a warp
constexpr int kTileCols = 2 * kTileW + 2;  // input columns a unit reads
constexpr int kMaxWarps = 8;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;

// Floats before column -1 of a staged row: C + lead is a multiple of 4, so
// the image's column 0 starts a float4.
__host__ __device__ constexpr int lead(int c) { return (4 - c % 4) % 4; }
// Floats of one staged input row.
__host__ __device__ constexpr int row_floats(int c) {
  return (lead(c) + kTileCols * c + 3) / 4 * 4;
}
size_t smem_of(int c, int warps) {
  return sizeof(float) * (static_cast<size_t>(kTaps) * c * kCout + kCout +
                          static_cast<size_t>(warps) * 4 * row_floats(c));
}

// A chunk of staged input: 4 elements where rows allow 16-byte (f32) or
// 8-byte (bf16) loads, else 1. Raw is what a load gives; store converts to
// f32 (a bf16 is the high half of its f32).
template <typename T, bool VEC>
struct Chunk;
template <>
struct Chunk<float, true> {
  static constexpr int kElems = 4;
  using Raw = float4;
  __device__ static Raw load(const float* p) { return __ldg(reinterpret_cast<const float4*>(p)); }
  __device__ static Raw zero() { return make_float4(0.0f, 0.0f, 0.0f, 0.0f); }
  __device__ static void store(float* s, Raw v) { *reinterpret_cast<float4*>(s) = v; }
};
template <>
struct Chunk<float, false> {
  static constexpr int kElems = 1;
  using Raw = float;
  __device__ static Raw load(const float* p) { return __ldg(p); }
  __device__ static Raw zero() { return 0.0f; }
  __device__ static void store(float* s, Raw v) { *s = v; }
};
template <>
struct Chunk<__nv_bfloat16, true> {
  static constexpr int kElems = 4;
  using Raw = uint2;
  __device__ static Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint2*>(p));
  }
  __device__ static Raw zero() { return make_uint2(0u, 0u); }
  __device__ static void store(float* s, Raw v) {
    *reinterpret_cast<float4*>(s) =
        make_float4(__uint_as_float(v.x << 16), __uint_as_float(v.x & 0xffff0000u),
                    __uint_as_float(v.y << 16), __uint_as_float(v.y & 0xffff0000u));
  }
};
template <>
struct Chunk<__nv_bfloat16, false> {
  static constexpr int kElems = 1;
  using Raw = unsigned short;
  __device__ static Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  __device__ static Raw zero() { return 0; }
  __device__ static void store(float* s, Raw v) {
    *s = __uint_as_float(static_cast<unsigned>(v) << 16);
  }
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
// One element through the read-only path, as f32 (a bf16 is the high half
// of its f32).
__device__ __forceinline__ float ld_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld_f32(const __nv_bfloat16* p) {
  return __uint_as_float(static_cast<unsigned>(__ldg(reinterpret_cast<const unsigned short*>(p)))
                         << 16);
}
// An f32 in T, rounded to nearest even for bf16.
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float swish(float v) { return v * (1.0f / (1.0f + expf(-v))); }

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}
// The output of one conv sum `acc` with the bias `b` in the weights' type
// TW: in f32, swish(acc + b); in bf16, Flax's order with every op rounded
// to bf16 as XLA rounds it (the conv, then the bias add, the sigmoid and
// the product, the last by the store).
template <typename TW>
__device__ __forceinline__ float epilogue(float acc, float b) {
  if constexpr (std::is_same<TW, float>::value) {
    return swish(acc + b);
  } else {
    const float u = round_bf16(round_bf16(acc) + b);
    return u * round_bf16(1.0f / (1.0f + expf(-u)));
  }
}

// The 4 outputs of a lane for one channel, at `p` (4-aligned when `vec`).
__device__ __forceinline__ void store4(float* p, const float (&r)[kPx], int valid, bool vec) {
  if (vec) {
    if (valid == kPx) *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
    return;
  }
#pragma unroll
  for (int i = 0; i < kPx; ++i) {
    if (i < valid) p[i] = r[i];
  }
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&r)[kPx], int valid,
                                       bool vec) {
  unsigned short h[kPx];
#pragma unroll
  for (int i = 0; i < kPx; ++i) h[i] = __bfloat16_as_ushort(__float2bfloat16(r[i]));
  if (vec) {
    if (valid == kPx) {
      *reinterpret_cast<uint2*>(p) =
          make_uint2(h[0] | (static_cast<unsigned>(h[1]) << 16),
                     h[2] | (static_cast<unsigned>(h[3]) << 16));
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < kPx; ++i) {
    if (i < valid) p[i] = __ushort_as_bfloat16(h[i]);
  }
}

// The kCh weights of a lane's channels at one (tap, c), from 16-byte (kCh =
// 8 or 4) or 8-byte (kCh = 2) aligned shared memory.
__device__ __forceinline__ void load_w(const float* p, float (&v)[kCh]) {
  if constexpr (kCh % 4 == 0) {
#pragma unroll
    for (int q = 0; q < kCh / 4; ++q) {
      const float4 f = reinterpret_cast<const float4*>(p)[q];
      v[4 * q + 0] = f.x;
      v[4 * q + 1] = f.y;
      v[4 * q + 2] = f.z;
      v[4 * q + 3] = f.w;
    }
  } else {
    const float2 f = *reinterpret_cast<const float2*>(p);
    v[0] = f.x;
    v[1] = f.y;
  }
}

template <typename T, int C, bool VEC>
struct Stage {
  using Ck = Chunk<T, VEC>;
  static constexpr int kStride = row_floats(C);
  static constexpr int kPerRow = kStride / Ck::kElems;
  static constexpr int kAll = 4 * kPerRow;
  static constexpr int kPerLane = (kAll + 31) / 32;
  typename Ck::Raw v[kPerLane];

  // Issue every load of the unit's 4 input rows x 66 columns (zero where
  // the pad or the image edge falls).
  __device__ __forceinline__ void load(const T* __restrict__ x, int n, int oy, int chunk, int h,
                                       int wd, int lane) {
    const long long row_len = static_cast<long long>(wd) * C;
    const int g0 = (chunk * 2 * kTileW - 1) * C - lead(C);
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int idx = lane + 32 * k;
      const int r = idx / kPerRow;
      const int g = g0 + (idx - r * kPerRow) * Ck::kElems;
      const int iy = 2 * oy - 1 + r;
      const bool ok = idx < kAll && iy >= 0 && iy < h && g >= 0 && g + Ck::kElems <= row_len;
      v[k] = ok ? Ck::load(x + (static_cast<long long>(n) * h + iy) * row_len + g) : Ck::zero();
    }
  }
  __device__ __forceinline__ void store(float* buf, int lane) const {
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int idx = lane + 32 * k;
      if (idx < kAll) Ck::store(buf + idx * Ck::kElems, v[k]);
    }
  }
};

// T: x's type; TW: the weight's, the bias's and y's.
template <typename T, typename TW, int C, bool VEC>
__global__ void __launch_bounds__(kMaxWarps * 32, 2)
    conv_s2_tiles_kernel(const T* __restrict__ x, const TW* __restrict__ w,
                         const TW* __restrict__ bias, TW* __restrict__ y, int h, int wd,
                         int h_out, int w_out, int n_chunks, int units, int vec_out) {
  constexpr int kStride = row_floats(C);
  constexpr int kW = kTaps * C * kCout;
  constexpr int kBatch = 8;
  extern __shared__ __align__(16) float smem[];
  float* s_w = smem;                 // [tap][c][o]
  float* s_b = s_w + kW;             // [o]
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* buf = s_b + kCout + warp * 4 * kStride;  // [row][lead, col, c]

  const int step = gridDim.x * warps;
  int u = blockIdx.x * warps + warp;
  Stage<T, C, VEC> st;
  if (u < units) {
    const int rest = u / n_chunks;
    st.load(x, rest / h_out, rest % h_out, u % n_chunks, h, wd, lane);
  }
  // The weights, once per block: each thread writes consecutive addresses
  // of [tap][c][o]; a batch's loads are all issued before its stores.
  for (int i0 = 0; i0 < kW; i0 += kBatch * blockDim.x) {
    float v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = i0 + j * blockDim.x + threadIdx.x;
      const int o = i % kCout, c = (i / kCout) % C, tap = i / (kCout * C);
      v[j] = i < kW ? to_f32(w[(o * C + c) * kTaps + tap]) : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = i0 + j * blockDim.x + threadIdx.x;
      if (i < kW) s_w[i] = v[j];
    }
  }
  if (threadIdx.x < kCout) s_b[threadIdx.x] = to_f32(bias[threadIdx.x]);
  __syncthreads();

  const int t = lane % 8;
  const int g = lane / 8;
  const size_t plane = static_cast<size_t>(h_out) * w_out;
  for (; u < units; u += step) {
    __syncwarp();  // the previous unit is no longer read
    st.store(buf, lane);
    __syncwarp();
    const int chunk = u % n_chunks;
    const int rest = u / n_chunks;
    const int oy = rest % h_out;
    const int n = rest / h_out;
    const int next = u + step;
    if (next < units) {
      const int nrest = next / n_chunks;
      st.load(x, nrest / h_out, nrest % h_out, next % n_chunks, h, wd, lane);
    }

    float acc[kPx][kCh];
#pragma unroll
    for (int p = 0; p < kPx; ++p) {
#pragma unroll
      for (int o = 0; o < kCh; ++o) acc[p][o] = 0.0f;
    }
    // The input rows stay rolled: unrolled, the compiler hoists every
    // row's window and weights into registers.
#pragma unroll 1
    for (int ky = 0; ky < 4; ++ky) {
      constexpr int kNV = (lead(C) + 10 * C + 3) / 4;
      float xin[4 * kNV];
      const float4* src = reinterpret_cast<const float4*>(buf + ky * kStride + 8 * C * t);
#pragma unroll
      for (int i = 0; i < kNV; ++i) {
        const float4 v = src[i];
        xin[4 * i + 0] = v.x;
        xin[4 * i + 1] = v.y;
        xin[4 * i + 2] = v.z;
        xin[4 * i + 3] = v.w;
      }
#pragma unroll
      for (int kx = 0; kx < 4; ++kx) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          float wv[kCh];
          load_w(s_w + ((ky * 4 + kx) * C + c) * kCout + kCh * g, wv);
#pragma unroll
          for (int p = 0; p < kPx; ++p) {
            const float xv = xin[lead(C) + (2 * p + kx) * C + c];
#pragma unroll
            for (int o = 0; o < kCh; ++o) acc[p][o] = fmaf(xv, wv[o], acc[p][o]);
          }
        }
      }
    }

    const int ox = chunk * kTileW + kPx * t;
    const int valid = min(kPx, w_out - ox);
    TW* yo = y + (static_cast<size_t>(n) * kCout + kCh * g) * plane +
            static_cast<size_t>(oy) * w_out + ox;
#pragma unroll
    for (int o = 0; o < kCh; ++o) {
      const float b = s_b[kCh * g + o];
      float r[kPx];
#pragma unroll
      for (int p = 0; p < kPx; ++p) r[p] = epilogue<TW>(acc[p][o], b);
      if (valid > 0) store4(yo + o * plane, r, valid, vec_out != 0);
    }
  }
}

template <typename T, typename TW, int C, bool VEC>
cudaError_t set_smem(int smem) {
  if (static_cast<size_t>(smem) <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(conv_s2_tiles_kernel<T, TW, C, VEC>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <typename T, typename TW, int C>
int launch(const void* x, const void* w, const void* b, void* y, int batch, int h, int wd,
           int warps, int blocks, int smem, cudaStream_t stream) {
  const int h_out = (h + 1) / 2;
  const int w_out = (wd + 1) / 2;
  const int n_chunks = (w_out + kTileW - 1) / kTileW;
  const long long units = static_cast<long long>(batch) * h_out * n_chunks;
  if (units > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  // A chunk of 4 elements of x, and of y.
  const bool vec_in = (static_cast<long long>(wd) * C) % 4 == 0 &&
                      reinterpret_cast<uintptr_t>(x) % (4 * sizeof(T)) == 0;
  const int vec_out = w_out % 4 == 0 && reinterpret_cast<uintptr_t>(y) % (4 * sizeof(TW)) == 0;
  const T* xt = static_cast<const T*>(x);
  const TW* wt = static_cast<const TW*>(w);
  const TW* bt = static_cast<const TW*>(b);
  TW* yt = static_cast<TW*>(y);
  cudaError_t err;
  if (vec_in) {
    err = set_smem<T, TW, C, true>(smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    conv_s2_tiles_kernel<T, TW, C, true><<<blocks, warps * 32, smem, stream>>>(
        xt, wt, bt, yt, h, wd, h_out, w_out, n_chunks, static_cast<int>(units), vec_out);
  } else {
    err = set_smem<T, TW, C, false>(smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    conv_s2_tiles_kernel<T, TW, C, false><<<blocks, warps * 32, smem, stream>>>(
        xt, wt, bt, yt, h, wd, h_out, w_out, n_chunks, static_cast<int>(units), vec_out);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename TW>
int dispatch_c(const void* x, const void* w, const void* b, void* y, int batch, int h, int wd,
               int c, int warps, int blocks, int smem, cudaStream_t stream) {
  switch (c) {
    case 1: return launch<T, TW, 1>(x, w, b, y, batch, h, wd, warps, blocks, smem, stream);
    case 2: return launch<T, TW, 2>(x, w, b, y, batch, h, wd, warps, blocks, smem, stream);
    case 3: return launch<T, TW, 3>(x, w, b, y, batch, h, wd, warps, blocks, smem, stream);
    case 4: return launch<T, TW, 4>(x, w, b, y, batch, h, wd, warps, blocks, smem, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The plan must give at least the shared memory the weights and the
// warps' rows take.
bool plan_ok(int c, int warps, int smem) {
  return c >= 1 && c <= 4 && warps >= 1 && warps <= kMaxWarps && smem >= 0 &&
         static_cast<size_t>(smem) >= smem_of(c, warps) && static_cast<size_t>(smem) <= kMaxSmem;
}

// ------------------------------------------------------------ backward --

// Floats of one staged input row of the backward: the forward's layout,
// padded to 4 past a multiple of 32 floats, so that at C = 1 and 3 the
// second product's B fragments, which may span two rows, fall on distinct
// banks.
__host__ __device__ constexpr int bwd_row_floats(int c) {
  return (row_floats(c) + 27) / 32 * 32 + 4;
}
// The backward's m-tiles of 16 output channels: 2 at F = 32, 1 at F = 16,
// and 1 at F = 8, whose rows 8-15 are padding (zero weights, zero g, not
// stored); and the warps of a block that take the same pixels (one an
// m-tile).
constexpr int kMTiles = kCout >= 16 ? kCout / 16 : 1;
constexpr bool kHiRows = kCout >= 16;  // the m-tile's rows 8-15 are channels
// Floats of the staged weights: the A fragments of product 1, [m-tile][k
// step][lane][a0-a3 hi, a0-a3 lo], two float4s a lane and k step.
__host__ __device__ constexpr int bwd_w_floats(int c) { return kMTiles * 2 * c * 32 * 8; }
// Floats of one plane (hi or lo) of a staged input tile: 2 TR + 2 rows.
__host__ __device__ constexpr int bwd_x_floats(int c, int rows) {
  return (2 * rows + 2) * bwd_row_floats(c);
}
// Floats of the raw copy of an input tile: 2 TR + 2 rows of the forward's
// layout, back to back.
__host__ __device__ constexpr int bwd_raw_floats(int c, int rows) {
  return (2 * rows + 2) * row_floats(c);
}
// The weights, the input tile's hi and lo planes and the next tile's raw
// copy; at the end the same memory holds the block's partial sums (dW of
// each pair of warps, db of each of their lane quarters).
size_t bwd_smem_of(int c, int rows, int warps) {
  const size_t staging = static_cast<size_t>(bwd_w_floats(c)) +
                         2 * static_cast<size_t>(bwd_x_floats(c, rows)) +
                         static_cast<size_t>(bwd_raw_floats(c, rows));
  const size_t red = static_cast<size_t>(warps / kMTiles * (kTaps * c + 4)) * kCout;
  return sizeof(float) * (staging > red ? staging : red);
}

// v = hi + lo, each rounded to TF32 (to nearest, ties away from zero, as
// cvt.rna.tf32.f32 rounds: half of the 13 dropped bits added to the
// magnitude, then cleared), in integer operations: 3xTF32.
__device__ __forceinline__ unsigned tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split_tf32(float v, unsigned& hi, unsigned& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));
}
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// swish'(u) = s (1 + u (1 - s)), s = 1 / (1 + e^-u): the reciprocal by
// __fdividef (2 ulp; 0 once e^-u passes 2^126, as s should be).
__device__ __forceinline__ float dswish(float u) {
  const float s = __fdividef(1.0f, 1.0f + expf(-u));
  return s * (1.0f + u * (1.0f - s));
}

// Offset in a staged input row of patch element k = (ky * 4 + kx) * C + c:
// row ky, float kx C + c = k % 4C of the pixel's window.
template <int C>
__host__ __device__ constexpr int k_off(int k) {
  return k / (4 * C) * bwd_row_floats(C) + k % (4 * C);
}
// Whether the 8 patch elements from 8 nt on span two rows. 8 nt % 4C is a
// multiple of 4 (of 8 at even C), so a split leaves exactly 4 in the first
// row: those from 4 on lie in the next.
template <int C>
__host__ __device__ constexpr bool k_split(int nt) {
  return 4 * C - 8 * nt % (4 * C) < 8;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// E floats (1 or 4) from global to shared memory without a register; zero
// when !ok (nothing is read).
template <int E>
__device__ __forceinline__ void cp_async(float* dst, const float* src, bool ok) {
  if constexpr (E == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "r"(ok ? 16 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "r"(ok ? 4 : 0)
                 : "memory");
  }
}
// 4 bf16s (8 bytes) from global to shared memory, likewise.
__device__ __forceinline__ void cp_async8(void* dst, const __nv_bfloat16* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 8 : 0)
               : "memory");
}

// One tile's 2 TR + 2 input rows (66 columns from column 2 ox0 - 1 on, the
// forward's layout; zero where the pad or an edge falls): copied raw into
// shared memory (16 bytes a copy where VEC) while the previous tile is
// computed, then split into TF32 hi and lo planes in one pass. A bf16 image
// (T) is copied as it is, 8 bytes a copy where VEC, and upcast at the split,
// where it is exact in TF32: its hi plane is the value and its lo plane,
// zero, is not written (kLo), nor are the products that would read it. A
// bf16 image without VEC is read into registers and staged as f32 (cp.async
// copies no fewer than 4 bytes).
template <typename T, int C, int TR, int W, bool VEC>
struct BwdStage {
  static constexpr bool kLo = std::is_same<T, float>::value;
  static constexpr int E = VEC ? 4 : 1;
  static constexpr int kPerRow = row_floats(C) / E;
  static constexpr int kAll = (2 * TR + 2) * kPerRow;
  static constexpr int kPer = (kAll + 32 * W - 1) / (32 * W);

  __device__ __forceinline__ static void load(float* raw, const T* __restrict__ x, int n,
                                              int oy0, int ox0, int h, long long row_len,
                                              int tid) {
    const long long c0 = static_cast<long long>(2 * ox0 - 1) * C - lead(C);
    const T* xn = x + static_cast<long long>(n) * h * row_len;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = tid + 32 * W * k;
      const int r = i / kPerRow;
      const int iy = 2 * oy0 - 1 + r;
      const long long col = c0 + (i - r * kPerRow) * E;
      const bool ok = iy >= 0 && iy < h && col >= 0 && col + E <= row_len;
      if (i >= kAll) continue;
      if constexpr (kLo) {
        cp_async<E>(raw + i * E, ok ? xn + iy * row_len + col : x, ok);
      } else if constexpr (VEC) {
        cp_async8(reinterpret_cast<__nv_bfloat16*>(raw) + i * E,
                  ok ? xn + iy * row_len + col : x, ok);
      } else {
        raw[i] = ok ? __bfloat162float(xn[iy * row_len + col]) : 0.0f;
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  __device__ __forceinline__ static void split(const float* raw, float* xh, float* xl, int tid) {
    constexpr int kRow = bwd_row_floats(C);
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = tid + 32 * W * k;
      if (i >= kAll) continue;
      const int r = i / kPerRow;
      const int at = r * kRow + (i - r * kPerRow) * E;
      unsigned hi[E], lo[E];
      if constexpr (!kLo && VEC) {
        const uint2 v = *reinterpret_cast<const uint2*>(
            reinterpret_cast<const __nv_bfloat16*>(raw) + i * E);
        *reinterpret_cast<uint4*>(xh + at) =
            make_uint4(v.x << 16, v.x & 0xffff0000u, v.y << 16, v.y & 0xffff0000u);
      } else if constexpr (!kLo) {
        xh[at] = raw[i];
      } else if constexpr (VEC) {
        const float4 f = *reinterpret_cast<const float4*>(raw + i * E);
        split_tf32(f.x, hi[0], lo[0]);
        split_tf32(f.y, hi[1], lo[1]);
        split_tf32(f.z, hi[2], lo[2]);
        split_tf32(f.w, hi[3], lo[3]);
        *reinterpret_cast<uint4*>(xh + at) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
        *reinterpret_cast<uint4*>(xl + at) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      } else {
        split_tf32(raw[i], hi[0], lo[0]);
        xh[at] = __uint_as_float(hi[0]);
        xl[at] = __uint_as_float(lo[0]);
      }
    }
  }
};

// Per tile, a warp takes one m-tile of 16 channels (warp % kMTiles) and
// every (W / kMTiles)-th group of 16 pixels from warp / kMTiles on, as two
// n-tiles: the even
// pixels and the odd ones (column n of n-tile e is pixel 16 jg + 2 n + e).
// For each group: product 1, pre^T (16 x 8, twice) = W (16 x 16C) .
// patches^T, 3xTF32 on the tensor cores, each of the three products in its
// own accumulator, so that a dependent mma.sync waits less often; S = g
// swish'(pre + b) on the accumulator fragments, g read from
// global memory; product 2, dW (16 x 16C) += S . patches: S's accumulator
// fragment is product 2's A fragment when an n-tile's 8 pixels are taken
// in the order 0, 2, 4, 6, 1, 3, 5, 7 (a sum over them in any order), which
// the B fragments follow, one of the three products at a time over every
// n-tile of dW's columns. The input tile is split into TF32 planes once, so
// the fragments are plain loads. dW and db are summed in registers over
// the tiles.
template <typename T, typename TW, int C, int TR, int W, bool VEC>
__global__ void __launch_bounds__(W * 32, 16 / W)
    conv_s2_bwd_partials_kernel(const T* __restrict__ x, const TW* __restrict__ w,
                                const TW* __restrict__ bias, const TW* __restrict__ g,
                                long long sn, long long so, long long sh, long long sw,
                                float* __restrict__ ws, int h, int wd, int h_out, int w_out,
                                int n_chunks, int row_tiles, int tiles) {
  constexpr int K = kTaps * C;  // patch elements, dW's columns: [ky][kx][c]
  constexpr int KS = K / 8;     // product 1's k steps, product 2's n-tiles
  constexpr int P = kTileW * TR;
  constexpr int kRow = bwd_row_floats(C);
  extern __shared__ __align__(16) float smem[];
  float* s_w = smem;
  float* s_xh = smem + bwd_w_floats(C);
  float* s_xl = s_xh + bwd_x_floats(C, TR);
  float* s_raw = s_xl + bwd_x_floats(C, TR);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;  // fragment coordinates
  const long long row_len = static_cast<long long>(wd) * C;

  using Stage = BwdStage<T, C, TR, W, VEC>;
  constexpr bool kLo = Stage::kLo;  // the image has a lo plane (f32, not bf16)
  // The weights have a lo part (f32, not bf16: a bf16 is exact in TF32).
  constexpr bool kWLo = std::is_same<TW, float>::value;
  int t = blockIdx.x;
  if (t < tiles) {
    const int rest = t / n_chunks;
    Stage::load(s_raw, x, rest / row_tiles, rest % row_tiles * TR, t % n_chunks * kTileW, h,
                row_len, tid);
  }

  // The weights as product 1's A fragments, split once: a_r of lane ln at
  // k step ks of m-tile mt is W[mt 16 + ln / 4 + 8 (r % 2)][ks 8 + ln % 4 +
  // 4 (r / 2)], 0 for a padding row.
  constexpr int kWPer = kMTiles * KS * 32 * 4 / (32 * W);
  static_assert(kMTiles * KS * 32 * 4 % (32 * W) == 0, "the fragments split over the block");
  float wv[kWPer];
#pragma unroll
  for (int j = 0; j < kWPer; ++j) {
    const int i = tid + 32 * W * j;
    const int ln = i / 4 % 32;
    const int o = i / (128 * KS) * 16 + ln / 4 + 8 * (i % 4 % 2);
    const int k = i / 128 % KS * 8 + ln % 4 + 4 * (i % 4 / 2);
    wv[j] = o < kCout ? ld_f32(w + ((o * C + k % C) * 4 + k / (4 * C)) * 4 + k / C % 4) : 0.0f;
  }
#pragma unroll
  for (int j = 0; j < kWPer; ++j) {
    const int i = tid + 32 * W * j;
    unsigned hi, lo;
    split_tf32(wv[j], hi, lo);
    float* f = s_w + i / 4 * 8;  // [m-tile][k step][lane][8]: i / 4 is the lane's slot
    f[i % 4] = __uint_as_float(hi);
    f[4 + i % 4] = __uint_as_float(lo);
  }
  const int mt = warp % kMTiles;
  const int o0 = mt * 16 + gq;  // the channels of the thread's rows: o0, o0 + 8
  const float b0 = ld_f32(bias + o0), b1 = kHiRows ? ld_f32(bias + o0 + 8) : 0.0f;
  const float4* wf = reinterpret_cast<const float4*>(s_w) + (mt * KS * 32 + lane) * 2;
  // Per-thread offsets in the staged planes: product 1's B at pixel 2 gq,
  // element tq of a 4-aligned run of k; product 2's B at pixel 4 tq,
  // element gq of the 8 from 8 nt (adj when those span two rows).
  const int off1 = lead(C) + 4 * C * gq + tq;
  const int off2 = lead(C) + 8 * C * tq + gq;
  const int adj = gq >= 4 ? kRow - 4 * C : 0;
  const long long g_o = o0 * so;
  float acc[KS][4] = {};  // dW (o0, o0 + 8) x (nt 8 + 2 tq, + 1)
  float db0 = 0.0f, db1 = 0.0f;

  for (; t < tiles; t += gridDim.x) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // this tile's raw copy has landed; the previous tile is no longer read
    Stage::split(s_raw, s_xh, s_xl, tid);
    __syncthreads();
    const int rest = t / n_chunks;
    const int n = rest / row_tiles;
    const int oy0 = rest % row_tiles * TR;
    const int ox0 = t % n_chunks * kTileW;
    const int next = t + gridDim.x;
    if (next < tiles) {
      const int nrest = next / n_chunks;
      Stage::load(s_raw, x, nrest / row_tiles, nrest % row_tiles * TR,
                  next % n_chunks * kTileW, h, row_len, tid);
    }
    const TW* gt = g + n * sn + g_o;
    for (int jg = warp / kMTiles; jg < P / 16; jg += W / kMTiles) {
      // The group's pixels start at row jg / 2, column 16 (jg % 2) of the tile.
      const int base = jg / 2 * 2 * kRow + jg % 2 * 32 * C;
      // g at the thread's accumulator positions: channels o0, o0 + 8,
      // pixels 16 jg + 4 tq + i (i = 2 c + e: column 2 tq + c of n-tile e).
      const int oy = oy0 + jg / 2;
      const int ox = ox0 + jg % 2 * 16 + 4 * tq;
      const TW* gp = gt + oy * sh + ox * sw;
      float gv[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool ok = oy < h_out && ox + i < w_out;
        gv[0][i] = ok ? ld_f32(gp + i * sw) : 0.0f;
        gv[1][i] = ok && kHiRows ? ld_f32(gp + 8 * so + i * sw) : 0.0f;
      }
      // Product 1: B of n-tile e (k x pixel) = patch(16 jg + 2 gq + e, ks 8
      // + tq (+ 4)).
      float pre[3][2][4] = {};
      const float* ph = s_xh + base + off1;
      const float* pl = s_xl + base + off1;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const float4 h4 = wf[ks * 64], l4 = wf[ks * 64 + 1];
        const unsigned ah[4] = {__float_as_uint(h4.x), __float_as_uint(h4.y),
                                __float_as_uint(h4.z), __float_as_uint(h4.w)};
        const unsigned al[4] = {__float_as_uint(l4.x), __float_as_uint(l4.y),
                                __float_as_uint(l4.z), __float_as_uint(l4.w)};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int o_a = e * 2 * C + k_off<C>(ks * 8);
          const int o_b = e * 2 * C + k_off<C>(ks * 8 + 4);
          const unsigned bh[2] = {__float_as_uint(ph[o_a]), __float_as_uint(ph[o_b])};
          const unsigned bl[2] = {__float_as_uint(pl[o_a]), __float_as_uint(pl[o_b])};
          if constexpr (kWLo) mma_tf32(pre[0][e], al, bh);
          if constexpr (kLo) mma_tf32(pre[1][e], ah, bl);
          mma_tf32(pre[2][e], ah, bh);
        }
      }
      // S at (o0, o0 + 8) x pixels 16 jg + 4 tq + e (+ 2), as product 2's A
      // fragments of n-tile e: A's column tq is its column 2 tq, column tq +
      // 4 its column 2 tq + 1.
      unsigned s_hi[2][4], s_lo[2][4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float s[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float u = (pre[0][e][i] + pre[1][e][i]) + pre[2][e][i] + (i < 2 ? b0 : b1);
          s[i] = gv[i / 2][2 * (i % 2) + e] * dswish(u);
        }
        db0 += s[0];
        db0 += s[1];
        db1 += s[2];
        db1 += s[3];
        split_tf32(s[0], s_hi[e][0], s_lo[e][0]);
        split_tf32(s[2], s_hi[e][1], s_lo[e][1]);
        split_tf32(s[1], s_hi[e][2], s_lo[e][2]);
        split_tf32(s[3], s_hi[e][3], s_lo[e][3]);
      }
      // Product 2: B of n-tile e = patch(16 jg + 4 tq + e (+ 2), nt 8 + gq),
      // one of the three products at a time over every n-tile.
      const float* qh = s_xh + base + off2;
      const float* ql = s_xl + base + off2;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        unsigned b[KS][2];
#pragma unroll
        for (int term = 0; term < 3; ++term) {
          if (!kLo && term == 1) continue;  // hi(S) . lo(x), and lo(x) is 0
          const float* q = term == 1 ? ql : qh;
#pragma unroll
          for (int nt = 0; nt < KS; ++nt) {
            const int o_a = e * 2 * C + k_off<C>(nt * 8) + (k_split<C>(nt) ? adj : 0);
            b[nt][0] = __float_as_uint(q[o_a]);
            b[nt][1] = __float_as_uint(q[o_a + 4 * C]);  // pixel + 2
          }
#pragma unroll
          for (int nt = 0; nt < KS; ++nt) mma_tf32(acc[nt], term == 0 ? s_lo[e] : s_hi[e], b[nt]);
        }
      }
    }
  }
  __syncthreads();

  // The block's sums, in a fixed order, into its row of the workspace:
  // entry k * F + o of dW (k < K), the warp groups' sums in order (a group:
  // the kMTiles warps that take the same pixels); entry K * F + o of db, the
  // 4 rows (group, tq) of each group in order.
  constexpr int kGroups = W / kMTiles;
  float* red = smem;                           // [group][k][o]
  float* red_b = smem + kGroups * K * kCout;  // [group * 4 + tq][o]
  const int grp = warp / kMTiles;
#pragma unroll
  for (int nt = 0; nt < KS; ++nt) {
    float* r = red + (grp * K + nt * 8 + 2 * tq) * kCout + o0;
    r[0] = acc[nt][0];
    r[kCout] = acc[nt][1];
    if (kHiRows) {
      r[8] = acc[nt][2];
      r[kCout + 8] = acc[nt][3];
    }
  }
  red_b[(grp * 4 + tq) * kCout + o0] = db0;
  if (kHiRows) red_b[(grp * 4 + tq) * kCout + o0 + 8] = db1;
  __syncthreads();
  constexpr int kOut = (K + 1) * kCout;
  for (int i = tid; i < kOut; i += 32 * W) {
    float s = 0.0f;
    if (i < K * kCout) {
      for (int r = 0; r < kGroups; ++r) s += red[r * K * kCout + i];
    } else {
      for (int r = 0; r < 4 * kGroups; ++r) s += red_b[r * kCout + i - K * kCout];
    }
    ws[static_cast<size_t>(blockIdx.x) * kOut + i] = s;
  }
}

// dw and db from the blocks' rows of sums, entry t = k * 32 + o, k = (ky *
// 4 + kx) * c + ch (k = 16 c: the bias). A block takes one k, its 32
// entries (a 128-byte line of each row) and kReduceRows rows of threads:
// thread (o, y) sums rows y, y + kReduceRows, ... in order, kReduceBatch
// loads issued before the first add, then thread (o, 0) adds the
// kReduceRows sums in order. A fixed order throughout.
constexpr int kReduceRows = 32;
constexpr int kReduceBatch = 16;

template <typename TD>
__global__ void __launch_bounds__(kCout * kReduceRows)
    conv_s2_bwd_reduce_kernel(const float* __restrict__ ws, TD* __restrict__ dw,
                              TD* __restrict__ db, int c, int parts) {
  __shared__ float part[kReduceRows][kCout];
  const int kk = kTaps * c;
  const int n_out = (kk + 1) * kCout;
  const int k = blockIdx.x;
  const int o = threadIdx.x;
  const int y = threadIdx.y;
  const float* src = ws + k * kCout + o;
  float s = 0.0f;
  for (int r0 = y; r0 < parts; r0 += kReduceBatch * kReduceRows) {
    float v[kReduceBatch];
#pragma unroll
    for (int i = 0; i < kReduceBatch; ++i) {
      const int r = r0 + i * kReduceRows;
      v[i] = r < parts ? __ldg(src + static_cast<size_t>(r) * n_out) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kReduceBatch; ++i) s += v[i];
  }
  part[y][o] = s;
  __syncthreads();
  if (y != 0) return;
  float total = 0.0f;
#pragma unroll
  for (int i = 0; i < kReduceRows; ++i) total += part[i][o];
  if (k == kk) {
    db[o] = from_f32<TD>(total);
    return;
  }
  const int ky = k / (4 * c);
  const int kx = (k / c) % 4;
  const int ch = k % c;
  dw[((o * c + ch) * 4 + ky) * 4 + kx] = from_f32<TD>(total);
}

template <typename T, typename TW, int C, int TR, int W, bool VEC>
int launch_bwd(const T* x, const TW* w, const TW* b, const TW* g, long long sn, long long so,
               long long sh, long long sw, float* ws, TW* dw, TW* db, int batch, int h, int wd,
               int blocks, int smem, cudaStream_t stream) {
  const int h_out = (h + 1) / 2;
  const int w_out = (wd + 1) / 2;
  const int n_chunks = (w_out + kTileW - 1) / kTileW;
  const int row_tiles = (h_out + TR - 1) / TR;
  const long long tiles = static_cast<long long>(batch) * row_tiles * n_chunks;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSuccess;
  if (static_cast<size_t>(smem) > kDefaultSmem) {
    err = cudaFuncSetAttribute(conv_s2_bwd_partials_kernel<T, TW, C, TR, W, VEC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  conv_s2_bwd_partials_kernel<T, TW, C, TR, W, VEC><<<blocks, W * 32, smem, stream>>>(
      x, w, b, g, sn, so, sh, sw, ws, h, wd, h_out, w_out, n_chunks, row_tiles,
      static_cast<int>(tiles));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  conv_s2_bwd_reduce_kernel<TW><<<kTaps * C + 1, dim3(kCout, kReduceRows), 0, stream>>>(
      ws, dw, db, C, blocks);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename TW, int C, int TR, int W>
int launch_bwd_vec(const T* x, const TW* w, const TW* b, const TW* g, long long sn, long long so,
                   long long sh, long long sw, float* ws, TW* dw, TW* db, int batch, int h,
                   int wd, int blocks, int smem, cudaStream_t stream) {
  // Copies of 4 elements (16 bytes of f32, 8 of bf16) where a row is whole
  // chunks of 4 and x starts on a chunk.
  if ((static_cast<long long>(wd) * C) % 4 == 0 &&
      reinterpret_cast<uintptr_t>(x) % (4 * sizeof(T)) == 0) {
    return launch_bwd<T, TW, C, TR, W, true>(x, w, b, g, sn, so, sh, sw, ws, dw, db, batch, h,
                                             wd, blocks, smem, stream);
  }
  return launch_bwd<T, TW, C, TR, W, false>(x, w, b, g, sn, so, sh, sw, ws, dw, db, batch, h, wd,
                                            blocks, smem, stream);
}

template <typename T, typename TW, int C>
int launch_bwd_c(const T* x, const TW* w, const TW* b, const TW* g, long long sn, long long so,
                 long long sh, long long sw, float* ws, TW* dw, TW* db, int batch, int h, int wd,
                 int warps, int blocks, int smem, int rows, cudaStream_t stream) {
  if (rows == 2 && warps == 8) {
    return launch_bwd_vec<T, TW, C, 2, 8>(x, w, b, g, sn, so, sh, sw, ws, dw, db, batch, h, wd,
                                      blocks, smem, stream);
  }
  if (rows == 2) {
    return launch_bwd_vec<T, TW, C, 2, 4>(x, w, b, g, sn, so, sh, sw, ws, dw, db, batch, h, wd,
                                      blocks, smem, stream);
  }
  if (warps == 8) {
    return launch_bwd_vec<T, TW, C, 4, 8>(x, w, b, g, sn, so, sh, sw, ws, dw, db, batch, h, wd,
                                      blocks, smem, stream);
  }
  return launch_bwd_vec<T, TW, C, 4, 4>(x, w, b, g, sn, so, sh, sw, ws, dw, db, batch, h, wd,
                                    blocks, smem, stream);
}

// Tiles of 2 or 4 output rows, 4 or 8 warps a block, and at least the
// shared memory the tile's buffers and the block's sums take.
bool bwd_plan_ok(int c, int warps, int smem, int rows) {
  return c >= 1 && c <= 4 && (warps == 4 || warps == 8) && (rows == 2 || rows == 4) &&
         smem >= 0 && static_cast<size_t>(smem) >= bwd_smem_of(c, rows, warps) &&
         static_cast<size_t>(smem) <= kMaxSmem;
}

template <typename T, typename TW>
int dispatch_bwd_c(const void* x_, const void* w, const void* b, const void* g, long long sn,
                   long long so, long long sh, long long sw, void* ws, void* dw, void* db,
                   int batch, int h, int wd, int c, int warps, int blocks, int smem, int rows,
                   cudaStream_t stream) {
  const T* x = static_cast<const T*>(x_);
  const TW* wf = static_cast<const TW*>(w);
  const TW* bf = static_cast<const TW*>(b);
  const TW* gf = static_cast<const TW*>(g);
  float* wsf = static_cast<float*>(ws);
  TW* dwf = static_cast<TW*>(dw);
  TW* dbf = static_cast<TW*>(db);
  switch (c) {
    case 1:
      return launch_bwd_c<T, TW, 1>(x, wf, bf, gf, sn, so, sh, sw, wsf, dwf, dbf, batch, h, wd,
                                warps, blocks, smem, rows, stream);
    case 2:
      return launch_bwd_c<T, TW, 2>(x, wf, bf, gf, sn, so, sh, sw, wsf, dwf, dbf, batch, h, wd,
                                warps, blocks, smem, rows, stream);
    case 3:
      return launch_bwd_c<T, TW, 3>(x, wf, bf, gf, sn, so, sh, sw, wsf, dwf, dbf, batch, h, wd,
                                warps, blocks, smem, rows, stream);
    case 4:
      return launch_bwd_c<T, TW, 4>(x, wf, bf, gf, sn, so, sh, sw, wsf, dwf, dbf, batch, h, wd,
                                warps, blocks, smem, rows, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ------------------------------------------------------ input gradient --

constexpr int kDxCols = kTileW + 2;         // S columns of a tile: its 32 and one each side
constexpr int kDxInCols = 2 * kDxCols + 2;  // input columns a tile stages
constexpr int kDxMaxWarps = 12;  // so that a thread may hold 168 registers
constexpr int kDxMaxRows = 8;

// Floats before input column 2 j0 - 3 of a staged row: 2 j0 C is a multiple
// of 4, so the image's 16-byte chunks start on 16 bytes.
__host__ __device__ constexpr int dx_lead(int c) { return (4 - 3 * c % 4) % 4; }
// Floats of one staged input row (raw, hi or lo): 70 columns from 2 j0 - 3.
__host__ __device__ constexpr int dx_row_floats(int c) {
  return (dx_lead(c) + kDxInCols * c + 3) / 4 * 4;
}
// Floats of one S pixel's row of T (16 C), padded so that a warp's stores
// of T fall on distinct banks.
__host__ __device__ constexpr int dx_t_pitch(int c) { return 16 * c + (c % 2 ? 2 : 4); }
// The input gradient's n-tiles of 8 output channels in product 1, its k
// steps in product 2: 4, 2 or 1.
constexpr int kNT = kCout / 8;
// Floats of the staged weights: product 1's B fragments and product 2's A
// fragments, hi and lo, 32 C F floats each.
__host__ __device__ constexpr int dx_w_floats(int c) { return 64 * c * kCout; }
// Floats of one input plane (raw, hi or lo) of a tile: 2 TR + 6 rows.
__host__ __device__ constexpr int dx_plane_floats(int c, int rows) {
  return (2 * rows + 6) * dx_row_floats(c);
}
// Floats of T: TR + 2 rows of 34 S pixels.
__host__ __device__ constexpr int dx_t_floats(int c, int rows) {
  return (rows + 2) * kDxCols * dx_t_pitch(c);
}
// The weights' fragments; the raw copy of the next tile's input and its hi
// and lo planes; and T.
size_t dx_smem_of(int c, int rows) {
  return sizeof(float) * (static_cast<size_t>(dx_w_floats(c)) + 3 * dx_plane_floats(c, rows) +
                          static_cast<size_t>(dx_t_floats(c, rows)));
}

// Offset in a staged row of patch element k = (ky * 4 + kx) * C + c.
template <int C>
__host__ __device__ constexpr int dx_k_off(int k) {
  return k / (4 * C) * dx_row_floats(C) + k % (4 * C);
}

// The S pixel of slot s (0..31) of an item, as row r (0..TR + 1) and column
// cs (0..33) of the tile's S grid; false for a slot with no pixel. Items 0
// .. TR + 1 are the grid's rows, columns 1..32: at odd C the m-tile's rows
// 0-7 are its even pixels and rows 8-15 its odd ones, at even C they are in
// order (either way a warp's fragment loads and T stores fall on distinct
// banks, 2-way at C = 4). Item TR + 2 holds the ring's columns 0 and 33.
template <int C>
__device__ __forceinline__ bool dx_slot(int item, int s, int s_rows, int& r, int& cs) {
  if (item < s_rows) {
    const int rho = s % 16;
    r = item;
    cs = 1 + (C % 2 ? s / 16 * 16 + (rho < 8 ? 2 * rho : 2 * rho - 15) : s);
    return true;
  }
  const bool ok = s < 2 * s_rows;
  r = ok ? s / 2 : 0;
  cs = ok && s % 2 ? kDxCols - 1 : 0;
  return ok;
}

// One tile's 2 TR + 6 input rows, 70 columns from 2 j0 - 3 on (zero where
// the pad or an edge falls), copied raw into shared memory (16 bytes a copy
// where VEC) as the backward's BwdStage copies its rows: a bf16 image as it
// is, 8 bytes a copy where VEC (kPacked), else read into registers and
// staged as f32.
template <typename T, int C, bool VEC>
struct DxStage {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr bool kPacked = !kF32 && VEC;
  static constexpr int E = VEC ? 4 : 1;
  static constexpr int kPerRow = dx_row_floats(C) / E;

  __device__ __forceinline__ static void load_x(float* raw, const T* __restrict__ x, int n,
                                                int m0, int j0, int h, long long row_len,
                                                int rows, int tid, int nthreads) {
    const long long c0 = static_cast<long long>(2 * j0 - 3) * C - dx_lead(C);
    const T* xn = x + static_cast<long long>(n) * h * row_len;
    const int all = (2 * rows + 6) * kPerRow;
    for (int i = tid; i < all; i += nthreads) {
      const int r = i / kPerRow;
      const int iy = 2 * m0 - 3 + r;
      const long long col = c0 + (i - r * kPerRow) * E;
      const bool ok = iy >= 0 && iy < h && col >= 0 && col + E <= row_len;
      if constexpr (kF32) {
        cp_async<E>(raw + i * E, ok ? xn + iy * row_len + col : x, ok);
      } else if constexpr (VEC) {
        cp_async8(reinterpret_cast<__nv_bfloat16*>(raw) + i * E, ok ? xn + iy * row_len + col : x,
                  ok);
      } else {
        raw[i] = ok ? to_f32(xn[iy * row_len + col]) : 0.0f;
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
};

// dx of one tile from its T: input row 2 (m0 + a) + ph reads S rows r =
// a + 1 + ph - d at tap row ky = 1 - ph + 2 d (d = 0, 1), and likewise its
// column; 0 outside the output. Sum ((d, d') = (0, 0) + (0, 1)) + (1, 0) +
// (1, 1): a fixed order. A thread an input pixel (its C channels), two
// pixels a stride apart with their loads together.
template <typename T, int C>
__device__ __forceinline__ void dx_fold(const float* s_t, T* __restrict__ dx, int n, int m0,
                                        int j0, int h, int wd, int h_out, int w_out, int rows,
                                        int tid, int nthreads) {
  constexpr int TP = dx_t_pitch(C);
  constexpr int kPx = 2 * kTileW;  // input columns of a tile
  const int row_len = wd * C;
  T* dxn = dx + static_cast<long long>(n) * h * row_len + 2 * j0 * C;
  const int n_px = 2 * rows * kPx;
  for (int p0 = tid; p0 < n_px; p0 += 2 * nthreads) {
    float v[2][4][C];
    int at[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int p = p0 + u * nthreads;
      const int a = p / kPx, wl = p % kPx;
      const int ph = a % 2, pw = wl % 2;
      const bool in = p < n_px && 2 * m0 + a < h && 2 * j0 + wl < wd;
      at[u] = in ? (2 * m0 + a) * row_len + wl * C : -1;
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        const int r = a / 2 + 1 + ph - d;
        const int i = m0 - 1 + r;
        const int ky = 1 - ph + 2 * d;
#pragma unroll
        for (int d2 = 0; d2 < 2; ++d2) {
          const int cs = wl / 2 + 1 + pw - d2;
          const int j = j0 - 1 + cs;
          const int kx = 1 - pw + 2 * d2;
          const bool ok = in && i >= 0 && i < h_out && j >= 0 && j < w_out;
          const float* tp = s_t + (r * kDxCols + cs) * TP + (ky * 4 + kx) * C;
#pragma unroll
          for (int c = 0; c < C; ++c) v[u][2 * d + d2][c] = ok ? tp[c] : 0.0f;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (at[u] < 0) continue;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        dxn[at[u] + c] = from_f32<T>(((v[u][0][c] + v[u][1][c]) + v[u][2][c]) + v[u][3][c]);
      }
    }
  }
}

// A block walks tiles of TR output rows by 32 output columns of one image
// with the grid's stride; it writes dx for the tile's input rows 2 m0 ..
// 2 m0 + 2 TR - 1 and columns 2 j0 .. 2 j0 + 63, which read S on the tile
// and the ring around it (rows m0 - 1 .. m0 + TR, columns j0 - 1 .. j0 +
// 32). The warps take items of 32 S pixels (two m-tiles of 16; the items
// are the TR + 2 rows of S and, where the tile has them, the ring's
// columns): product 1, pre (16 pixels x 8 channels, four n-tiles) =
// patches . W^T; S = g swish'(pre + b) on the accumulator fragments, g read
// from global memory through its strides; product 2, T^T (16 C x 8 pixels)
// = W^T . S^T, whose B fragments are product 1's accumulator fragments when
// its k step takes the channels in the order 0, 2, 4, 6, 1, 3, 5, 7 (so S
// never leaves the registers); T into shared memory. Both products 3xTF32
// on the tensor cores. The ring's rows need one tap row of T each (ky = 3
// above, ky = 0 below), which lies in one m-tile of product 2. Then every
// warp folds T into dx. The next tile's input is copied meanwhile. T is
// the type of x, w, bias, g and dx; a bf16 operand is exact in TF32, so at
// bf16 the products that would read its lo part are not taken.
template <typename T, int C, bool VEC>
__global__ void __launch_bounds__(kDxMaxWarps * 32, 1)
    conv_s2_dx_kernel(const T* __restrict__ x, const T* __restrict__ w,
                      const T* __restrict__ bias, const T* __restrict__ g, long long sn,
                      long long so, long long sh, long long sw, T* __restrict__ dx, int h,
                      int wd, int h_out, int w_out, int rows, int row_tiles, int col_tiles,
                      int tiles) {
  constexpr int K = kTaps * C;  // patch elements: [ky][kx][c]
  constexpr int KS = K / 8;     // product 1's k steps
  constexpr int MT = K / 16;    // product 2's m-tiles
  constexpr int RF = dx_row_floats(C);
  constexpr int TP = dx_t_pitch(C);
  extern __shared__ __align__(16) float smem[];
  uint4* s_w1 = reinterpret_cast<uint4*>(smem);  // [ks][nt][lane]
  uint4* s_w2 = s_w1 + KS * kNT * 32;             // [mt][ks][hi, lo][lane]
  const int plane = dx_plane_floats(C, rows);
  float* s_raw = smem + dx_w_floats(C);
  float* s_xh = s_raw + plane;
  float* s_xl = s_xh + plane;
  float* s_t = s_xl + plane;  // [r][cs][TP]
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;  // fragment coordinates
  const long long row_len = static_cast<long long>(wd) * C;
  const int s_rows = rows + 2;

  using Stage = DxStage<T, C, VEC>;
  constexpr bool kLo = Stage::kF32;  // x and w have lo parts (f32, not bf16)
  int t = blockIdx.x;
  if (t < tiles) {
    const int rest = t / col_tiles;
    Stage::load_x(s_raw, x, rest / row_tiles, rest % row_tiles * rows, t % col_tiles * kTileW, h,
                  row_len, rows, tid, nthreads);
  }
  // The weights, raw into T's memory (a batch of loads before its stores),
  // then split once into the fragments. Product 1's B fragment of lane ln
  // at (ks, nt): W[o][k], W[o][k + 4] with o = 8 nt + ln / 4, k = 8 ks + ln
  // % 4, as {hi, hi, lo, lo}. Product 2's A fragment at (mt, ks): W[o][k],
  // W[o][k + 8], W[o + 1][k], W[o + 1][k + 8] with o = 8 ks + 2 (ln % 4), k =
  // 16 mt + ln / 4, hi then lo 32 lanes on. W[o][k] is w[o, c, ky, kx] with
  // k = (ky * 4 + kx) C + c.
  for (int i0 = 0; i0 < kCout * K; i0 += 8 * nthreads) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + u * nthreads + tid;
      v[u] = i < kCout * K ? ld_f32(w + i) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + u * nthreads + tid;
      if (i < kCout * K) s_t[i] = v[u];
    }
  }
  // The bias of the thread's channels 8 nt + 2 tq (+ 1).
  float bv[kNT][2];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    bv[nt][0] = ld_f32(bias + 8 * nt + 2 * tq);
    bv[nt][1] = ld_f32(bias + 8 * nt + 2 * tq + 1);
  }
  __syncthreads();
  auto w_at = [&](int o, int k) { return s_t[(o * C + k % C) * kTaps + k / C]; };
  for (int i = tid; i < KS * kNT * 32; i += nthreads) {
    const int ln = i % 32;
    const int o = i / 32 % kNT * 8 + ln / 4;
    const int k = i / (32 * kNT) * 8 + ln % 4;
    unsigned h0, l0, h1, l1;
    split_tf32(w_at(o, k), h0, l0);
    split_tf32(w_at(o, k + 4), h1, l1);
    s_w1[i] = make_uint4(h0, h1, l0, l1);
  }
  for (int i = tid; i < MT * kNT * 32; i += nthreads) {
    const int ln = i % 32;
    const int o = i / 32 % kNT * 8 + 2 * (ln % 4);
    const int k = i / (32 * kNT) * 16 + ln / 4;
    unsigned hi[4], lo[4];
    split_tf32(w_at(o, k), hi[0], lo[0]);
    split_tf32(w_at(o, k + 8), hi[1], lo[1]);
    split_tf32(w_at(o + 1, k), hi[2], lo[2]);
    split_tf32(w_at(o + 1, k + 8), hi[3], lo[3]);
    uint4* f = s_w2 + i / 32 * 64 + ln;
    f[0] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    f[32] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }

  for (; t < tiles; t += gridDim.x) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // this tile's input has landed; the previous tile's T is no longer read
    for (int i = tid; i < plane / 4; i += nthreads) {
      if constexpr (Stage::kPacked) {
        const uint2 v = reinterpret_cast<const uint2*>(s_raw)[i];
        reinterpret_cast<uint4*>(s_xh)[i] =
            make_uint4(v.x << 16, v.x & 0xffff0000u, v.y << 16, v.y & 0xffff0000u);
      } else if constexpr (!kLo) {
        reinterpret_cast<float4*>(s_xh)[i] = reinterpret_cast<const float4*>(s_raw)[i];
      } else {
        const float4 f = reinterpret_cast<const float4*>(s_raw)[i];
        uint4 hi, lo;
        split_tf32(f.x, hi.x, lo.x);
        split_tf32(f.y, hi.y, lo.y);
        split_tf32(f.z, hi.z, lo.z);
        split_tf32(f.w, hi.w, lo.w);
        reinterpret_cast<uint4*>(s_xh)[i] = hi;
        reinterpret_cast<uint4*>(s_xl)[i] = lo;
      }
    }
    __syncthreads();
    const int rest = t / col_tiles;
    const int n = rest / row_tiles;
    const int m0 = rest % row_tiles * rows;
    const int j0 = t % col_tiles * kTileW;
    const int next = t + gridDim.x;
    if (next < tiles) {
      const int nrest = next / col_tiles;
      Stage::load_x(s_raw, x, nrest / row_tiles, nrest % row_tiles * rows,
                    next % col_tiles * kTileW, h, row_len, rows, tid, nthreads);
    }
    // The items: the rows of S inside the output, and the ring's columns
    // where the tile has them.
    const int items = s_rows + (j0 > 0 || j0 + kTileW < w_out);
    for (int item = warp; item < items; item += nthreads / 32) {
      if (item < s_rows && (m0 - 1 + item < 0 || m0 - 1 + item >= h_out)) continue;
      // Product 1's A rows: slot 16 mi + 8 hf + gq; the thread's offsets in
      // the planes (tq added) and its g at channels 8 nt + 2 tq (+ 1).
      int base[2][2];
      float gv[2][2][kNT][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          int r, cs;
          bool ok = dx_slot<C>(item, 16 * mi + 8 * hf + gq, s_rows, r, cs);
          base[mi][hf] = 2 * r * RF + dx_lead(C) + 2 * cs * C + tq;
          const int i = m0 - 1 + r, j = j0 - 1 + cs;
          ok = ok && i >= 0 && i < h_out && j >= 0 && j < w_out;
          const T* gp = g + (ok ? n * sn + i * sh + j * sw + 2 * tq * so : 0);
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) {
            gv[mi][hf][nt][0] = ok ? ld_f32(gp + 8 * nt * so) : 0.0f;
            gv[mi][hf][nt][1] = ok ? ld_f32(gp + (8 * nt + 1) * so) : 0.0f;
          }
        }
      }
      // Product 1: pre (slots x channels) = patches . W^T; per k step the
      // three products of the split, each over all eight accumulators.
      float pre[2][kNT][4] = {};
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const int oa = dx_k_off<C>(8 * ks), ob = dx_k_off<C>(8 * ks + 4);
        unsigned ah[2][4], al[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const float* h0 = s_xh + base[mi][0];
          const float* h1 = s_xh + base[mi][1];
          const float* l0 = s_xl + base[mi][0];
          const float* l1 = s_xl + base[mi][1];
          ah[mi][0] = __float_as_uint(h0[oa]);
          ah[mi][1] = __float_as_uint(h1[oa]);
          ah[mi][2] = __float_as_uint(h0[ob]);
          ah[mi][3] = __float_as_uint(h1[ob]);
          al[mi][0] = __float_as_uint(l0[oa]);
          al[mi][1] = __float_as_uint(l1[oa]);
          al[mi][2] = __float_as_uint(l0[ob]);
          al[mi][3] = __float_as_uint(l1[ob]);
        }
        uint4 wb[kNT];
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) wb[nt] = s_w1[(ks * kNT + nt) * 32 + lane];
#pragma unroll
        for (int term = 0; term < 3; ++term) {
          if (!kLo && term != 2) continue;  // lo(x) . hi(w), hi(x) . lo(w): both 0
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) {
            const unsigned b[2] = {term == 1 ? wb[nt].z : wb[nt].x,
                                   term == 1 ? wb[nt].w : wb[nt].y};
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) mma_tf32(pre[mi][nt], term == 0 ? al[mi] : ah[mi], b);
          }
        }
      }
      // S = g swish'(pre + b): element e of (mi, nt) is slot 16 mi + 8 (e /
      // 2) + gq, channel 8 nt + 2 tq + e % 2.
      float sv[2][kNT][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            sv[mi][nt][e] = gv[mi][e / 2][nt][e % 2] * dswish(pre[mi][nt][e] + bv[nt][e % 2]);
          }
        }
      }
      // Where the thread's entries of T go: slot 16 mi + 8 hf + 2 tq + p of
      // n-tile nb = 2 mi + hf, or -1 for a slot with no pixel.
      int t_at[4][2];
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          int r, cs;
          const bool ok = dx_slot<C>(item, 8 * nb + 2 * tq + p, s_rows, r, cs);
          t_at[nb][p] = ok ? (r * kDxCols + cs) * TP + gq : -1;
        }
      }
      // Product 2: T^T (k x slots) = W^T . S^T over kPass m-tiles of 16
      // patch elements at once (4 n-tiles each), S split per k step; the
      // ring's rows take only the m-tile of their tap row.
      const int mt_lo = item == 0 ? MT - 1 : 0;
      const int mt_hi = item == s_rows - 1 ? 1 : MT;
      constexpr int kPass = MT == 4 ? 2 : MT;  // 1, 2, 3, 2 at C = 1-4
#pragma unroll
      for (int mp = 0; mp < MT; mp += kPass) {
        if (mp + kPass <= mt_lo || mp >= mt_hi) continue;
        float acc[kPass][4][4] = {};
#pragma unroll
        for (int ks = 0; ks < kNT; ++ks) {
          unsigned bh[4][2], bl[4][2];
#pragma unroll
          for (int nb = 0; nb < 4; ++nb) {
            split_tf32(sv[nb / 2][ks][2 * (nb % 2)], bh[nb][0], bl[nb][0]);
            split_tf32(sv[nb / 2][ks][2 * (nb % 2) + 1], bh[nb][1], bl[nb][1]);
          }
#pragma unroll
          for (int m = 0; m < kPass; ++m) {
            const int mt = mp + m;
            if (mt < mt_lo || mt >= mt_hi) continue;
            const uint4 h4 = s_w2[(mt * kNT + ks) * 64 + lane];
            const uint4 l4 = s_w2[(mt * kNT + ks) * 64 + 32 + lane];
            const unsigned ah[4] = {h4.x, h4.y, h4.z, h4.w};
            const unsigned al[4] = {l4.x, l4.y, l4.z, l4.w};
            if constexpr (kLo) {
#pragma unroll
              for (int nb = 0; nb < 4; ++nb) mma_tf32(acc[m][nb], al, bh[nb]);
            }
#pragma unroll
            for (int nb = 0; nb < 4; ++nb) mma_tf32(acc[m][nb], ah, bl[nb]);
#pragma unroll
            for (int nb = 0; nb < 4; ++nb) mma_tf32(acc[m][nb], ah, bh[nb]);
          }
        }
#pragma unroll
        for (int m = 0; m < kPass; ++m) {
          const int mt = mp + m;
          if (mt < mt_lo || mt >= mt_hi) continue;
#pragma unroll
          for (int nb = 0; nb < 4; ++nb) {
#pragma unroll
            for (int p = 0; p < 2; ++p) {
              if (t_at[nb][p] < 0) continue;
              float* tp = s_t + t_at[nb][p] + 16 * mt;
              tp[0] = acc[m][nb][p];
              tp[8] = acc[m][nb][2 + p];
            }
          }
        }
      }
    }
    __syncthreads();
    dx_fold<T, C>(s_t, dx, n, m0, j0, h, wd, h_out, w_out, rows, tid, nthreads);
  }
}

template <typename T, int C, bool VEC>
int launch_dx(const T* x, const T* w, const T* b, const T* g, long long sn, long long so,
              long long sh, long long sw, T* dx, int batch, int h, int wd, int warps, int blocks,
              int smem, int rows, cudaStream_t stream) {
  const int h_out = (h + 1) / 2;
  const int w_out = (wd + 1) / 2;
  const int row_tiles = (h_out + rows - 1) / rows;
  const int col_tiles = (w_out + kTileW - 1) / kTileW;
  const long long tiles = static_cast<long long>(batch) * row_tiles * col_tiles;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<size_t>(smem) > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv_s2_dx_kernel<T, C, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  conv_s2_dx_kernel<T, C, VEC><<<blocks, warps * 32, smem, stream>>>(
      x, w, b, g, sn, so, sh, sw, dx, h, wd, h_out, w_out, rows, row_tiles, col_tiles,
      static_cast<int>(tiles));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int C>
int launch_dx_vec(const T* x, const T* w, const T* b, const T* g, long long sn, long long so,
                  long long sh, long long sw, T* dx, int batch, int h, int wd, int warps,
                  int blocks, int smem, int rows, cudaStream_t stream) {
  // Copies of 4 elements (16 bytes of f32, 8 of bf16) where a row is whole
  // chunks of 4 and x starts on a chunk.
  if ((static_cast<long long>(wd) * C) % 4 == 0 &&
      reinterpret_cast<uintptr_t>(x) % (4 * sizeof(T)) == 0) {
    return launch_dx<T, C, true>(x, w, b, g, sn, so, sh, sw, dx, batch, h, wd, warps, blocks,
                                 smem, rows, stream);
  }
  return launch_dx<T, C, false>(x, w, b, g, sn, so, sh, sw, dx, batch, h, wd, warps, blocks, smem,
                                rows, stream);
}

template <typename T>
int dispatch_dx_c(const void* x, const void* w, const void* b, const void* g, long long sn,
                  long long so, long long sh, long long sw, void* dx, int batch, int h, int wd,
                  int c, int warps, int blocks, int smem, int rows, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  const T* bt = static_cast<const T*>(b);
  const T* gt = static_cast<const T*>(g);
  T* dxt = static_cast<T*>(dx);
  switch (c) {
    case 1:
      return launch_dx_vec<T, 1>(xt, wt, bt, gt, sn, so, sh, sw, dxt, batch, h, wd, warps, blocks,
                                 smem, rows, stream);
    case 2:
      return launch_dx_vec<T, 2>(xt, wt, bt, gt, sn, so, sh, sw, dxt, batch, h, wd, warps, blocks,
                                 smem, rows, stream);
    case 3:
      return launch_dx_vec<T, 3>(xt, wt, bt, gt, sn, so, sh, sw, dxt, batch, h, wd, warps, blocks,
                                 smem, rows, stream);
    case 4:
      return launch_dx_vec<T, 4>(xt, wt, bt, gt, sn, so, sh, sw, dxt, batch, h, wd, warps, blocks,
                                 smem, rows, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Tiles of 1 to kDxMaxRows output rows; 1 to kDxMaxWarps warps (a block's
// warps take a tile's items in turn); at least the shared memory the
// weights, the input tile and T take.
bool dx_plan_ok(int c, int warps, int smem, int rows) {
  return c >= 1 && c <= 4 && rows >= 1 && rows <= kDxMaxRows && warps >= 1 &&
         warps <= kDxMaxWarps && smem >= 0 && static_cast<size_t>(smem) >= dx_smem_of(c, rows) &&
         static_cast<size_t>(smem) <= kMaxSmem;
}

}  // namespace

// Each F is a library of its own (kernels.py builds conv_s2.cu once for each),
// named conv_s2, conv_s2_f16 and conv_s2_f8: the error string takes the
// library's name.
#if CONV_F == 32
#define CONV_S2_ERROR_STRING conv_s2_error_string
#elif CONV_F == 16
#define CONV_S2_ERROR_STRING conv_s2_f16_error_string
#else
#define CONV_S2_ERROR_STRING conv_s2_f8_error_string
#endif

extern "C" const char* CONV_S2_ERROR_STRING(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: 0 = float32 and 1 = bfloat16, for x, w, b and y alike; 2 = a
// bfloat16 x with float32 w, b and y (a data_dtype="bfloat16" batch meeting
// the f32 model). warps, blocks and smem: the launch plan
// (kernels.py:conv_plan).
extern "C" int conv4x4s2_swish(const void* x, const void* w, const void* b, void* y, int batch,
                               int h, int wd, int c, int dtype, int warps, int blocks, int smem,
                               cudaStream_t stream) {
  if (batch <= 0 || h <= 0 || wd <= 0 || blocks <= 0 || !plan_ok(c, warps, smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0) {
    return dispatch_c<float, float>(x, w, b, y, batch, h, wd, c, warps, blocks, smem, stream);
  }
  if (dtype == 1) {
    return dispatch_c<__nv_bfloat16, __nv_bfloat16>(x, w, b, y, batch, h, wd, c, warps, blocks,
                                                    smem, stream);
  }
  if (dtype == 2) {
    return dispatch_c<__nv_bfloat16, float>(x, w, b, y, batch, h, wd, c, warps, blocks, smem,
                                            stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// dtype: as conv4x4s2_swish's: 0 = float32 x, w, b, g, dw and db; 1 = all
// bfloat16 (dw and db rounded once from their f32 sums); 2 = a bfloat16 x
// with the rest float32. g is read through its strides (sn, so, sh, sw, in
// elements), so a view of the next stage's padded gradient needs no copy;
// ws holds blocks x (16 c + 1) x 32 floats. warps, blocks, smem and rows (a
// tile's output rows): the launch plan (kernels.py:conv_bwd_plan).
extern "C" int conv4x4s2_swish_bwd(const void* x, const void* w, const void* b, const void* g,
                                   long long sn, long long so, long long sh, long long sw,
                                   void* ws, void* dw, void* db, int batch, int h, int wd, int c,
                                   int dtype, int warps, int blocks, int smem, int rows,
                                   cudaStream_t stream) {
  if (batch <= 0 || h <= 0 || wd <= 0 || blocks <= 0 || sn < 0 || so < 0 || sh < 0 || sw < 0 ||
      !bwd_plan_ok(c, warps, smem, rows)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0) {
    return dispatch_bwd_c<float, float>(x, w, b, g, sn, so, sh, sw, ws, dw, db, batch, h, wd, c,
                                        warps, blocks, smem, rows, stream);
  }
  if (dtype == 1) {
    return dispatch_bwd_c<__nv_bfloat16, __nv_bfloat16>(x, w, b, g, sn, so, sh, sw, ws, dw, db,
                                                         batch, h, wd, c, warps, blocks, smem,
                                                         rows, stream);
  }
  if (dtype == 2) {
    return dispatch_bwd_c<__nv_bfloat16, float>(x, w, b, g, sn, so, sh, sw, ws, dw, db, batch, h,
                                                wd, c, warps, blocks, smem, rows, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// dtype: 0 = float32 and 1 = bfloat16, for x, w, b, g and dx alike (dx
// rounded once from its f32 sum). g is read through its strides (sn, so,
// sh, sw, in elements); dx is (batch, h, wd, c), NHWC, every element
// written. warps, blocks, smem and rows (a tile's output rows): the launch
// plan (kernels.py:conv_dx_plan).
extern "C" int conv4x4s2_swish_dx(const void* x, const void* w, const void* b, const void* g,
                                  long long sn, long long so, long long sh, long long sw,
                                  void* dx, int batch, int h, int wd, int c, int dtype, int warps,
                                  int blocks, int smem, int rows, cudaStream_t stream) {
  if (batch <= 0 || h <= 0 || wd <= 0 || blocks <= 0 || sn < 0 || so < 0 || sh < 0 || sw < 0 ||
      !dx_plan_ok(c, warps, smem, rows)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0) {
    return dispatch_dx_c<float>(x, w, b, g, sn, so, sh, sw, dx, batch, h, wd, c, warps, blocks,
                                smem, rows, stream);
  }
  if (dtype == 1) {
    return dispatch_dx_c<__nv_bfloat16>(x, w, b, g, sn, so, sh, sw, dx, batch, h, wd, c, warps,
                                        blocks, smem, rows, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
