// 4x4 stride-2 SAME conv + bias + swish, NHWC in, NCHW out, for Hopper
// (sm_90a).
//
// conv4x4s2_swish replaces tools/pallas_conv_probe.py:pallas_conv0 (the
// kernel through its pallas_call): for an image x (B, H, W, C) in NHWC, a
// weight w (32, C, 4, 4) in PyTorch's OIHW and a bias b (32,),
//     y[n, o, i, j] = swish(b[o] + sum_{ky,kx,c} x[n, 2i+ky-pt, 2j+kx-pl, c]
//                                                * w[o, c, ky, kx]),
// with XLA's SAME padding: per dim the total pad is
// max((ceil(d/2) - 1) * 2 + 4 - d, 0), and the low side (pt, pl) gets half
// of it, rounded down, which is 1 at every size. Out of range input reads
// as 0. y is (B, 32, ceil(H/2), ceil(W/2)), NCHW, so the next stage (a
// cuDNN conv) takes it as it is. It is the first stage of the CelebA image
// encoder.
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
// wide (a chunk of the row), all 32 channels: one warp. Its input is 4 rows
// of 66 columns (2 * 32 + 2, the SAME pad and the image edges zero-filled),
// staged f32 in the warp's own slice of shared memory as NHWC rows, each
// shifted by `lead` floats so that the image's 16-byte chunks land on
// 16-byte boundaries. Lane (t, g) = (lane % 8, lane / 8) owns 4 adjacent
// output pixels (4t..4t+3) x 8 channels (8g..8g+7): 32 accumulators. Per
// input row a lane reads its window of 10 columns x C as float4s (the 4
// pixels' 4 taps), and per (tap, c) the 8 weights of its channels as two
// float4s: 32 FMAs per weight pair, 12 FMAs per shared-memory load.
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
// bits. The output is written in the input's type (round to nearest even
// for bf16). No fast-math: expf tracks the plain PyTorch version to rounding.
//
// The backward, conv4x4s2_swish_bwd: the gradient of the weight and the
// bias (not of x) given the upstream gradient g (B, 32, ceil(H/2),
// ceil(W/2)) of y, f32 only. With pre = b[o] + the conv sum,
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
// (3.15 MB) and g (8.39 MB), 3.4 us at 3.35 TB/s; per (output, channel)
// pair the recompute's 48 FMAs, the swish' and the 49 FMAs of the
// accumulation, 0.42 GFLOP, 6.3 us at 67 TFLOP/s of f32: it is bound by
// operations, and its outputs are 32 x 49 sums of 65,536 terms each.
//
// Design (the first, simple form). A unit is the forward's: 32 output
// pixels of one output row of one image, one warp. The warp stages the
// unit's 4 input rows (66 columns from column -1 on, zero where the pad
// or the edge falls) and its 32 x 32 tile of g, transposed, in its slice of
// shared memory. Lane o owns output channel o: its 16 * C weights in
// registers and 16 * C + 1 running sums (dw's row and db). Per pair of
// adjacent pixels and input row it reads the pair's window (6 columns x C,
// float4 broadcasts: every lane reads the same address) once for the
// recompute and once for the accumulation. A block of `warps` warps walks
// units with the grid's stride, then sums its warps' sums in a fixed order
// into its row of a workspace; a second launch sums the rows, in a fixed
// order (8 chains of every 8th row, then the 8 chains), into dw and db. No atomics: two calls with the same plan give the
// same bits. No fast-math.
//
// C interface (bound with ctypes): conv4x4s2_swish launches on `stream`
// with the plan it is given (warps a block, blocks, dynamic shared memory),
// does not synchronise, and returns cudaGetLastError() of its launch (or
// cudaErrorInvalidValue for arguments it does not take);
// conv4x4s2_swish_bwd likewise, for its two launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kCout = 32;
constexpr int kTaps = 16;
constexpr int kPx = 4;                     // output pixels a lane
constexpr int kCh = 8;                     // output channels a lane
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

__device__ __forceinline__ float swish(float v) { return v * (1.0f / (1.0f + expf(-v))); }

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

template <typename T, int C, bool VEC>
__global__ void __launch_bounds__(kMaxWarps * 32, 2)
    conv_s2_tiles_kernel(const T* __restrict__ x, const T* __restrict__ w,
                         const T* __restrict__ bias, T* __restrict__ y, int h, int wd,
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
  const float4* s_w4 = reinterpret_cast<const float4*>(s_w);
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
          const int wi = ((ky * 4 + kx) * C + c) * (kCout / 4) + 2 * g;
          const float4 w0 = s_w4[wi];
          const float4 w1 = s_w4[wi + 1];
#pragma unroll
          for (int p = 0; p < kPx; ++p) {
            const float xv = xin[lead(C) + (2 * p + kx) * C + c];
            acc[p][0] = fmaf(xv, w0.x, acc[p][0]);
            acc[p][1] = fmaf(xv, w0.y, acc[p][1]);
            acc[p][2] = fmaf(xv, w0.z, acc[p][2]);
            acc[p][3] = fmaf(xv, w0.w, acc[p][3]);
            acc[p][4] = fmaf(xv, w1.x, acc[p][4]);
            acc[p][5] = fmaf(xv, w1.y, acc[p][5]);
            acc[p][6] = fmaf(xv, w1.z, acc[p][6]);
            acc[p][7] = fmaf(xv, w1.w, acc[p][7]);
          }
        }
      }
    }

    const int ox = chunk * kTileW + kPx * t;
    const int valid = min(kPx, w_out - ox);
    T* yo = y + (static_cast<size_t>(n) * kCout + kCh * g) * plane +
            static_cast<size_t>(oy) * w_out + ox;
#pragma unroll
    for (int o = 0; o < kCh; ++o) {
      const float b = s_b[kCh * g + o];
      float r[kPx];
#pragma unroll
      for (int p = 0; p < kPx; ++p) r[p] = swish(acc[p][o] + b);
      if (valid > 0) store4(yo + o * plane, r, valid, vec_out != 0);
    }
  }
}

template <typename T, int C, bool VEC>
cudaError_t set_smem(int smem) {
  if (static_cast<size_t>(smem) <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(conv_s2_tiles_kernel<T, C, VEC>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <typename T, int C>
int launch(const void* x, const void* w, const void* b, void* y, int batch, int h, int wd,
           int warps, int blocks, int smem, cudaStream_t stream) {
  const int h_out = (h + 1) / 2;
  const int w_out = (wd + 1) / 2;
  const int n_chunks = (w_out + kTileW - 1) / kTileW;
  const long long units = static_cast<long long>(batch) * h_out * n_chunks;
  if (units > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  constexpr uintptr_t kAlign = 4 * sizeof(T);  // a chunk of 4 elements
  const bool vec_in = (static_cast<long long>(wd) * C) % 4 == 0 &&
                      reinterpret_cast<uintptr_t>(x) % kAlign == 0;
  const int vec_out = w_out % 4 == 0 && reinterpret_cast<uintptr_t>(y) % kAlign == 0;
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  const T* bt = static_cast<const T*>(b);
  T* yt = static_cast<T*>(y);
  cudaError_t err;
  if (vec_in) {
    err = set_smem<T, C, true>(smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    conv_s2_tiles_kernel<T, C, true><<<blocks, warps * 32, smem, stream>>>(
        xt, wt, bt, yt, h, wd, h_out, w_out, n_chunks, static_cast<int>(units), vec_out);
  } else {
    err = set_smem<T, C, false>(smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    conv_s2_tiles_kernel<T, C, false><<<blocks, warps * 32, smem, stream>>>(
        xt, wt, bt, yt, h, wd, h_out, w_out, n_chunks, static_cast<int>(units), vec_out);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_c(const void* x, const void* w, const void* b, void* y, int batch, int h, int wd,
               int c, int warps, int blocks, int smem, cudaStream_t stream) {
  switch (c) {
    case 1: return launch<T, 1>(x, w, b, y, batch, h, wd, warps, blocks, smem, stream);
    case 2: return launch<T, 2>(x, w, b, y, batch, h, wd, warps, blocks, smem, stream);
    case 3: return launch<T, 3>(x, w, b, y, batch, h, wd, warps, blocks, smem, stream);
    case 4: return launch<T, 4>(x, w, b, y, batch, h, wd, warps, blocks, smem, stream);
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

// Float4s of one staged row that a pair of adjacent output pixels reads:
// 6 columns x c floats.
__host__ __device__ constexpr int bwd_nv(int c) { return (6 * c + 3) / 4; }
// Floats of one staged input row of the backward: column -1 at offset 0,
// 66 columns of c, and room for the last pair's float4 window (from column
// 60 on), rounded up to a float4.
__host__ __device__ constexpr int bwd_row_floats(int c) {
  return ((kTileCols * c > 60 * c + 4 * bwd_nv(c) ? kTileCols * c : 60 * c + 4 * bwd_nv(c)) + 3) /
         4 * 4;
}
constexpr int kGStride = kCout + 1;  // a staged pixel's 32 channels, one float of pad
// Floats of a warp's slice: the 4 rows and the g tile. It also holds the
// warp's (16 * c + 1) x 32 sums at the end.
__host__ __device__ constexpr int bwd_warp_floats(int c) {
  return 4 * bwd_row_floats(c) + kTileW * kGStride;
}
size_t bwd_smem_of(int c, int warps) {
  return sizeof(float) * static_cast<size_t>(warps) * bwd_warp_floats(c);
}

// swish'(u) = s (1 + u (1 - s)), s = 1 / (1 + e^-u).
__device__ __forceinline__ float dswish(float u) {
  const float s = 1.0f / (1.0f + expf(-u));
  return s * (1.0f + u * (1.0f - s));
}

template <int C>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
    conv_s2_bwd_partials_kernel(const float* __restrict__ x, const float* __restrict__ w,
                                const float* __restrict__ bias, const float* __restrict__ g,
                                long long sn, long long so, long long sh, long long sw,
                                float* __restrict__ ws, int h, int wd, int h_out, int w_out,
                                int n_chunks, int units) {
  constexpr int kK = kTaps * C;  // the sums of dw's row: [ky][kx][c]
  constexpr int kRow = bwd_row_floats(C);
  constexpr int kNV = bwd_nv(C);
  constexpr int kSlice = bwd_warp_floats(C);
  constexpr int kStage = 4 * kRow;
  constexpr int kPerLane = (kStage + 31) / 32;
  extern __shared__ __align__(16) float smem[];
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* buf = smem + warp * kSlice;  // [row][col -1 .. 64][c]
  float* sg = buf + kStage;           // [pixel][channel], padded rows
  const int o = lane;

  float wr[kK];
#pragma unroll
  for (int ky = 0; ky < 4; ++ky) {
#pragma unroll
    for (int kx = 0; kx < 4; ++kx) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        wr[(ky * 4 + kx) * C + c] = __ldg(w + ((o * C + c) * 4 + ky) * 4 + kx);
      }
    }
  }
  const float bo = __ldg(bias + o);
  float acc[kK + 1];
#pragma unroll
  for (int k = 0; k <= kK; ++k) acc[k] = 0.0f;

  const long long row_len = static_cast<long long>(wd) * C;
  for (int u = blockIdx.x * warps + warp; u < units; u += gridDim.x * warps) {
    const int chunk = u % n_chunks;
    const int rest = u / n_chunks;
    const int oy = rest % h_out;
    const int n = rest / h_out;
    // Every load of the unit first: the 4 input rows, then lane q's pixel
    // of g in each of the 32 channels.
    float v[kPerLane];
    const long long c0 = static_cast<long long>(chunk * 2 * kTileW - 1) * C;
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int idx = lane + 32 * k;
      const int r = idx / kRow;
      const int s = idx - r * kRow;
      const int iy = 2 * oy - 1 + r;
      const long long col = c0 + s;
      const bool ok = idx < kStage && s < kTileCols * C && iy >= 0 && iy < h && col >= 0 &&
                      col < row_len;
      v[k] = ok ? __ldg(x + (static_cast<long long>(n) * h + iy) * row_len + col) : 0.0f;
    }
    const int ox = chunk * kTileW + lane;
    const float* gp = g + n * sn + oy * sh + static_cast<long long>(ox) * sw;
    float gv[kCout];
#pragma unroll
    for (int oc = 0; oc < kCout; ++oc) gv[oc] = ox < w_out ? __ldg(gp + oc * so) : 0.0f;
    __syncwarp();  // the previous unit is no longer read
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int idx = lane + 32 * k;
      if (idx < kStage) buf[idx] = v[k];
    }
#pragma unroll
    for (int oc = 0; oc < kCout; ++oc) sg[lane * kGStride + oc] = gv[oc];
    __syncwarp();

#pragma unroll 1
    for (int p = 0; p < kTileW / 2; ++p) {
      // The pair's window starts at column 2 * (2p) - 1, float 4 p C of a
      // row: a float4 boundary.
      const float4* win4 = reinterpret_cast<const float4*>(buf) + p * C;
      float part0[4], part1[4];
#pragma unroll
      for (int ky = 0; ky < 4; ++ky) {
        float win[4 * kNV];
#pragma unroll
        for (int i = 0; i < kNV; ++i) {
          const float4 t = win4[ky * (kRow / 4) + i];
          win[4 * i + 0] = t.x;
          win[4 * i + 1] = t.y;
          win[4 * i + 2] = t.z;
          win[4 * i + 3] = t.w;
        }
        float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
        for (int kx = 0; kx < 4; ++kx) {
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const float wv = wr[(ky * 4 + kx) * C + c];
            a0 = fmaf(wv, win[kx * C + c], a0);
            a1 = fmaf(wv, win[(kx + 2) * C + c], a1);
          }
        }
        part0[ky] = a0;
        part1[ky] = a1;
      }
      const float u0 = bo + ((part0[0] + part0[1]) + (part0[2] + part0[3]));
      const float u1 = bo + ((part1[0] + part1[1]) + (part1[2] + part1[3]));
      const float s0 = sg[(2 * p) * kGStride + o] * dswish(u0);
      const float s1 = sg[(2 * p + 1) * kGStride + o] * dswish(u1);
#pragma unroll
      for (int ky = 0; ky < 4; ++ky) {
        float win[4 * kNV];
#pragma unroll
        for (int i = 0; i < kNV; ++i) {
          const float4 t = win4[ky * (kRow / 4) + i];
          win[4 * i + 0] = t.x;
          win[4 * i + 1] = t.y;
          win[4 * i + 2] = t.z;
          win[4 * i + 3] = t.w;
        }
#pragma unroll
        for (int kx = 0; kx < 4; ++kx) {
#pragma unroll
          for (int c = 0; c < C; ++c) {
            float& a = acc[(ky * 4 + kx) * C + c];
            a = fmaf(s0, win[kx * C + c], a);
            a = fmaf(s1, win[(kx + 2) * C + c], a);
          }
        }
      }
      acc[kK] += s0;
      acc[kK] += s1;
    }
  }

  // The block's sums: each warp's into its slice, then warp 0's + warp 1's
  // + ... in that order, into the block's row of the workspace.
  __syncthreads();
  float* mine = smem + warp * kSlice;
#pragma unroll
  for (int k = 0; k <= kK; ++k) mine[k * kCout + lane] = acc[k];
  __syncthreads();
  constexpr int kOut = (kK + 1) * kCout;
  for (int i = threadIdx.x; i < kOut; i += blockDim.x) {
    float s = 0.0f;
    for (int wi = 0; wi < warps; ++wi) s += smem[wi * kSlice + i];
    ws[static_cast<size_t>(blockIdx.x) * kOut + i] = s;
  }
}

// dw and db from the blocks' rows of sums, entry t = k * 32 + o, k = (ky *
// 4 + kx) * c + ch (k = 16 c: the bias). A block takes one k, its 32
// entries (a 128-byte line of each row) and kReduceRows rows of threads:
// thread (o, y) sums rows y, y + kReduceRows, ... in order, then thread
// (o, 0) adds the kReduceRows sums in order. A fixed order throughout.
constexpr int kReduceRows = 8;

__global__ void __launch_bounds__(kCout * kReduceRows)
    conv_s2_bwd_reduce_kernel(const float* __restrict__ ws, float* __restrict__ dw,
                              float* __restrict__ db, int c, int parts) {
  __shared__ float part[kReduceRows][kCout];
  const int kk = kTaps * c;
  const int n_out = (kk + 1) * kCout;
  const int k = blockIdx.x;
  const int o = threadIdx.x;
  const int y = threadIdx.y;
  const float* src = ws + k * kCout + o;
  float s = 0.0f;
#pragma unroll 4
  for (int r = y; r < parts; r += kReduceRows) s += __ldg(src + static_cast<size_t>(r) * n_out);
  part[y][o] = s;
  __syncthreads();
  if (y != 0) return;
  float total = 0.0f;
#pragma unroll
  for (int i = 0; i < kReduceRows; ++i) total += part[i][o];
  if (k == kk) {
    db[o] = total;
    return;
  }
  const int ky = k / (4 * c);
  const int kx = (k / c) % 4;
  const int ch = k % c;
  dw[((o * c + ch) * 4 + ky) * 4 + kx] = total;
}

template <int C>
int launch_bwd(const float* x, const float* w, const float* b, const float* g, long long sn,
               long long so, long long sh, long long sw, float* ws, float* dw, float* db,
               int batch, int h, int wd, int warps, int blocks, int smem, cudaStream_t stream) {
  const int h_out = (h + 1) / 2;
  const int w_out = (wd + 1) / 2;
  const int n_chunks = (w_out + kTileW - 1) / kTileW;
  const long long units = static_cast<long long>(batch) * h_out * n_chunks;
  if (units > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSuccess;
  if (static_cast<size_t>(smem) > kDefaultSmem) {
    err = cudaFuncSetAttribute(conv_s2_bwd_partials_kernel<C>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  conv_s2_bwd_partials_kernel<C><<<blocks, warps * 32, smem, stream>>>(
      x, w, b, g, sn, so, sh, sw, ws, h, wd, h_out, w_out, n_chunks, static_cast<int>(units));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  conv_s2_bwd_reduce_kernel<<<kTaps * C + 1, dim3(kCout, kReduceRows), 0, stream>>>(
      ws, dw, db, C, blocks);
  return static_cast<int>(cudaGetLastError());
}

bool bwd_plan_ok(int c, int warps, int smem) {
  return c >= 1 && c <= 4 && warps >= 1 && warps <= kMaxWarps && smem >= 0 &&
         static_cast<size_t>(smem) >= bwd_smem_of(c, warps) &&
         static_cast<size_t>(smem) <= kMaxSmem;
}

}  // namespace

extern "C" const char* conv_s2_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: 0 = float32, 1 = bfloat16, for x, w, b and y alike. warps, blocks
// and smem: the launch plan (kernels.py:conv_plan).
extern "C" int conv4x4s2_swish(const void* x, const void* w, const void* b, void* y, int batch,
                               int h, int wd, int c, int dtype, int warps, int blocks, int smem,
                               cudaStream_t stream) {
  if (batch <= 0 || h <= 0 || wd <= 0 || blocks <= 0 || !plan_ok(c, warps, smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0) {
    return dispatch_c<float>(x, w, b, y, batch, h, wd, c, warps, blocks, smem, stream);
  }
  if (dtype == 1) {
    return dispatch_c<__nv_bfloat16>(x, w, b, y, batch, h, wd, c, warps, blocks, smem, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// f32 only. g is read through its strides (sn, so, sh, sw, in elements),
// so a view of the next stage's padded gradient needs no copy; ws holds
// blocks x (16 c + 1) x 32 floats. warps, blocks and smem: the launch plan
// (kernels.py:conv_bwd_plan).
extern "C" int conv4x4s2_swish_bwd(const void* x, const void* w, const void* b, const void* g,
                                   long long sn, long long so, long long sh, long long sw,
                                   void* ws, void* dw, void* db, int batch, int h, int wd, int c,
                                   int warps, int blocks, int smem, cudaStream_t stream) {
  if (batch <= 0 || h <= 0 || wd <= 0 || blocks <= 0 || sn < 0 || so < 0 || sh < 0 || sw < 0 ||
      !bwd_plan_ok(c, warps, smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  const float* gf = static_cast<const float*>(g);
  float* wsf = static_cast<float*>(ws);
  float* dwf = static_cast<float*>(dw);
  float* dbf = static_cast<float*>(db);
  switch (c) {
    case 1:
      return launch_bwd<1>(xf, wf, bf, gf, sn, so, sh, sw, wsf, dwf, dbf, batch, h, wd, warps,
                           blocks, smem, stream);
    case 2:
      return launch_bwd<2>(xf, wf, bf, gf, sn, so, sh, sw, wsf, dwf, dbf, batch, h, wd, warps,
                           blocks, smem, stream);
    case 3:
      return launch_bwd<3>(xf, wf, bf, gf, sn, so, sh, sw, wsf, dwf, dbf, batch, h, wd, warps,
                           blocks, smem, stream);
    case 4:
      return launch_bwd<4>(xf, wf, bf, gf, sn, so, sh, sw, wsf, dwf, dbf, batch, h, wd, warps,
                           blocks, smem, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
