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
// of it, rounded down. Out of range input reads as 0. y is (B, 32,
// ceil(H/2), ceil(W/2)), NCHW, so the next stage (a cuDNN conv) takes it as
// it is. It is the first stage of the CelebA image encoder.
//
// The TPU kernel padded the input and pre-split it into the four stride
// parities with XLA, so that every tap read a contiguous window (C = 3
// lanes pad to 128 in VMEM, and strided loads were out), then accumulated
// 16 taps x 3 channels of broadcast FMAs per block of 8 images. Here
// nothing is pre-split: x is read once, straight from the batch.
//
// What bounds it: memory. At the CelebA eval shape (64, 64, 64, 3) f32 it
// reads 3.15 MB and writes 8.39 MB, 3.4 us at 3.35 TB/s; its 2 * 48 FMAs
// per output (210 MFLOP with the swish) take 3.1 us at 67 TFLOP/s of f32.
//
// Design: one block of 128 threads owns one image and a band of output
// rows. It stages the band's 2 * rows + 2 input rows (zero-filled where the
// SAME pad or the image edge falls), the 6 KB of weights (as [tap][c][o], so
// a thread reads the 32 output channels of one tap as 8 float4) and the
// bias in shared memory, converted to f32. Each thread then owns one output
// pixel at a time and keeps its 32 output channels in registers; bias and
// swish are fused into the one store, and the 32 threads of a warp store
// neighbouring pixels of one channel plane, so the stores coalesce.
// Accumulation is f32 for f32 and bf16 inputs; the output is written in the
// input's type (round to nearest even for bf16).
// No fast-math: expf tracks the plain PyTorch version to rounding.
//
// C interface (bound with ctypes): conv4x4s2_swish launches on `stream`,
// does not synchronise, and returns cudaGetLastError() of its launch (or
// cudaErrorInvalidValue for arguments it does not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>

namespace {

constexpr int kCout = 32;
constexpr int kTaps = 16;
constexpr int kThreads = 128;
constexpr int kMaxBandRows = 8;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
    conv_s2_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const T* __restrict__ bias, T* __restrict__ y, int h,
                   int wd, int h_out, int w_out, int pad_top, int pad_left,
                   int band, int n_bands) {
  extern __shared__ __align__(16) float smem[];
  float* s_w = smem;                       // [tap][c][o]
  float* s_b = s_w + kTaps * C * kCout;    // [o]
  float* s_x = s_b + kCout;                // [row][col][c]
  const int n = blockIdx.x / n_bands;
  const int oy0 = (blockIdx.x % n_bands) * band;
  const int rows = min(band, h_out - oy0);
  const int wp = 2 * w_out + 2;
  const int iy0 = 2 * oy0 - pad_top;
  const int ix0 = -pad_left;

  for (int i = threadIdx.x; i < kCout * C * kTaps; i += blockDim.x) {
    const int o = i / (C * kTaps);
    const int c = (i / kTaps) % C;
    const int tap = i % kTaps;
    s_w[(tap * C + c) * kCout + o] = to_f32(w[i]);
  }
  if (threadIdx.x < kCout) s_b[threadIdx.x] = to_f32(bias[threadIdx.x]);
  // The band's input rows: consecutive threads read consecutive (col, c)
  // elements of an NHWC row, which lie next to each other in memory.
  const T* xn = x + static_cast<size_t>(n) * h * wd * C;
  const int n_in = (2 * rows + 2) * wp * C;
  for (int i = threadIdx.x; i < n_in; i += blockDim.x) {
    const int c = i % C;
    const int col = (i / C) % wp;
    const int row = i / (C * wp);
    const int iy = iy0 + row;
    const int ix = ix0 + col;
    float v = 0.0f;
    if (iy >= 0 && iy < h && ix >= 0 && ix < wd) {
      v = to_f32(xn[(static_cast<size_t>(iy) * wd + ix) * C + c]);
    }
    s_x[i] = v;
  }
  __syncthreads();

  const size_t plane = static_cast<size_t>(h_out) * w_out;
  T* yn = y + static_cast<size_t>(n) * kCout * plane;
  for (int p = threadIdx.x; p < rows * w_out; p += blockDim.x) {
    const int r = p / w_out;
    const int ox = p % w_out;
    float acc[kCout];
#pragma unroll
    for (int o = 0; o < kCout; ++o) acc[o] = 0.0f;
    // The tap loops stay rolled: unrolled, the compiler hoists every
    // tap's weights into registers (255 of them, and kilobytes of spills).
#pragma unroll 1
    for (int ky = 0; ky < 4; ++ky) {
      const float* xrow = s_x + ((2 * r + ky) * wp + 2 * ox) * C;
#pragma unroll 1
      for (int kx = 0; kx < 4; ++kx) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float xv = xrow[kx * C + c];
          const float4* w4 =
              reinterpret_cast<const float4*>(s_w + ((ky * 4 + kx) * C + c) * kCout);
#pragma unroll
          for (int q = 0; q < kCout / 4; ++q) {
            const float4 wv = w4[q];
            acc[4 * q + 0] = fmaf(xv, wv.x, acc[4 * q + 0]);
            acc[4 * q + 1] = fmaf(xv, wv.y, acc[4 * q + 1]);
            acc[4 * q + 2] = fmaf(xv, wv.z, acc[4 * q + 2]);
            acc[4 * q + 3] = fmaf(xv, wv.w, acc[4 * q + 3]);
          }
        }
      }
    }
    const size_t pix = static_cast<size_t>(oy0 + r) * w_out + ox;
#pragma unroll
    for (int o = 0; o < kCout; ++o) {
      const float v = acc[o] + s_b[o];
      yn[o * plane + pix] = from_f32<T>(v * (1.0f / (1.0f + expf(-v))));
    }
  }
}

size_t smem_bytes(int c, int band, int w_out) {
  return sizeof(float) *
         (static_cast<size_t>(kTaps) * c * kCout + kCout +
          static_cast<size_t>(2 * band + 2) * (2 * static_cast<size_t>(w_out) + 2) * c);
}

template <typename T, int C>
int launch(const void* x, const void* w, const void* b, void* y, int batch,
           int h, int wd, cudaStream_t stream) {
  const int h_out = (h + 1) / 2;
  const int w_out = (wd + 1) / 2;
  const int pad_h = std::max((h_out - 1) * 2 + 4 - h, 0);
  const int pad_w = std::max((w_out - 1) * 2 + 4 - wd, 0);
  // About one output pixel per thread: a band of rows that fills a block.
  int band = std::min({std::max(kThreads / w_out, 1), kMaxBandRows, h_out});
  while (band > 1 && smem_bytes(C, band, w_out) > kDefaultSmem) band /= 2;
  const size_t bytes = smem_bytes(C, band, w_out);
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (bytes > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv_s2_kernel<T, C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int n_bands = (h_out + band - 1) / band;
  const long long blocks = static_cast<long long>(n_bands) * batch;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  conv_s2_kernel<T, C><<<static_cast<unsigned>(blocks), kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(b), static_cast<T*>(y), h, wd, h_out, w_out,
      pad_h / 2, pad_w / 2, band, n_bands);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_c(const void* x, const void* w, const void* b, void* y,
               int batch, int h, int wd, int c, cudaStream_t stream) {
  switch (c) {
    case 1: return launch<T, 1>(x, w, b, y, batch, h, wd, stream);
    case 2: return launch<T, 2>(x, w, b, y, batch, h, wd, stream);
    case 3: return launch<T, 3>(x, w, b, y, batch, h, wd, stream);
    case 4: return launch<T, 4>(x, w, b, y, batch, h, wd, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" const char* conv_s2_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: 0 = float32, 1 = bfloat16, for x, w, b and y alike.
extern "C" int conv4x4s2_swish(const void* x, const void* w, const void* b,
                               void* y, int batch, int h, int wd, int c,
                               int dtype, cudaStream_t stream) {
  if (batch <= 0 || h <= 0 || wd <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0) return dispatch_c<float>(x, w, b, y, batch, h, wd, c, stream);
  if (dtype == 1) {
    return dispatch_c<__nv_bfloat16>(x, w, b, y, batch, h, wd, c, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
