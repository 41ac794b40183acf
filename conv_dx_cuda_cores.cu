// K4's input gradient in its first form, kept for conv_dx_split.py to time
// beside the kernel that replaced it (mmvae_torch/ops/csrc/conv_s2.cu
// conv4x4s2_swish_dx): the same function, dx[n, h, w, c] = sum over
// (o, ky, kx) of S[n, o, i, j] w[o, c, ky, kx] with 2 i + ky - 1 = h, 2 j +
// kx - 1 = w, S = g swish'(pre), pre recomputed, f32 on the CUDA cores.
//
// A block takes a tile of TR output rows by 32 output columns of one image
// (one block a tile). A thread a pixel recomputes S for the tile's pixels
// and the ring around them into shared memory, its 4 x 4 x C input window
// loaded from global memory, pre 4 output channels at a time against the
// weights staged as float4s; then a thread a 2 x 2 quad of input pixels
// gathers its covering output pixels' S times the weights, 4 channels at a
// time, in a fixed order.
//
// C interface (bound with ctypes by conv_dx_split.py): conv_dx_cuda_cores
// launches on `stream` with threads a block, rows a tile and the dynamic
// shared memory it is given, and returns cudaGetLastError() of its launch
// (cudaErrorInvalidValue for arguments it does not take).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kCout = 32;
constexpr int kTaps = 16;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;

// swish'(u) = s (1 + u (1 - s)), s = 1 / (1 + e^-u): the reciprocal by
// __fdividef (2 ulp; 0 once e^-u passes 2^126, as s should be).
__device__ __forceinline__ float dswish(float u) {
  const float s = __fdividef(1.0f, 1.0f + expf(-u));
  return s * (1.0f + u * (1.0f - s));
}

constexpr int kDxTileW = 32;             // output columns of a tile
constexpr int kDxCols = kDxTileW + 2;    // S columns a tile stages, its halo with them
constexpr int kDxPix = kCout + 4;        // floats of a staged S pixel (4 past 32: no conflicts)
constexpr int kO4 = kCout / 4;           // output channels in float4s
constexpr int kDxMaxThreads = 256;
constexpr int kDxMaxRows = 16;

// The weights as float4s over 4 output channels, [o4][tap][c], then the
// S tile: TR + 2 rows of kDxCols pixels of kDxPix floats.
size_t dx_smem_of(int c, int rows) {
  return sizeof(float) * (static_cast<size_t>(kO4) * kTaps * c * 4 +
                          static_cast<size_t>(rows + 2) * kDxCols * kDxPix);
}

// One tile: output rows m0 .. m0 + TR - 1 and columns j0 .. j0 + 31 of
// image n, whose input rows 2 m0 .. 2 m0 + 2 TR - 1 and columns 2 j0 ..
// 2 j0 + 63 it writes dx for.
template <int C>
__global__ void __launch_bounds__(kDxMaxThreads)
    conv_s2_dx_kernel(const float* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ bias, const float* __restrict__ g, long long sn,
                      long long so, long long sh, long long sw, float* __restrict__ dx, int h,
                      int wd, int h_out, int w_out, int rows, int row_tiles, int col_tiles) {
  extern __shared__ __align__(16) float smem[];
  float4* s_w = reinterpret_cast<float4*>(smem);  // [o4][tap][c]: w[4 o4 .. 4 o4 + 3, c, tap]
  float* s_s = smem + kO4 * kTaps * C * 4;         // [row][col][o]
  const int ct = blockIdx.x % col_tiles;
  const int rest = blockIdx.x / col_tiles;
  const int m0 = rest % row_tiles * rows;
  const int n = rest / row_tiles;
  const int j0 = ct * kDxTileW;

  for (int i = threadIdx.x; i < kO4 * kTaps * C; i += blockDim.x) {
    const int c = i % C, tap = i / C % kTaps, o4 = i / (C * kTaps);
    const float* src = w + (4 * o4 * C + c) * kTaps + tap;
    s_w[i] = make_float4(__ldg(src), __ldg(src + C * kTaps), __ldg(src + 2 * C * kTaps),
                         __ldg(src + 3 * C * kTaps));
  }
  __syncthreads();

  // S = g swish'(pre) of the tile's output pixels and the ring around
  // them (0 outside the output), a thread a pixel: its 4 x 4 x C window
  // in registers, pre recomputed 4 channels at a time.
  const int s_pixels = (rows + 2) * kDxCols;
  for (int p = threadIdx.x; p < s_pixels; p += blockDim.x) {
    const int i = m0 - 1 + p / kDxCols;
    const int j = j0 - 1 + p % kDxCols;
    float4* dst = reinterpret_cast<float4*>(s_s + p * kDxPix);
    if (i < 0 || i >= h_out || j < 0 || j >= w_out) {
#pragma unroll
      for (int o4 = 0; o4 < kO4; ++o4) dst[o4] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      continue;
    }
    float xw[kTaps * C];
#pragma unroll
    for (int ky = 0; ky < 4; ++ky) {
      const int iy = 2 * i - 1 + ky;
#pragma unroll
      for (int kx = 0; kx < 4; ++kx) {
        const int ix = 2 * j - 1 + kx;
        const bool ok = iy >= 0 && iy < h && ix >= 0 && ix < wd;
        const float* src = x + ((static_cast<long long>(n) * h + iy) * wd + ix) * C;
#pragma unroll
        for (int c = 0; c < C; ++c) xw[(ky * 4 + kx) * C + c] = ok ? __ldg(src + c) : 0.0f;
      }
    }
    const float* gp = g + n * sn + i * sh + j * sw;
#pragma unroll 1
    for (int o4 = 0; o4 < kO4; ++o4) {
      const float4* wv = s_w + o4 * kTaps * C;
      float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int k = 0; k < kTaps * C; ++k) {
        const float4 wk = wv[k];
        a[0] = fmaf(xw[k], wk.x, a[0]);
        a[1] = fmaf(xw[k], wk.y, a[1]);
        a[2] = fmaf(xw[k], wk.z, a[2]);
        a[3] = fmaf(xw[k], wk.w, a[3]);
      }
      float s[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int o = 4 * o4 + e;
        s[e] = __ldg(gp + o * so) * dswish(a[e] + __ldg(bias + o));
      }
      dst[o4] = make_float4(s[0], s[1], s[2], s[3]);
    }
  }
  __syncthreads();

  // dx, a thread a 2 x 2 quad of input pixels (2m + ph, 2q + pw): each
  // reads the S pixels (m + di, q + dj) with di in {ph - 1, ph}, dj in
  // {pw - 1, pw} at tap (ph + 1 - 2 di, pw + 1 - 2 dj); the 3 x 3 S pixels
  // around (m, q) serve the quad. Sums over o4, then the taps, then the 4
  // channels: a fixed order.
  for (int qd = threadIdx.x; qd < rows * kDxTileW; qd += blockDim.x) {
    const int qm = qd / kDxTileW, qq = qd % kDxTileW;
    const int m = m0 + qm, q = j0 + qq;
    if (2 * m >= h || 2 * q >= wd) continue;
    float acc[2][2][C];
#pragma unroll
    for (int ph = 0; ph < 2; ++ph) {
#pragma unroll
      for (int pw = 0; pw < 2; ++pw) {
#pragma unroll
        for (int c = 0; c < C; ++c) acc[ph][pw][c] = 0.0f;
      }
    }
    const float* centre = s_s + ((qm + 1) * kDxCols + qq + 1) * kDxPix;
#pragma unroll 1
    for (int o4 = 0; o4 < kO4; ++o4) {
      float4 sv[3][3];
#pragma unroll
      for (int di = 0; di < 3; ++di) {
#pragma unroll
        for (int dj = 0; dj < 3; ++dj) {
          sv[di][dj] = *reinterpret_cast<const float4*>(
              centre + ((di - 1) * kDxCols + dj - 1) * kDxPix + 4 * o4);
        }
      }
      const float4* wv = s_w + o4 * kTaps * C;
#pragma unroll
      for (int ph = 0; ph < 2; ++ph) {
#pragma unroll
        for (int pw = 0; pw < 2; ++pw) {
#pragma unroll
          for (int di = ph - 1; di <= ph; ++di) {
#pragma unroll
            for (int dj = pw - 1; dj <= pw; ++dj) {
              const int tap = (ph + 1 - 2 * di) * 4 + pw + 1 - 2 * dj;
              const float4 s4 = sv[di + 1][dj + 1];
#pragma unroll
              for (int c = 0; c < C; ++c) {
                const float4 wk = wv[tap * C + c];
                float v = acc[ph][pw][c];
                v = fmaf(s4.x, wk.x, v);
                v = fmaf(s4.y, wk.y, v);
                v = fmaf(s4.z, wk.z, v);
                acc[ph][pw][c] = fmaf(s4.w, wk.w, v);
              }
            }
          }
        }
      }
    }
#pragma unroll
    for (int ph = 0; ph < 2; ++ph) {
#pragma unroll
      for (int pw = 0; pw < 2; ++pw) {
        const int hh = 2 * m + ph, ww = 2 * q + pw;
        if (hh >= h || ww >= wd) continue;
        float* out = dx + ((static_cast<long long>(n) * h + hh) * wd + ww) * C;
#pragma unroll
        for (int c = 0; c < C; ++c) out[c] = acc[ph][pw][c];
      }
    }
  }
}

template <int C>
int launch_dx(const float* x, const float* w, const float* b, const float* g, long long sn,
              long long so, long long sh, long long sw, float* dx, int batch, int h, int wd,
              int threads, int rows, int smem, cudaStream_t stream) {
  const int h_out = (h + 1) / 2;
  const int w_out = (wd + 1) / 2;
  const int row_tiles = (h_out + rows - 1) / rows;
  const int col_tiles = (w_out + kDxTileW - 1) / kDxTileW;
  const long long tiles = static_cast<long long>(batch) * row_tiles * col_tiles;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<size_t>(smem) > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv_s2_dx_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  conv_s2_dx_kernel<C><<<static_cast<unsigned>(tiles), threads, smem, stream>>>(
      x, w, b, g, sn, so, sh, sw, dx, h, wd, h_out, w_out, rows, row_tiles, col_tiles);
  return static_cast<int>(cudaGetLastError());
}

// Whole warps, at most kDxMaxThreads; 1 to kDxMaxRows output rows a tile;
// at least the shared memory the weights and the S tile take.
bool dx_plan_ok(int c, int threads, int rows, int smem) {
  return c >= 1 && c <= 4 && threads >= 32 && threads <= kDxMaxThreads && threads % 32 == 0 &&
         rows >= 1 && rows <= kDxMaxRows && smem >= 0 &&
         static_cast<size_t>(smem) >= dx_smem_of(c, rows) &&
         static_cast<size_t>(smem) <= kMaxSmem;
}

}  // namespace

extern "C" const char* conv_dx_cuda_cores_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// f32 only. g is read through its strides (sn, so, sh, sw, in elements);
// dx is (batch, h, wd, c), NHWC, every element written. One block a tile.
extern "C" int conv_dx_cuda_cores(const void* x, const void* w, const void* b, const void* g,
                                  long long sn, long long so, long long sh, long long sw,
                                  void* dx, int batch, int h, int wd, int c, int threads,
                                  int rows, int smem, cudaStream_t stream) {
  if (batch <= 0 || h <= 0 || wd <= 0 || sn < 0 || so < 0 || sh < 0 || sw < 0 ||
      !dx_plan_ok(c, threads, rows, smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  const float* gf = static_cast<const float*>(g);
  float* dxf = static_cast<float*>(dx);
  switch (c) {
    case 1:
      return launch_dx<1>(xf, wf, bf, gf, sn, so, sh, sw, dxf, batch, h, wd, threads, rows,
                          smem, stream);
    case 2:
      return launch_dx<2>(xf, wf, bf, gf, sn, so, sh, sw, dxf, batch, h, wd, threads, rows,
                          smem, stream);
    case 3:
      return launch_dx<3>(xf, wf, bf, gf, sn, so, sh, sw, dxf, batch, h, wd, threads, rows,
                          smem, stream);
    case 4:
      return launch_dx<4>(xf, wf, bf, gf, sn, so, sh, sw, dxf, batch, h, wd, threads, rows,
                          smem, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
