// Row reductions (N, D) -> (N,) of the MVAE ELBO, for Hopper (sm_90a).
//
// kl_rows replaces mmvae_tpu/ops/kernels.py:kl_std_normal_pallas
// (_kl_kernel through _rowwise_reduce): per row
//     -0.5 * sum_j (1 + lv - mu^2 - exp(lv)).
// bce_rows replaces mmvae_tpu/ops/kernels.py:bernoulli_nll_pallas
// (_bce_kernel through _rowwise_reduce): per row
//     sum_j max(l, 0) - l * x + log1p(exp(-|l|)),
// and reads its targets through a row map, so a term-tiled logits block
// is scored against ONE copy of the targets (the TPU path had to
// broadcast them, mmvae_tpu/ops/__init__.py:105-108):
//     fold 0: x row r            (n_x == n)
//     fold 1: x row r % n_x      (t-major tiling, row t * n_x + b)
//     fold 2: x row r / (n/n_x)  (b-major tiling, row b * k + t)
//
// What bounds them: memory. Each element costs about 5 flops and one
// transcendental against 8 bytes read (KL: mu + lv; BCE: logits + x, where
// a tiled x is read once per tile from L2). At the eval shapes of the
// MNIST slice the data is tiny -- KL (300, 64): 154,800 B, 46 ns at
// 3.35 TB/s; BCE (200, 784) with untiled (100, 784) targets: 941,600 B,
// 0.28 us -- so both are bound by launch latency, which fusing them into
// their producers or a CUDA graph over the eval batch would remove.
//
// Design: one warp per row, rows grid-strided over a fixed number of
// blocks. Each lane walks the row with stride 32 (16-byte float4 loads
// when D % 4 == 0 and every pointer is 16-byte aligned, scalar loads
// otherwise), accumulating in f32 registers; a shuffle reduce finishes
// the row. The loop bound handles any D, so no column masking is needed.
// No fast-math: expf/log1pf track the plain PyTorch version to rounding.
//
// C interface (bound with ctypes): each function launches on `stream`,
// does not synchronise, and returns cudaGetLastError() of its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kMaxBlocks = 4096;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// The summand of KL before the -0.5 scale, in the plain version's order.
__device__ __forceinline__ float kl_term(float mu, float lv) {
  return 1.0f + lv - mu * mu - expf(lv);
}

__device__ __forceinline__ float bce_term(float l, float x) {
  return fmaxf(l, 0.0f) - l * x + log1pf(expf(-fabsf(l)));
}

template <bool kVec>
__global__ void kl_rows_kernel(const float* __restrict__ mu,
                               const float* __restrict__ lv,
                               float* __restrict__ out, int n, int d) {
  const int lane = threadIdx.x % kWarp;
  const int warp = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  const int n_warps = gridDim.x * kWarpsPerBlock;
  for (int row = warp; row < n; row += n_warps) {
    const size_t base = static_cast<size_t>(row) * d;
    float acc = 0.0f;
    if (kVec) {
      const float4* m4 = reinterpret_cast<const float4*>(mu + base);
      const float4* l4 = reinterpret_cast<const float4*>(lv + base);
      for (int c = lane; c < d / 4; c += kWarp) {
        const float4 a = m4[c];
        const float4 b = l4[c];
        acc += kl_term(a.x, b.x) + kl_term(a.y, b.y) + kl_term(a.z, b.z) +
               kl_term(a.w, b.w);
      }
    } else {
      for (int c = lane; c < d; c += kWarp) {
        acc += kl_term(mu[base + c], lv[base + c]);
      }
    }
    acc = warp_sum(acc);
    if (lane == 0) out[row] = -0.5f * acc;
  }
}

template <bool kVec>
__global__ void bce_rows_kernel(const float* __restrict__ logits,
                                const float* __restrict__ x,
                                float* __restrict__ out, int n, int d,
                                int n_x, int fold) {
  const int lane = threadIdx.x % kWarp;
  const int warp = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  const int n_warps = gridDim.x * kWarpsPerBlock;
  const int k = n / n_x;
  for (int row = warp; row < n; row += n_warps) {
    const int x_row = fold == 0 ? row : (fold == 1 ? row % n_x : row / k);
    const size_t base = static_cast<size_t>(row) * d;
    const size_t x_base = static_cast<size_t>(x_row) * d;
    float acc = 0.0f;
    if (kVec) {
      const float4* l4 = reinterpret_cast<const float4*>(logits + base);
      const float4* x4 = reinterpret_cast<const float4*>(x + x_base);
      for (int c = lane; c < d / 4; c += kWarp) {
        const float4 a = l4[c];
        const float4 b = x4[c];
        acc += bce_term(a.x, b.x) + bce_term(a.y, b.y) + bce_term(a.z, b.z) +
               bce_term(a.w, b.w);
      }
    } else {
      for (int c = lane; c < d; c += kWarp) {
        acc += bce_term(logits[base + c], x[x_base + c]);
      }
    }
    acc = warp_sum(acc);
    if (lane == 0) out[row] = acc;
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

int n_blocks(int n) {
  const int b = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  return b < kMaxBlocks ? b : kMaxBlocks;
}

}  // namespace

extern "C" const char* row_reduce_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int kl_rows(const float* mu, const float* lv, float* out, int n,
                       int d, cudaStream_t stream) {
  if (n <= 0 || d < 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(n_blocks(n)), block(kWarp * kWarpsPerBlock);
  if (d % 4 == 0 && aligned16(mu) && aligned16(lv)) {
    kl_rows_kernel<true><<<grid, block, 0, stream>>>(mu, lv, out, n, d);
  } else {
    kl_rows_kernel<false><<<grid, block, 0, stream>>>(mu, lv, out, n, d);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bce_rows(const float* logits, const float* x, float* out,
                        int n, int d, int n_x, int fold,
                        cudaStream_t stream) {
  if (n <= 0 || d < 0 || n_x <= 0 || fold < 0 || fold > 2 ||
      (fold == 0 && n_x != n) || (fold != 0 && n % n_x != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(n_blocks(n)), block(kWarp * kWarpsPerBlock);
  if (d % 4 == 0 && aligned16(logits) && aligned16(x)) {
    bce_rows_kernel<true><<<grid, block, 0, stream>>>(logits, x, out, n, d,
                                                      n_x, fold);
  } else {
    bce_rows_kernel<false><<<grid, block, 0, stream>>>(logits, x, out, n, d,
                                                       n_x, fold);
  }
  return static_cast<int>(cudaGetLastError());
}
