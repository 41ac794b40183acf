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
// a tiled x is read once per tile from L2). At the eval shapes the data is
// tiny -- KL (300, 64): 154,800 B, 46 ns at 3.35 TB/s; BCE (200, 784) with
// untiled (100, 784) targets: 941,600 B, 0.28 us -- so both sit on the
// launch floor (an empty launch: about 1.5 us in a CUDA graph). The evals
// therefore no longer launch kl_rows: the KL runs as the epilogue of the
// kernel that fuses its inputs (poe_kl.cu), and kl_rows stays the
// standalone op. At CelebA's image rows, BCE (128, 12288) against 64
// untiled targets, it is 9.4 MB, 2.8 us: there the card has to be kept
// busy.
//
// KL: one warp per row, rows grid-strided over a fixed number of blocks.
// Each lane walks the row with stride 32 (16-byte float4 loads when
// D % 4 == 0 and every pointer is 16-byte aligned, scalar loads
// otherwise), accumulating in f32 registers; a shuffle reduce finishes
// the row. The loop bound handles any D, so no column masking is needed.
//
// BCE takes its layout from the caller (kernels.py's bce_plan picks it
// from the shape and the card's SM count):
//   * layout 0, a warp per row, as KL: many short rows fill the card;
//   * layout 1, a row split over a cluster of `split` blocks (split 1: a
//     block per row), for few long rows. One warp a row would leave most
//     SMs idle: 128 rows make 16 blocks of 8 warps on 16 of 132 SMs. Each
//     block reduces its chunk of the row with kUnroll float4 loads of each
//     input in flight a thread, then a shuffle tree and its warps' sums in
//     order into shared memory. Rank 0 of the cluster reads the other
//     blocks' sums through distributed shared memory (map_shared_rank,
//     between two cluster barriers) and writes the row: one launch, no
//     scratch buffer, no atomics;
//   * layout 2, a thread per row, for rows of a few elements (CelebA's
//     attributes at D = 1), where a warp a row idles 31 lanes.
// Every layout sums in a fixed order, so a shape gives the same bits from
// run to run.
// No fast-math: expf/log1pf track the plain PyTorch version to rounding.
//
// C interface (bound with ctypes): each function launches on `stream`,
// does not synchronise, and returns cudaGetLastError() of its launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kMaxBlocks = 4096;
constexpr int kUnroll = 4;     // float4 loads of each input a thread has in flight
constexpr int kMaxSplit = 8;   // the portable cluster size

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

// The target row that logits row `row` is scored against.
__device__ __forceinline__ int target_row(int row, int n, int n_x, int fold) {
  return fold == 0 ? row : (fold == 1 ? row % n_x : row / (n / n_x));
}

// Layout 0: one warp per row.
template <bool kVec>
__global__ void bce_rows_kernel(const float* __restrict__ logits,
                                const float* __restrict__ x,
                                float* __restrict__ out, int n, int d,
                                int n_x, int fold) {
  const int lane = threadIdx.x % kWarp;
  const int warps = blockDim.x / kWarp;
  const int warp = blockIdx.x * warps + threadIdx.x / kWarp;
  const int n_warps = gridDim.x * warps;
  for (int row = warp; row < n; row += n_warps) {
    const size_t base = static_cast<size_t>(row) * d;
    const size_t x_base = static_cast<size_t>(target_row(row, n, n_x, fold)) * d;
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

// Layout 1: blocks blockIdx.x = row * split + rank, a cluster of `split`
// blocks per row, each block a contiguous chunk of the row (in float4s
// when kVec).
template <bool kVec>
__global__ void __launch_bounds__(1024) bce_split_kernel(const float* __restrict__ logits,
                                 const float* __restrict__ x,
                                 float* __restrict__ out, int n, int d,
                                 int n_x, int fold, int split) {
  __shared__ float warp_sums[1024 / kWarp];
  __shared__ float block_sum;
  const int row = blockIdx.x / split;
  const int rank = blockIdx.x % split;
  const int tid = threadIdx.x, threads = blockDim.x;
  const float* l = logits + static_cast<size_t>(row) * d;
  const float* t = x + static_cast<size_t>(target_row(row, n, n_x, fold)) * d;
  const int units = kVec ? d / 4 : d;
  const int per = (units + split - 1) / split;
  const int lo = rank * per, hi = min(units, lo + per);
  float acc = 0.0f;
  if (kVec) {
    const float4* l4 = reinterpret_cast<const float4*>(l);
    const float4* t4 = reinterpret_cast<const float4*>(t);
    for (int c = lo + tid; c < hi; c += kUnroll * threads) {
      float4 a[kUnroll], b[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = c + u * threads;
        if (i < hi) {
          a[u] = l4[i];
          b[u] = t4[i];
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (c + u * threads < hi) {
          acc += bce_term(a[u].x, b[u].x) + bce_term(a[u].y, b[u].y) +
                 bce_term(a[u].z, b[u].z) + bce_term(a[u].w, b[u].w);
        }
      }
    }
  } else {
    constexpr int kScalar = 2 * kUnroll;
    for (int c = lo + tid; c < hi; c += kScalar * threads) {
      float a[kScalar], b[kScalar];
#pragma unroll
      for (int u = 0; u < kScalar; ++u) {
        const int i = c + u * threads;
        if (i < hi) {
          a[u] = l[i];
          b[u] = t[i];
        }
      }
#pragma unroll
      for (int u = 0; u < kScalar; ++u) {
        if (c + u * threads < hi) acc += bce_term(a[u], b[u]);
      }
    }
  }
  acc = warp_sum(acc);
  if (tid % kWarp == 0) warp_sums[tid / kWarp] = acc;
  __syncthreads();
  if (tid == 0) {
    float sum = 0.0f;
    for (int w = 0; w < threads / kWarp; ++w) sum += warp_sums[w];
    block_sum = sum;
    if (split == 1) out[row] = sum;
  }
  if (split == 1) return;  // the same for every block of the grid
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every block's sum is in its shared memory
  if (rank == 0 && tid == 0) {
    float sum = 0.0f;
    for (int r = 0; r < split; ++r) sum += *cluster.map_shared_rank(&block_sum, r);
    out[row] = sum;
  }
  cluster.sync();  // no block leaves while rank 0 reads its shared memory
}

// Layout 2: one thread per row.
__global__ void bce_thread_rows_kernel(const float* __restrict__ logits,
                                       const float* __restrict__ x,
                                       float* __restrict__ out, int n, int d,
                                       int n_x, int fold) {
  const int stride = gridDim.x * blockDim.x;
  for (int row = blockIdx.x * blockDim.x + threadIdx.x; row < n; row += stride) {
    const size_t base = static_cast<size_t>(row) * d;
    const size_t x_base = static_cast<size_t>(target_row(row, n, n_x, fold)) * d;
    float acc = 0.0f;
    for (int c = 0; c < d; ++c) acc += bce_term(logits[base + c], x[x_base + c]);
    out[row] = acc;
  }
}

template <bool kVec>
cudaError_t launch_split(const float* logits, const float* x, float* out,
                         int n, int d, int n_x, int fold, int threads,
                         int split, cudaStream_t stream) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(n * split);
  config.blockDim = dim3(threads);
  config.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = split;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  config.attrs = cluster;
  config.numAttrs = split > 1 ? 1 : 0;  // a block per row needs no cluster
  return cudaLaunchKernelEx(&config, bce_split_kernel<kVec>, logits, x, out, n,
                            d, n_x, fold, split);
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

// layout 0: `blocks` blocks of `threads` (a multiple of 32), a warp per
// row; layout 1: n * split blocks of `threads` in clusters of `split`
// (1-8), `blocks` == n * split; layout 2: `blocks` blocks of `threads`, a
// thread per row.
extern "C" int bce_rows(const float* logits, const float* x, float* out,
                        int n, int d, int n_x, int fold, int layout,
                        int threads, int split, int blocks,
                        cudaStream_t stream) {
  if (n <= 0 || d < 0 || n_x <= 0 || fold < 0 || fold > 2 ||
      (fold == 0 && n_x != n) || (fold != 0 && n % n_x != 0) || layout < 0 ||
      layout > 2 || threads < kWarp || threads > 1024 || threads % kWarp != 0 ||
      blocks < 1 || split < 1 || split > kMaxSplit ||
      (layout == 1 && static_cast<long long>(n) * split != blocks)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = d % 4 == 0 && aligned16(logits) && aligned16(x);
  if (layout == 1) {
    const cudaError_t rc =
        vec ? launch_split<true>(logits, x, out, n, d, n_x, fold, threads, split, stream)
            : launch_split<false>(logits, x, out, n, d, n_x, fold, threads, split, stream);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  } else if (layout == 2) {
    bce_thread_rows_kernel<<<blocks, threads, 0, stream>>>(logits, x, out, n, d,
                                                           n_x, fold);
  } else if (vec) {
    bce_rows_kernel<true><<<blocks, threads, 0, stream>>>(logits, x, out, n, d,
                                                          n_x, fold);
  } else {
    bce_rows_kernel<false><<<blocks, threads, 0, stream>>>(logits, x, out, n, d,
                                                           n_x, fold);
  }
  return static_cast<int>(cudaGetLastError());
}
