// Row reductions (N, D) -> (N,) of the MVAE ELBO and their gradients, for
// Hopper (sm_90a).
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
// and, in bce_rows_inner, the b-major tiling of examples that each hold
// `inner` rows (event_ndims = 0 over CelebA's 18 attributes: logits row
// (b * k + t) * inner + a reads x row b * inner + a), which reduces to
// fold 2 at inner = 1.
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
// bce_rows_inner is a thread a row too, over a 3-D grid of (inner row a,
// term t, example b): the row and its target row are a multiply-add each
// of indices the grid gives, so no divide stands before a load (at the
// IWAE's (73728, 1) the data is 0.18 us at 3.35 TB/s and a divide costs
// as much), and a block's threads run along (t, a), contiguous in the
// logits, so its loads coalesce.
// Every layout sums in a fixed order, so a shape gives the same bits from
// run to run.
// The targets may be float32 or bfloat16 (the data_dtype="bfloat16" train
// split, as the Pallas kernel takes them: mmvae_tpu/ops/kernels.py:175-177);
// a bf16 target is upcast as it is loaded (its bits are the high half of
// its f32), four at a time in 8 bytes where the float4 path runs, so every
// layout and row map is the f32 one with the target reads halved. The
// logits and the sums stay f32. At MNIST's train shape (200, 784) against
// 100 bf16 targets: 0.79 MB, 0.24 us at 3.35 TB/s.
// No fast-math: expf/log1pf track the plain PyTorch version to rounding.
//
// The gradients, the VJPs of the TPU kernels (mmvae_tpu/ops/kernels.py
// _kl_bwd and _bce_bwd), for an upstream gradient g of one value a row:
//     kl_rows_grad:  dmu = g * mu,  dlv = 0.5 * g * (exp(lv) - 1);
//     bce_rows_grad: dlogits = g * (sigmoid(l) - x[target row]),
// the targets read through the forward's row map, so they stay untiled
// (bce_rows_grad_inner: bce_rows_inner's map, in its grid), in
// float32 or bfloat16 as bce_rows reads them (d x, -g * l summed over the
// rows that read a target row, is not computed: no ported loss
// differentiates the targets). Both are
// elementwise and bound by memory: they read the (N, D) inputs and write
// (N, D) gradients once -- KL (1280, 100): 2.05 MB, 0.61 us at 3.35 TB/s;
// BCE (200, 784) against 100 untiled targets: 1.57 MB, 0.47 us. Each
// element is computed alone, so a shape gives the same bits every run and
// in every launch layout.
//
// kl_rows_grad: a thread takes a float4 of each input (scalars when D % 4
// != 0 or a pointer is not 16-byte aligned), elements grid-strided over a
// fixed number of blocks.
//
// bce_rows_grad takes its launch from the caller (kernels.py's
// bce_grad_plan). At the train shapes it sits about a microsecond above an
// empty launch, so what costs is the chain a thread runs before its loads.
// The grid is 3-D, (chunk of a row, target row, term), so a thread's logits
// row, target row and g[row] come from blockIdx and threadIdx by one
// multiply-add: no divide stands before a load (a 64-bit divide in front of
// each float4 costs about as much as the data at these shapes). A row
// of more than 128 units takes blocks of 128 threads a chunk; a shorter
// row takes as many lanes as it has units and a block as many rows as fill
// whole warps, so CelebA's attribute rows (D = 1) take a thread a row with
// no idle lane. One unit a thread: at every path shape more blocks beat
// 2 or 4 units a thread in flight (PERF.md section 6).
//
// C interface (bound with ctypes): each function launches on `stream`,
// does not synchronise, and returns cudaGetLastError() of its launch.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// A target as f32: a float, or a bf16 (the high half of its f32).
__device__ __forceinline__ float load_x(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float load_x(const __nv_bfloat16* p, size_t i) {
  return __uint_as_float(static_cast<unsigned>(__bfloat16_as_ushort(p[i])) << 16);
}
// Targets 4c .. 4c + 3 of p as f32: a float4, or 8 bytes of bf16.
__device__ __forceinline__ float4 load_x4(const float* p, size_t c) {
  return reinterpret_cast<const float4*>(p)[c];
}
__device__ __forceinline__ float4 load_x4(const __nv_bfloat16* p, size_t c) {
  const uint2 v = reinterpret_cast<const uint2*>(p)[c];
  return make_float4(__uint_as_float(v.x << 16), __uint_as_float(v.x & 0xffff0000u),
                     __uint_as_float(v.y << 16), __uint_as_float(v.y & 0xffff0000u));
}

// The target row that logits row `row` is scored against.
__device__ __forceinline__ int target_row(int row, int n, int n_x, int fold) {
  return fold == 0 ? row : (fold == 1 ? row % n_x : row / (n / n_x));
}

// Layout 0: one warp per row.
template <bool kVec, typename T>
__global__ void bce_rows_kernel(const float* __restrict__ logits,
                                const T* __restrict__ x,
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
      for (int c = lane; c < d / 4; c += kWarp) {
        const float4 a = l4[c];
        const float4 b = load_x4(x + x_base, c);
        acc += bce_term(a.x, b.x) + bce_term(a.y, b.y) + bce_term(a.z, b.z) +
               bce_term(a.w, b.w);
      }
    } else {
      for (int c = lane; c < d; c += kWarp) {
        acc += bce_term(logits[base + c], load_x(x, x_base + c));
      }
    }
    acc = warp_sum(acc);
    if (lane == 0) out[row] = acc;
  }
}

// Layout 1: blocks blockIdx.x = row * split + rank, a cluster of `split`
// blocks per row, each block a contiguous chunk of the row (in float4s
// when kVec).
template <bool kVec, typename T>
__global__ void __launch_bounds__(1024) bce_split_kernel(const float* __restrict__ logits,
                                 const T* __restrict__ x,
                                 float* __restrict__ out, int n, int d,
                                 int n_x, int fold, int split) {
  __shared__ float warp_sums[1024 / kWarp];
  __shared__ float block_sum;
  const int row = blockIdx.x / split;
  const int rank = blockIdx.x % split;
  const int tid = threadIdx.x, threads = blockDim.x;
  const float* l = logits + static_cast<size_t>(row) * d;
  const T* t = x + static_cast<size_t>(target_row(row, n, n_x, fold)) * d;
  const int units = kVec ? d / 4 : d;
  const int per = (units + split - 1) / split;
  const int lo = rank * per, hi = min(units, lo + per);
  float acc = 0.0f;
  if (kVec) {
    const float4* l4 = reinterpret_cast<const float4*>(l);
    for (int c = lo + tid; c < hi; c += kUnroll * threads) {
      float4 a[kUnroll], b[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = c + u * threads;
        if (i < hi) {
          a[u] = l4[i];
          b[u] = load_x4(t, i);
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
          b[u] = load_x(t, i);
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
template <typename T>
__global__ void bce_thread_rows_kernel(const float* __restrict__ logits,
                                       const T* __restrict__ x,
                                       float* __restrict__ out, int n, int d,
                                       int n_x, int fold) {
  const int stride = gridDim.x * blockDim.x;
  for (int row = blockIdx.x * blockDim.x + threadIdx.x; row < n; row += stride) {
    const size_t base = static_cast<size_t>(row) * d;
    const size_t x_base = static_cast<size_t>(target_row(row, n, n_x, fold)) * d;
    float acc = 0.0f;
    for (int c = 0; c < d; ++c) acc += bce_term(logits[base + c], load_x(x, x_base + c));
    out[row] = acc;
  }
}

// The b-major map of examples of `inner` rows: (a, t, b) from the grid,
// each axis strided by its grid (x: the inner rows, y: the terms, z: the
// examples).
template <typename T>
__global__ void bce_inner_rows_kernel(const float* __restrict__ logits,
                                      const T* __restrict__ x,
                                      float* __restrict__ out, int n_b, int k,
                                      int inner, int d) {
  for (int b = blockIdx.z; b < n_b; b += gridDim.z) {
    for (int t = blockIdx.y * blockDim.y + threadIdx.y; t < k;
         t += gridDim.y * blockDim.y) {
      for (int a = blockIdx.x * blockDim.x + threadIdx.x; a < inner;
           a += gridDim.x * blockDim.x) {
        const size_t row = (static_cast<size_t>(b) * k + t) * inner + a;
        const size_t x_row = static_cast<size_t>(b) * inner + a;
        float acc = 0.0f;
        for (int c = 0; c < d; ++c) {
          acc += bce_term(logits[row * d + c], load_x(x, x_row * d + c));
        }
        out[row] = acc;
      }
    }
  }
}

template <bool kVec, typename T>
cudaError_t launch_split(const float* logits, const T* x, float* out,
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
  return cudaLaunchKernelEx(&config, bce_split_kernel<kVec, T>, logits, x, out, n,
                            d, n_x, fold, split);
}

// The summands of the gradients, in the plain version's order.
__device__ __forceinline__ float kl_dlv(float half_g, float lv) {
  return half_g * (expf(lv) - 1.0f);
}

__device__ __forceinline__ float bce_dlogit(float g, float l, float x) {
  return g * (1.0f / (1.0f + expf(-l)) - x);
}

// KL's gradient: element i of the (n, d) rows, in float4s when kVec.
template <bool kVec>
__global__ void kl_rows_grad_kernel(const float* __restrict__ mu,
                                    const float* __restrict__ lv,
                                    const float* __restrict__ g,
                                    float* __restrict__ dmu,
                                    float* __restrict__ dlv,
                                    long long n_elems, int d) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (kVec) {
    const int d4 = d / 4;
    const float4* m4 = reinterpret_cast<const float4*>(mu);
    const float4* l4 = reinterpret_cast<const float4*>(lv);
    float4* dm4 = reinterpret_cast<float4*>(dmu);
    float4* dl4 = reinterpret_cast<float4*>(dlv);
    for (long long i = first; i < n_elems / 4; i += stride) {
      const float gr = g[i / d4];
      const float h = 0.5f * gr;
      const float4 a = m4[i];
      const float4 b = l4[i];
      dm4[i] = make_float4(gr * a.x, gr * a.y, gr * a.z, gr * a.w);
      dl4[i] = make_float4(kl_dlv(h, b.x), kl_dlv(h, b.y), kl_dlv(h, b.z), kl_dlv(h, b.w));
    }
  } else {
    for (long long i = first; i < n_elems; i += stride) {
      const float gr = g[i / d];
      dmu[i] = gr * mu[i];
      dlv[i] = kl_dlv(0.5f * gr, lv[i]);
    }
  }
}

__device__ __forceinline__ float4 bce_dlogit(float g, float4 l, float4 x) {
  return make_float4(bce_dlogit(g, l.x, x.x), bce_dlogit(g, l.y, x.y),
                     bce_dlogit(g, l.z, x.z), bce_dlogit(g, l.w, x.w));
}

template <bool kVec>
using GradUnit = typename std::conditional<kVec, float4, float>::type;

// Unit c of a row of targets as f32.
template <bool kVec, typename T>
__device__ __forceinline__ GradUnit<kVec> load_unit(const T* row, int c) {
  if constexpr (kVec) {
    return load_x4(row, c);
  } else {
    return load_x(row, c);
  }
}

// BCE's gradient in the logits. A unit is a float4 (kVec) or a float of a
// row of `units` units, one a thread. The grid walks (chunk of a row,
// target row b, term t): blockIdx.x the chunks of blockDim.x units,
// blockIdx.y * blockDim.y + threadIdx.y the target rows, blockIdx.z the
// terms, each axis strided by its grid. The logits row is t * n_x + b
// (t-major, or no fold at k == 1) or b * k + t (b-major): a multiply, so no
// divide stands before a load, and a thread issues its three loads (g, the
// logits, the target) before its first arithmetic.
template <bool kVec, typename T>
__global__ void __launch_bounds__(1024)
    bce_rows_grad_kernel(const float* __restrict__ logits, const T* __restrict__ x,
                         const float* __restrict__ g, float* __restrict__ dlogits,
                         int units, int n_x, int k, int fold_b) {
  using Unit = GradUnit<kVec>;
  constexpr int kElems = kVec ? 4 : 1;
  const Unit* l = reinterpret_cast<const Unit*>(logits);
  Unit* out = reinterpret_cast<Unit*>(dlogits);
  for (int t = blockIdx.z; t < k; t += gridDim.z) {
    for (int b = blockIdx.y * blockDim.y + threadIdx.y; b < n_x;
         b += gridDim.y * blockDim.y) {
      const int row = fold_b ? b * k + t : t * n_x + b;
      const float gr = g[row];
      const Unit* lr = l + static_cast<size_t>(row) * units;
      const T* xr = x + static_cast<size_t>(b) * units * kElems;
      Unit* dr = out + static_cast<size_t>(row) * units;
      for (int c = blockIdx.x * blockDim.x + threadIdx.x; c < units;
           c += gridDim.x * blockDim.x) {
        dr[c] = bce_dlogit(gr, lr[c], load_unit<kVec>(xr, c));
      }
    }
  }
}

// BCE's gradient in the logits at bce_rows_inner's map: the same grid of
// (inner row a, term t, example b), a thread a row. Logits row (b * k + t)
// * inner + a reads g at that row and x row b * inner + a, and writes its
// d elements of dlogits.
template <typename T>
__global__ void bce_inner_grad_rows_kernel(const float* __restrict__ logits,
                                           const T* __restrict__ x,
                                           const float* __restrict__ g,
                                           float* __restrict__ dlogits, int n_b, int k,
                                           int inner, int d) {
  for (int b = blockIdx.z; b < n_b; b += gridDim.z) {
    for (int t = blockIdx.y * blockDim.y + threadIdx.y; t < k;
         t += gridDim.y * blockDim.y) {
      for (int a = blockIdx.x * blockDim.x + threadIdx.x; a < inner;
           a += gridDim.x * blockDim.x) {
        const size_t row = (static_cast<size_t>(b) * k + t) * inner + a;
        const size_t x_row = static_cast<size_t>(b) * inner + a;
        const float gr = g[row];
        for (int c = 0; c < d; ++c) {
          dlogits[row * d + c] = bce_dlogit(gr, logits[row * d + c], load_x(x, x_row * d + c));
        }
      }
    }
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}
// Whether the targets at p can be read four at a time.
template <typename T>
bool aligned4(const T* p) {
  return reinterpret_cast<uintptr_t>(p) % (4 * sizeof(T)) == 0;
}

// Blocks of kGradThreads threads for `units` elementwise units, at most
// kMaxBlocks (the rest are grid-strided).
constexpr int kGradThreads = 256;

int grad_blocks(long long units) {
  const long long b = (units + kGradThreads - 1) / kGradThreads;
  return static_cast<int>(b < kMaxBlocks ? b : kMaxBlocks);
}

int n_blocks(int n) {
  const int b = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  return b < kMaxBlocks ? b : kMaxBlocks;
}

constexpr int kMaxGridYZ = 65535;
constexpr long long kIntEnd = 1LL << 31;

template <typename T>
int bce_rows_t(const float* logits, const T* x, float* out, int n, int d, int n_x, int fold,
               int layout, int threads, int split, int blocks, cudaStream_t stream) {
  const bool vec = d % 4 == 0 && aligned16(logits) && aligned4(x);
  if (layout == 1) {
    const cudaError_t rc =
        vec ? launch_split<true>(logits, x, out, n, d, n_x, fold, threads, split, stream)
            : launch_split<false>(logits, x, out, n, d, n_x, fold, threads, split, stream);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  } else if (layout == 2) {
    bce_thread_rows_kernel<<<blocks, threads, 0, stream>>>(logits, x, out, n, d, n_x, fold);
  } else if (vec) {
    bce_rows_kernel<true><<<blocks, threads, 0, stream>>>(logits, x, out, n, d, n_x, fold);
  } else {
    bce_rows_kernel<false><<<blocks, threads, 0, stream>>>(logits, x, out, n, d, n_x, fold);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bce_rows_grad_t(const float* logits, const T* x, const float* g, float* dlogits, int n,
                    int d, int n_x, int fold, int threads, int lanes, int grid_x, int grid_y,
                    int grid_z, cudaStream_t stream) {
  const bool vec = d % 4 == 0 && aligned16(logits) && aligned4(x) && aligned16(dlogits);
  const int units = vec ? d / 4 : d;
  const int k = n / n_x;
  const int rows = threads / lanes;
  // The indices the kernel strides to stay below 2^31.
  if (units + static_cast<long long>(grid_x) * lanes >= kIntEnd ||
      n_x + static_cast<long long>(grid_y) * rows >= kIntEnd ||
      k + static_cast<long long>(grid_z) >= kIntEnd) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(grid_x, grid_y, grid_z), block(lanes, rows);
  if (vec) {
    bce_rows_grad_kernel<true><<<grid, block, 0, stream>>>(logits, x, g, dlogits, units, n_x,
                                                           k, fold == 2);
  } else {
    bce_rows_grad_kernel<false><<<grid, block, 0, stream>>>(logits, x, g, dlogits, units, n_x,
                                                            k, fold == 2);
  }
  return static_cast<int>(cudaGetLastError());
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

// x_dtype: 0 = float32, 1 = bfloat16, of the targets x alone (the logits
// and out are f32). layout 0: `blocks` blocks of `threads` (a multiple of
// 32), a warp per row; layout 1: n * split blocks of `threads` in clusters
// of `split` (1-8), `blocks` == n * split; layout 2: `blocks` blocks of
// `threads`, a thread per row.
extern "C" int bce_rows(const float* logits, const void* x, float* out,
                        int n, int d, int n_x, int fold, int x_dtype, int layout,
                        int threads, int split, int blocks,
                        cudaStream_t stream) {
  if (n <= 0 || d < 0 || n_x <= 0 || fold < 0 || fold > 2 ||
      (fold == 0 && n_x != n) || (fold != 0 && n % n_x != 0) || layout < 0 ||
      layout > 2 || threads < kWarp || threads > 1024 || threads % kWarp != 0 ||
      blocks < 1 || split < 1 || split > kMaxSplit ||
      (layout == 1 && static_cast<long long>(n) * split != blocks) || x_dtype < 0 ||
      x_dtype > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (x_dtype == 1) {
    return bce_rows_t(logits, static_cast<const __nv_bfloat16*>(x), out, n, d, n_x, fold,
                      layout, threads, split, blocks, stream);
  }
  return bce_rows_t(logits, static_cast<const float*>(x), out, n, d, n_x, fold, layout,
                    threads, split, blocks, stream);
}

// logits: (n_b * k * inner, d) and out: (n_b * k * inner,), logits row
// (b * k + t) * inner + a scored against x row b * inner + a of x:
// (n_b * inner, d), float32 or bfloat16 (x_dtype 0 or 1); the rest f32; all
// contiguous. Blocks of (lanes, rows) threads (at most 1024) over a grid of
// (grid_x, grid_y, grid_z), y and z at most 65,535, every axis strided by
// its grid.
extern "C" int bce_rows_inner(const float* logits, const void* x, float* out,
                              int n_b, int k, int inner, int d, int x_dtype, int lanes,
                              int rows, int grid_x, int grid_y, int grid_z,
                              cudaStream_t stream) {
  if (n_b <= 0 || k <= 0 || inner <= 0 || d < 0 || lanes < 1 || rows < 1 ||
      lanes > 1024 || rows > 1024 || lanes * rows > 1024 || grid_x < 1 ||
      grid_y < 1 || grid_y > kMaxGridYZ || grid_z < 1 || grid_z > kMaxGridYZ ||
      static_cast<long long>(n_b) * k * inner >= kIntEnd ||
      inner + static_cast<long long>(grid_x) * lanes >= kIntEnd ||
      k + static_cast<long long>(grid_y) * rows >= kIntEnd || x_dtype < 0 || x_dtype > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(grid_x, grid_y, grid_z), block(lanes, rows);
  if (x_dtype == 1) {
    bce_inner_rows_kernel<<<grid, block, 0, stream>>>(
        logits, static_cast<const __nv_bfloat16*>(x), out, n_b, k, inner, d);
  } else {
    bce_inner_rows_kernel<<<grid, block, 0, stream>>>(logits, static_cast<const float*>(x),
                                                      out, n_b, k, inner, d);
  }
  return static_cast<int>(cudaGetLastError());
}

// mu, lv, dmu, dlv: (n, d); g: (n,); all f32, contiguous.
extern "C" int kl_rows_grad(const float* mu, const float* lv, const float* g,
                            float* dmu, float* dlv, int n, int d,
                            cudaStream_t stream) {
  if (n <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long n_elems = static_cast<long long>(n) * d;
  const bool vec = d % 4 == 0 && aligned16(mu) && aligned16(lv) && aligned16(dmu) &&
                   aligned16(dlv);
  const int blocks = grad_blocks(vec ? n_elems / 4 : n_elems);
  if (vec) {
    kl_rows_grad_kernel<true><<<blocks, kGradThreads, 0, stream>>>(mu, lv, g, dmu, dlv,
                                                                   n_elems, d);
  } else {
    kl_rows_grad_kernel<false><<<blocks, kGradThreads, 0, stream>>>(mu, lv, g, dmu, dlv,
                                                                    n_elems, d);
  }
  return static_cast<int>(cudaGetLastError());
}

// logits, dlogits: (n, d); x: (n_x, d) read through the row map `fold` as
// in bce_rows, float32 or bfloat16 (x_dtype 0 or 1); g: (n,); the rest f32;
// all contiguous. The plan: blocks of `threads` threads (a multiple of 32,
// at most 1024), `lanes` of them along a row (threads / lanes rows a
// block), a unit a thread (units: 4 elements where d % 4 == 0, the logits
// and dlogits are 16-byte aligned and x is aligned to 4 of its elements,
// else 1), a grid of (grid_x, grid_y, grid_z) blocks (y and z at most
// 65,535), every axis strided by its grid.
extern "C" int bce_rows_grad(const float* logits, const void* x, const float* g,
                             float* dlogits, int n, int d, int n_x, int fold, int x_dtype,
                             int threads, int lanes, int grid_x, int grid_y, int grid_z,
                             cudaStream_t stream) {
  if (n <= 0 || d <= 0 || n_x <= 0 || fold < 0 || fold > 2 || (fold == 0 && n_x != n) ||
      (fold != 0 && n % n_x != 0) || threads < kWarp || threads > 1024 ||
      threads % kWarp != 0 || lanes < 1 || threads % lanes != 0 || grid_x < 1 ||
      grid_y < 1 || grid_y > kMaxGridYZ || grid_z < 1 || grid_z > kMaxGridYZ ||
      x_dtype < 0 || x_dtype > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (x_dtype == 1) {
    return bce_rows_grad_t(logits, static_cast<const __nv_bfloat16*>(x), g, dlogits, n, d,
                           n_x, fold, threads, lanes, grid_x, grid_y, grid_z, stream);
  }
  return bce_rows_grad_t(logits, static_cast<const float*>(x), g, dlogits, n, d, n_x, fold,
                         threads, lanes, grid_x, grid_y, grid_z, stream);
}

// logits, dlogits: (n_b * k * inner, d); g: (n_b * k * inner,); x: (n_b *
// inner, d), float32 or bfloat16 (x_dtype 0 or 1), read through
// bce_rows_inner's map; the rest f32; all contiguous. The launch is
// bce_rows_inner's: blocks of (lanes, rows) threads over a grid of (grid_x,
// grid_y, grid_z), every axis strided by its grid.
extern "C" int bce_rows_grad_inner(const float* logits, const void* x, const float* g,
                                   float* dlogits, int n_b, int k, int inner, int d,
                                   int x_dtype, int lanes, int rows, int grid_x, int grid_y,
                                   int grid_z, cudaStream_t stream) {
  if (n_b <= 0 || k <= 0 || inner <= 0 || d <= 0 || lanes < 1 || rows < 1 ||
      lanes > 1024 || rows > 1024 || lanes * rows > 1024 || grid_x < 1 ||
      grid_y < 1 || grid_y > kMaxGridYZ || grid_z < 1 || grid_z > kMaxGridYZ ||
      static_cast<long long>(n_b) * k * inner >= kIntEnd ||
      inner + static_cast<long long>(grid_x) * lanes >= kIntEnd ||
      k + static_cast<long long>(grid_y) * rows >= kIntEnd || x_dtype < 0 || x_dtype > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(grid_x, grid_y, grid_z), block(lanes, rows);
  if (x_dtype == 1) {
    bce_inner_grad_rows_kernel<<<grid, block, 0, stream>>>(
        logits, static_cast<const __nv_bfloat16*>(x), g, dlogits, n_b, k, inner, d);
  } else {
    bce_inner_grad_rows_kernel<<<grid, block, 0, stream>>>(
        logits, static_cast<const float*>(x), g, dlogits, n_b, k, inner, d);
  }
  return static_cast<int>(cudaGetLastError());
}
