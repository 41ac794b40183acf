// The masked product of experts of the MVAE eval and the KL of each fused
// posterior to N(0, I), in one launch, for Hopper (sm_90a).
//
// poe_kl replaces, on the ported paths, mmvae_tpu/ops/kernels.py:
// kl_std_normal_pallas (K1, _kl_kernel through _rowwise_reduce) as the
// epilogue of the PoE that produces its inputs (mmvae_tpu/train/step.py
// masked PoE, KL at the end of the t-fold). For the encoders' expert stack
// mu_e, lv_e (B, M, L), the subset masks (T, M) and an optional presence
// mask (B, M), per (t, b, l), with the unit-Gaussian prior's precision 1
// and eps = 1e-8, as the eval's step has always taken them:
//     p_m  = (1 / (exp(clamp(lv_e[b,m,l], -11, 11)) + eps))
//            * (masks[t,m] * presence[b,m])
//     tot  = 1 + sum_m p_m
//     mu_f = (sum_m mu_e[b,m,l] * p_m) / tot,    lv_f = -log(tot)
// and per (t, b), K1's function:
//     kl   = -0.5 * sum_l (1 + lv_f - mu_f^2 - exp(lv_f)).
// A row whose experts are all absent gives the prior: mu_f = 0, lv_f = 0,
// kl = 0 (the eval's padding rows).
//
// Why fused: K1 alone at CelebA's (1280, 100) moves 1 MB, a 0.31 us bound,
// and took about 2 us, most of it the launch; in front of it the PoE ran as
// a dozen PyTorch launches over (T, B, M, L) intermediates. The TPU package
// reached the same verdict and leaves its KL to XLA, which fuses it into
// the PoE (mmvae_tpu/ops/__init__.py _AUTO_TPU["kl"]).
//
// What bounds it: memory. It reads the expert stack once and writes the
// fused posteriors and the KLs once: 2.01 MB at CelebA's (T, B, M, L) =
// (20, 64, 19, 100), 0.60 us at 3.35 TB/s; 4 flops per (t, b, m, l) and a
// few transcendentals per expert element and per output are far below the
// f32 rate. At these sizes a launch takes longer than the bytes, so the
// design keeps the work to one launch with one round of load latency.
//
// Design. A block takes a batch row and a group of its terms (the plan
// splits a row's terms into groups where the rows alone leave SMs idle)
// and walks the row's latents in tiles: one, unless the row's slab passes
// the 227 KB of shared memory a block may hold, each tile staged after the
// last. For a tile the block stages mu_e[b] and p = 1 / (exp(clamp(lv)) +
// eps) for M x tile latents, so each expert element is read from device
// memory once and its exp and divide run once, not once a term; and, once,
// its group's term weights masks[t,m] * presence[b,m]. All its threads
// stage, every global load is issued before the first is used, and the
// plan gives a thread to each staged column so that one round covers the
// tile at the path shapes. Then the threads take (term, latent column)
// items, a column 4 latents (float4s) or one (scalars): a segment of
// `lanes` consecutive threads (a power of two, the plan's: those that
// cover the tile's columns, at most the block) takes a term, and each item
// sums over the experts in index order and writes mu_f and lv_f. The KL of
// (t, b) is reduced without atomics, in a fixed order: each lane sums its
// columns in order, a warp's lanes by shuffles (xor 16, 8, ..., 1), a
// segment's warps in order through shared memory where it spans more than
// one (MultiMNIST's 64 float4 columns, a T = 1 row of 256 scalars), and
// the tiles in order, the running sum kept in shared memory by the thread
// that adds each tile's. A shape gives the same bits from run to run. The
// block-a-row design this replaces gave a block a warp a term: at T = 1
// (the IWAE's joint posterior, every served call) its block was one warp,
// which staged CelebA's 19 x 100 slab in about 7 dependent rounds. A row's
// tiles as a thread block cluster, their partials summed through
// distributed shared memory, was timed no faster at any shape (a
// cluster's launch and barrier cost more than its tiles save; PERF.md
// section 6). No fast-math: expf, logf and the divides are IEEE, and the
// products are rounded before they are summed (__fmul_rn), as PyTorch's
// separate ops do; poe_kl_bwd recomputes the total precision in the same
// order. A one-tile row on a warp's lanes a term (CelebA's) has the
// block-a-row design's lanes and shuffle tree, so it keeps that design's
// bits.
//
// poe_kl_bwd is its backward for training: K1's VJP (mmvae_tpu/ops/
// kernels.py _kl_bwd) carried back through the PoE, the chain rule that
// jax.grad of the JAX step's masked PoE and KL gives. From the forward's
// inputs, its saved mu_f and lv_f and the output gradients g_mu, g_lv
// (T, B, L) and g_kl (T, B), with c = clamp(lv_e), w = mask * presence,
// P = w / (exp(c) + eps) and S = 1 + sum_m P (recomputed in the forward's
// order, so S has the forward's bits):
//     G_mu = g_mu + g_kl * mu_f,   G_lv = g_lv + 0.5 * g_kl * (exp(lv_f) - 1)
//     d mu_e = sum_t G_mu * P / S
//     d lv_e = sum_t w * [G_mu / S * (mu_e - mu_f) - G_lv / S]
//              * (-exp(c) p^2) * c',  p = 1 / (exp(c) + eps),
// where c' is 1 inside (-11, 11), 0.5 at exactly +-11 (jnp.clip's
// gradient, which splits a tie) and 0 beyond; a NaN log-variance gives
// NaN. What bounds it: memory, as the forward -- it reads the expert
// stack, the saved posteriors and the three gradients and writes two
// expert-stack gradients: 0.51 MB at MNIST's (3, 100, 2, 64), 0.15 us; 4.0
// MB at CelebA's (20, 64, 19, 100), 1.2 us. At MNIST's size the launch and
// one round of load latency set the time.
// Design. Every sum runs over t or over m at a fixed (b, l); none runs over
// l. So a block takes one batch row b and one tile of `tile` latents, with
// no atomics and no second pass; the block-a-row design it replaces left
// 68 of 132 SMs idle at CelebA and loaded its inputs in three dependent
// rounds. Each thread first issues the global loads of its first item of
// every phase -- its (m, l) expert elements and its (t, l) posteriors and
// gradients -- and its term weight's factors, before it uses any; the
// addresses take no integer divide (quotient(), a 2-D grid). Phase 1
// stages the tile's precisions (M x tile) and the term weights (T x M) in
// shared memory. Phase 2, a thread per (t, l): S in the forward's order,
// then G_mu / S, G_lv / S and mu_f into shared memory (3 T x tile). Phase
// 3, a thread per (m, l): both gradients summed over the terms in index
// order, from the expert elements it loaded at the start. The plan
// (kernels.py:poe_kl_bwd_plan) picks float4s along l where the sums are
// long (CelebA's 20 terms x 19 experts: 4 tiles of 28 latents, 256 blocks,
// where phase 3's shared-memory reads set the pace) and scalars in tiles
// of 32 where they are short (MNIST's and MultiMNIST's 3 x 2), so that the
// few latents spread over more threads; float4s also need L % 4 == 0 and
// every pointer 16-byte aligned. The sums keep their order and the
// products their rounding (__fmul_rn), so the result has the bits of the
// block-a-row design, and a shape gives the same bits every run.
//
// C interface (bound with ctypes): poe_kl and poe_kl_bwd launch on
// `stream`, do not synchronise, and return cudaGetLastError() of their
// launch (or cudaErrorInvalidValue for arguments they do not take).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxSmem = 48 * 1024;  // poe_kl_bwd's shared memory
// poe_kl's shared memory: up to 48 KB as launched, up to 227 KB of the
// SM's 256 KB after cudaFuncSetAttribute.
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxSmemOptIn = 232448;
constexpr int kStage = 2;  // staging items of each array a thread has in flight
constexpr int kMaxThreads = 512;  // poe_kl's block (__launch_bounds__)
constexpr int kMaxBwdThreads = 512;  // poe_kl_bwd's block (__launch_bounds__)
// The PoE's constants, as mmvae_torch/core/poe.py names them: the prior
// expert's precision, PRECISION_EPS (added to each expert's variance) and
// LOGVAR_BOUND (each expert's log-variance is clamped to +-this). Change
// them there and here together.
constexpr float kPrior = 1.0f;
constexpr float kEps = 1e-8f;
constexpr float kBound = 11.0f;

// An expert's precision. The comparisons keep a NaN, as torch.clamp does.
__device__ __forceinline__ float precision(float lv) {
  const float c = lv < -kBound ? -kBound : (lv > kBound ? kBound : lv);
  return 1.0f / (expf(c) + kEps);
}

// The summand of KL before the -0.5 scale, in the plain version's order.
__device__ __forceinline__ float kl_term(float mu, float lv) {
  return 1.0f + lv - __fmul_rn(mu, mu) - expf(lv);
}

// One (t, b, l): the fused posterior from the sums over the experts, its
// two outputs, and its KL summand.
__device__ __forceinline__ float fuse(float sum_p, float sum_mp, float* mu, float* lv) {
  const float tot = kPrior + sum_p;
  *mu = sum_mp / tot;
  *lv = -logf(tot);
  return kl_term(*mu, *lv);
}

// The clamp's gradient: 1 inside (-11, 11), 0.5 at exactly +-11, 0 beyond
// (and 0 for a NaN, whose other factor is NaN).
__device__ __forceinline__ float clamp_grad(float lv) {
  return (lv > -kBound && lv < kBound) ? 1.0f : ((lv == kBound || lv == -kBound) ? 0.5f : 0.0f);
}

// kW consecutive latents of one array: a float4 (kW == 4) or a scalar.
template <int kW>
struct Lanes {
  float v[kW];
};

template <int kW>
__device__ __forceinline__ Lanes<kW> load(const float* p) {
  Lanes<kW> r;
  if constexpr (kW == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    r.v[0] = q.x;
    r.v[1] = q.y;
    r.v[2] = q.z;
    r.v[3] = q.w;
  } else {
    r.v[0] = *p;
  }
  return r;
}

template <int kW>
__device__ __forceinline__ void store(float* p, const Lanes<kW>& r) {
  if constexpr (kW == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(r.v[0], r.v[1], r.v[2], r.v[3]);
  } else {
    *p = r.v[0];
  }
}

// i / d for 0 <= i < 2^20 and 0 < d, from inv ~ 1 / d (__fdividef, within
// 2 ulp): (i + 0.5) / d lies at least 0.5 / d from an integer, further than
// the product's rounding reaches, so the loads' addresses wait on no
// integer divide.
__device__ __forceinline__ int quotient(int i, float inv) {
  return __float2int_rz((static_cast<float>(i) + 0.5f) * inv);
}

// The sum of v over the `lanes` lanes (a power of two, at most a warp) of
// each aligned segment of the warp, in a fixed tree (a warp's: xor 16, 8,
// ..., 1); every lane of the warp calls it.
__device__ __forceinline__ float segment_sum(float v, int lanes) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    if (off < lanes) v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// The same over segments of `lanes` threads (a power of two, at most the
// block), given to each segment's first thread: a warp's tree, then, where
// a segment spans warps, its warps' sums in order through `s_warp` (a
// float a warp). Every thread of the block calls it.
__device__ __forceinline__ float lanes_sum(float v, int lanes, float* s_warp) {
  v = segment_sum(v, lanes);
  if (lanes <= kWarp) return v;
  const int tid = threadIdx.x, warp = tid / kWarp;
  __syncthreads();  // every thread has read the last call's sums
  if (tid % kWarp == 0) s_warp[warp] = v;
  __syncthreads();
  float sum = 0.0f;
  if ((tid & (lanes - 1)) == 0) {
    for (int w = 0; w < lanes / kWarp; ++w) sum += s_warp[warp + w];
  }
  return sum;
}

// A block per (batch row, term group): blockIdx.x = b * groups + g, the
// group's terms [g * terms, + terms) cut at T. It walks the row's latents
// in `tiles` tiles [k * tile, + tile) cut at L, kW latents a column (4:
// float4 loads), 1 << lane_shift lanes a term. Dynamic shared memory: the
// tile's mu (M x tile) and precisions (M x tile), the group's term weights
// (terms x M), each term's KL summed over the tiles so far (terms) and a
// float a warp for lanes_sum.
template <int kW>
__global__ void __launch_bounds__(kMaxThreads) poe_kl_kernel(const float* __restrict__ mu_e,
                              const float* __restrict__ lv_e,
                              const float* __restrict__ masks,
                              const float* __restrict__ presence,
                              float* __restrict__ mu_f, float* __restrict__ lv_f,
                              float* __restrict__ kl, int n_terms, int batch,
                              int m_experts, int l_dim, int terms, int groups, int tile,
                              int tiles, int lane_shift) {
  extern __shared__ float4 smem4[];
  float* s_mu = reinterpret_cast<float*>(smem4);
  float* s_p = s_mu + m_experts * tile;
  float* s_w = s_p + m_experts * tile;
  float* s_kl = s_w + terms * m_experts;
  float* s_warp = s_kl + terms;
  int b = blockIdx.x, t0 = 0;
  if (groups > 1) {
    b = blockIdx.x / groups;
    t0 = (blockIdx.x - b * groups) * terms;
  }
  const int n_t = min(terms, n_terms - t0);  // this block's terms
  const int n_w = n_t * m_experts;
  const int tid = threadIdx.x, threads = blockDim.x;
  const float inv_m = __fdividef(1.0f, static_cast<float>(m_experts));
  // Weight i is (t0 + i / M, i % M).
  auto factors = [=](int i) {
    return make_float2(masks[t0 * m_experts + i],
                       presence ? presence[b * m_experts + i - quotient(i, inv_m) * m_experts]
                                : 1.0f);
  };
  // A segment of `lanes` lanes a term (the plan's); the segments walk the
  // block's terms.
  const int lanes = 1 << lane_shift;
  const int seg = tid >> lane_shift, lane = tid & (lanes - 1), n_seg = threads >> lane_shift;
  const float2 w0 = tid < n_w ? factors(tid) : make_float2(0.0f, 0.0f);

  for (int k = 0; k < tiles; ++k) {  // the same trip count for every thread
    const int l0 = k * tile;
    const int cols = min(tile, l_dim - l0) / kW;  // kW-wide columns of this tile
    const int n_me = m_experts * cols;
    const float inv_cols = __fdividef(1.0f, static_cast<float>(cols));
    const size_t base = static_cast<size_t>(b) * m_experts * l_dim + l0;
    // Staging item i is (m, column) = (i / cols, i % cols).
    auto expert_at = [=](int i) {
      const int m = quotient(i, inv_cols);
      return base + static_cast<size_t>(m) * l_dim + (i - m * cols) * kW;
    };
    auto staged_at = [=](int i) {
      const int m = quotient(i, inv_cols);
      return m * tile + (i - m * cols) * kW;
    };
    if (k > 0) __syncthreads();  // every thread is done with the last tile

    // Every global load of the staging is issued before the first is used:
    // the factors of the thread's first weight (above), then kStage items
    // of each array at a time (one round where the plan gives a thread an
    // item).
    for (int i0 = tid; i0 < n_me; i0 += kStage * threads) {
      Lanes<kW> u[kStage], v[kStage];
#pragma unroll
      for (int j = 0; j < kStage; ++j) {
        const int i = i0 + j * threads;
        if (i < n_me) {
          u[j] = load<kW>(mu_e + expert_at(i));
          v[j] = load<kW>(lv_e + expert_at(i));
        }
      }
#pragma unroll
      for (int j = 0; j < kStage; ++j) {
        const int i = i0 + j * threads;
        if (i < n_me) {
          Lanes<kW> p;
#pragma unroll
          for (int q = 0; q < kW; ++q) p.v[q] = precision(v[j].v[q]);
          store<kW>(s_mu + staged_at(i), u[j]);
          store<kW>(s_p + staged_at(i), p);
        }
      }
    }
    if (k == 0) {
      if (tid < n_w) s_w[tid] = __fmul_rn(w0.x, w0.y);
      for (int i = tid + threads; i < n_w; i += threads) {
        const float2 f = factors(i);
        s_w[i] = __fmul_rn(f.x, f.y);
      }
    }
    __syncthreads();

    for (int i0 = 0; i0 < n_t; i0 += n_seg) {  // the same trip count for every thread
      const int tl = i0 + seg;  // the term's index in the block
      float acc = 0.0f;
      if (tl < n_t) {
        const float* w = s_w + tl * m_experts;
        const size_t out = (static_cast<size_t>(t0 + tl) * batch + b) * l_dim + l0;
        for (int c = lane; c < cols; c += lanes) {
          Lanes<kW> sp{}, smp{};
#pragma unroll 4
          for (int m = 0; m < m_experts; ++m) {
            const float wm = w[m];
            const Lanes<kW> p = load<kW>(s_p + m * tile + c * kW);
            const Lanes<kW> u = load<kW>(s_mu + m * tile + c * kW);
#pragma unroll
            for (int q = 0; q < kW; ++q) {
              const float pw = __fmul_rn(p.v[q], wm);
              sp.v[q] += pw;
              smp.v[q] += __fmul_rn(u.v[q], pw);
            }
          }
          Lanes<kW> f_mu, f_lv;
          float k_sum = 0.0f;
#pragma unroll
          for (int q = 0; q < kW; ++q) k_sum += fuse(sp.v[q], smp.v[q], &f_mu.v[q], &f_lv.v[q]);
          store<kW>(mu_f + out + c * kW, f_mu);
          store<kW>(lv_f + out + c * kW, f_lv);
          acc += k_sum;
        }
      }
      acc = lanes_sum(acc, lanes, s_warp);
      if (lane == 0 && tl < n_t) {
        // The tiles in order; only this thread reads or writes s_kl[tl].
        const float total = k == 0 ? acc : s_kl[tl] + acc;
        if (k + 1 < tiles) {
          s_kl[tl] = total;
        } else {
          kl[static_cast<size_t>(t0 + tl) * batch + b] = -0.5f * total;
        }
      }
    }
  }
}

// A block per (batch row, latent tile), kW latents a thread (4: float4
// loads). Dynamic shared memory: the tile's precisions (M x tile), the
// term weights (T x M, rounded up to a float4), then G_mu / S, G_lv / S
// and mu_f of the tile's terms (T x tile each).
template <int kW>
__global__ void __launch_bounds__(kMaxBwdThreads) poe_kl_bwd_kernel(const float* __restrict__ mu_e,
                                  const float* __restrict__ lv_e,
                                  const float* __restrict__ masks,
                                  const float* __restrict__ presence,
                                  const float* __restrict__ mu_f,
                                  const float* __restrict__ lv_f,
                                  const float* __restrict__ g_mu,
                                  const float* __restrict__ g_lv,
                                  const float* __restrict__ g_kl,
                                  float* __restrict__ d_mu_e,
                                  float* __restrict__ d_lv_e, int n_terms,
                                  int batch, int m_experts, int l_dim, int tile) {
  extern __shared__ float4 smem4[];
  float* s_p = reinterpret_cast<float*>(smem4);
  float* s_w = s_p + m_experts * tile;
  float* s_a = s_w + (n_terms * m_experts + 3) / 4 * 4;  // float4-aligned
  float* s_q = s_a + n_terms * tile;
  float* s_f = s_q + n_terms * tile;
  const int b = blockIdx.y;  // the grid is (tiles, batch)
  const int l0 = blockIdx.x * tile;
  const int cols = (min(tile, l_dim - l0)) / kW;  // kW-wide columns of this tile
  const int n_me = m_experts * cols, n_te = n_terms * cols, n_w = n_terms * m_experts;
  const int tid = threadIdx.x, threads = blockDim.x;
  const float inv_cols = __fdividef(1.0f, static_cast<float>(cols));
  const float inv_m = __fdividef(1.0f, static_cast<float>(m_experts));
  // Item i of phase 3 (and of the precision staging) is (m, column) =
  // (i / cols, i % cols); of phase 2, (t, column).
  auto expert_at = [=](int i) {
    const int m = quotient(i, inv_cols);
    return (static_cast<size_t>(b) * m_experts + m) * l_dim + l0 + (i - m * cols) * kW;
  };
  auto term_at = [=](int i) {
    const int t = quotient(i, inv_cols);
    return (static_cast<size_t>(t) * batch + b) * l_dim + l0 + (i - t * cols) * kW;
  };
  auto presence_of = [=](int i) {  // presence[b, m] of weight i = (t, m)
    return presence ? presence[b * m_experts + i - quotient(i, inv_m) * m_experts] : 1.0f;
  };

  // The first item of every phase: all its global loads issued before any
  // is used.
  Lanes<kW> u0{}, v0{}, fm0{}, fl0{}, gm0{}, gv0{};
  float gk0 = 0.0f;
  float2 w0 = make_float2(0.0f, 0.0f);
  if (tid < n_me) {
    u0 = load<kW>(mu_e + expert_at(tid));
    v0 = load<kW>(lv_e + expert_at(tid));
  }
  if (tid < n_te) {
    const size_t row = term_at(tid);
    fm0 = load<kW>(mu_f + row);
    fl0 = load<kW>(lv_f + row);
    gm0 = load<kW>(g_mu + row);
    gv0 = load<kW>(g_lv + row);
    gk0 = g_kl[static_cast<size_t>(quotient(tid, inv_cols)) * batch + b];
  }
  if (tid < n_w) w0 = make_float2(masks[tid], presence_of(tid));

  // Phase 1: the precisions and the term weights.
  if (tid < n_me) {
    Lanes<kW> p;
#pragma unroll
    for (int k = 0; k < kW; ++k) p.v[k] = precision(v0.v[k]);
    const int m = quotient(tid, inv_cols);
    store<kW>(s_p + m * tile + (tid - m * cols) * kW, p);
  }
  for (int i = tid + threads; i < n_me; i += threads) {
    const Lanes<kW> v = load<kW>(lv_e + expert_at(i));
    Lanes<kW> p;
#pragma unroll
    for (int k = 0; k < kW; ++k) p.v[k] = precision(v.v[k]);
    const int m = quotient(i, inv_cols);
    store<kW>(s_p + m * tile + (i - m * cols) * kW, p);
  }
  if (tid < n_w) s_w[tid] = __fmul_rn(w0.x, w0.y);
  for (int i = tid + threads; i < n_w; i += threads) s_w[i] = __fmul_rn(masks[i], presence_of(i));
  __syncthreads();

  // Phase 2, a thread per (t, l): the posterior's total precision in the
  // forward's order, and the gradients that reach the experts through it.
  for (int i = tid; i < n_te; i += threads) {
    const int t = quotient(i, inv_cols), j = (i - t * cols) * kW;
    Lanes<kW> fm = fm0, fl = fl0, gm = gm0, gv = gv0;
    float gk = gk0;
    if (i != tid) {
      const size_t row = term_at(i);
      fm = load<kW>(mu_f + row);
      fl = load<kW>(lv_f + row);
      gm = load<kW>(g_mu + row);
      gv = load<kW>(g_lv + row);
      gk = g_kl[static_cast<size_t>(t) * batch + b];
    }
    const float* w = s_w + t * m_experts;
    Lanes<kW> sp{};
    for (int m = 0; m < m_experts; ++m) {
      const Lanes<kW> p = load<kW>(s_p + m * tile + j);
      const float wm = w[m];
#pragma unroll
      for (int k = 0; k < kW; ++k) sp.v[k] += __fmul_rn(p.v[k], wm);
    }
    Lanes<kW> a, q;
#pragma unroll
    for (int k = 0; k < kW; ++k) {
      const float tot = kPrior + sp.v[k];
      const float G_mu = gm.v[k] + __fmul_rn(gk, fm.v[k]);
      const float G_lv = gv.v[k] + __fmul_rn(__fmul_rn(0.5f, gk), expf(fl.v[k]) - 1.0f);
      a.v[k] = G_mu / tot;
      q.v[k] = G_lv / tot;
    }
    store<kW>(s_a + t * tile + j, a);
    store<kW>(s_q + t * tile + j, q);
    store<kW>(s_f + t * tile + j, fm);
  }
  __syncthreads();

  // Phase 3, a thread per (m, l): both gradients summed over the terms in
  // order.
  for (int i = tid; i < n_me; i += threads) {
    const int m = quotient(i, inv_cols), j = (i - m * cols) * kW;
    Lanes<kW> u = u0, v = v0;
    if (i != tid) {
      u = load<kW>(mu_e + expert_at(i));
      v = load<kW>(lv_e + expert_at(i));
    }
    const Lanes<kW> p = load<kW>(s_p + m * tile + j);
    Lanes<kW> d_mu{}, d_q{};
    for (int t = 0; t < n_terms; ++t) {
      const float wt = s_w[t * m_experts + m];
      const Lanes<kW> a = load<kW>(s_a + t * tile + j);
      const Lanes<kW> q = load<kW>(s_q + t * tile + j);
      const Lanes<kW> f = load<kW>(s_f + t * tile + j);
#pragma unroll
      for (int k = 0; k < kW; ++k) {
        d_mu.v[k] += __fmul_rn(a.v[k], __fmul_rn(p.v[k], wt));
        d_q.v[k] += __fmul_rn(wt, __fmul_rn(a.v[k], u.v[k] - f.v[k]) - q.v[k]);
      }
    }
    Lanes<kW> d_lv;
#pragma unroll
    for (int k = 0; k < kW; ++k) {
      const float x = v.v[k];
      const float c = x < -kBound ? -kBound : (x > kBound ? kBound : x);
      const float dp_dc = -__fmul_rn(__fmul_rn(expf(c), p.v[k]), p.v[k]);
      d_lv.v[k] = __fmul_rn(__fmul_rn(d_q.v[k], dp_dc), clamp_grad(x));
    }
    store<kW>(d_mu_e + expert_at(i), d_mu);
    store<kW>(d_lv_e + expert_at(i), d_lv);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <int kW>
cudaError_t launch_poe_kl(const float* mu_e, const float* lv_e, const float* masks,
                          const float* presence, float* mu_f, float* lv_f, float* kl,
                          int n_terms, int batch, int m_experts, int l_dim, int terms,
                          int tile, int tiles, int lane_shift, int threads, int blocks,
                          int smem, cudaStream_t stream) {
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        poe_kl_kernel<kW>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const int groups = (n_terms + terms - 1) / terms;
  poe_kl_kernel<kW><<<blocks, threads, smem, stream>>>(mu_e, lv_e, masks, presence, mu_f, lv_f,
                                                       kl, n_terms, batch, m_experts, l_dim,
                                                       terms, groups, tile, tiles, lane_shift);
  return cudaSuccess;
}

}  // namespace

extern "C" const char* poe_kl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// mu_e, lv_e: (batch, m_experts, l_dim); masks: (n_terms, m_experts);
// presence: (batch, m_experts) or null; mu_f, lv_f: (n_terms, batch,
// l_dim); kl: (n_terms, batch); all f32, contiguous. The launch plan
// (kernels.py:poe_kl_plan): `terms` terms a block (a group), `tile`
// latents a tile and `tiles` tiles a block, which together cover l_dim
// and leave no tile empty; `lanes` lanes a term (a power of two that
// divides `threads`); `threads` a block (whole warps, at most 512); blocks
// == batch * ceil(n_terms / terms); smem the bytes of the tile's two
// slabs, the group's weights, its terms' KLs and a float a warp, at most
// 227 KB; `vec4` (1: float4 loads where l_dim and tile are multiples of 4
// and every pointer is 16-byte aligned, else scalars; 0: scalars).
extern "C" int poe_kl(const float* mu_e, const float* lv_e, const float* masks,
                      const float* presence, float* mu_f, float* lv_f, float* kl,
                      int n_terms, int batch, int m_experts, int l_dim, int terms, int tile,
                      int tiles, int lanes, int threads, int blocks, int smem, int vec4,
                      cudaStream_t stream) {
  if (n_terms <= 0 || batch <= 0 || m_experts <= 0 || l_dim <= 0 || terms <= 0 ||
      terms > n_terms || tile <= 0 || tiles < 1 || threads < kWarp ||
      threads > kMaxThreads || threads % kWarp != 0 || lanes < 1 || threads % lanes != 0 ||
      (lanes & (lanes - 1)) != 0 || static_cast<long long>(tile) * tiles < l_dim ||
      static_cast<long long>(tile) * (tiles - 1) >= l_dim ||
      static_cast<long long>(blocks) !=
          static_cast<long long>(batch) * ((n_terms + terms - 1) / terms)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long need = 4LL * (2LL * m_experts * tile + static_cast<long long>(terms) * m_experts +
                                terms + threads / kWarp);
  if (smem < need || smem > kMaxSmemOptIn) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = vec4 && l_dim % 4 == 0 && tile % 4 == 0 && aligned16(mu_e) &&
                   aligned16(lv_e) && aligned16(mu_f) && aligned16(lv_f);
  int lane_shift = 0;
  while ((1 << lane_shift) < lanes) ++lane_shift;
  const cudaError_t err =
      vec ? launch_poe_kl<4>(mu_e, lv_e, masks, presence, mu_f, lv_f, kl, n_terms, batch,
                             m_experts, l_dim, terms, tile, tiles, lane_shift, threads, blocks,
                             smem, stream)
          : launch_poe_kl<1>(mu_e, lv_e, masks, presence, mu_f, lv_f, kl, n_terms, batch,
                             m_experts, l_dim, terms, tile, tiles, lane_shift, threads, blocks,
                             smem, stream);
  const cudaError_t last = cudaGetLastError();  // read (and clear) either way
  return static_cast<int>(err != cudaSuccess ? err : last);
}

// The forward's arguments, its outputs mu_f and lv_f (T, B, L), the output
// gradients g_mu, g_lv (T, B, L) and g_kl (T, B), and the expert-stack
// gradients d_mu_e, d_lv_e (B, M, L); all f32, contiguous. The launch plan
// (kernels.py:poe_kl_bwd_plan): `tile` latents a block, `vec4` (1: float4
// loads where l_dim and tile are multiples of 4 and every pointer is
// 16-byte aligned, else scalars; 0: scalars), `threads` a block (32-512),
// `blocks` == batch * ceil(l_dim / tile), smem the bytes of the tile's
// precisions, the weights (rounded up to a float4) and the three (T x tile)
// term arrays, at most 48 KB.
extern "C" int poe_kl_bwd(const float* mu_e, const float* lv_e, const float* masks,
                          const float* presence, const float* mu_f, const float* lv_f,
                          const float* g_mu, const float* g_lv, const float* g_kl,
                          float* d_mu_e, float* d_lv_e, int n_terms, int batch,
                          int m_experts, int l_dim, int tile, int vec4, int threads,
                          int blocks, int smem, cudaStream_t stream) {
  if (n_terms <= 0 || batch <= 0 || batch > 65535 || m_experts <= 0 || l_dim <= 0 ||
      tile <= 0 || threads < kWarp || threads > kMaxBwdThreads || threads % kWarp != 0 ||
      static_cast<long long>(blocks) !=
          static_cast<long long>(batch) * ((l_dim + tile - 1) / tile)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long need = 4LL * (static_cast<long long>(m_experts) * tile +
                                (static_cast<long long>(n_terms) * m_experts + 3) / 4 * 4 +
                                3LL * n_terms * tile);
  if (smem < need || smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = vec4 && l_dim % 4 == 0 && tile % 4 == 0 && aligned16(mu_e) && aligned16(lv_e) &&
                   aligned16(mu_f) && aligned16(lv_f) && aligned16(g_mu) && aligned16(g_lv) &&
                   aligned16(d_mu_e) && aligned16(d_lv_e);
  const dim3 grid(blocks / batch, batch);
  if (vec) {
    poe_kl_bwd_kernel<4><<<grid, threads, smem, stream>>>(
        mu_e, lv_e, masks, presence, mu_f, lv_f, g_mu, g_lv, g_kl, d_mu_e, d_lv_e, n_terms,
        batch, m_experts, l_dim, tile);
  } else {
    poe_kl_bwd_kernel<1><<<grid, threads, smem, stream>>>(
        mu_e, lv_e, masks, presence, mu_f, lv_f, g_mu, g_lv, g_kl, d_mu_e, d_lv_e, n_terms,
        batch, m_experts, l_dim, tile);
  }
  return static_cast<int>(cudaGetLastError());
}
