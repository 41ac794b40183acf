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
// Design. A block takes one batch row b and a group of `terms` terms. It
// stages mu_e[b] and p = 1 / (exp(clamp(lv)) + eps) for its M x L slab in
// shared memory (15.2 KB at CelebA), so each expert element is read from
// device memory once and its exp and divide run once, not once a term; and
// the term weights masks[t,m] * presence[b,m] of its group. Every load of
// the staging is issued before the first is used. Then a warp
// takes a term: its lanes walk L in float4s (25 lanes at L = 100; scalars
// when L % 4 != 0 or a pointer is not 16-byte aligned), sum over the
// experts in index order, write mu_f and lv_f coalesced, and reduce the KL
// with shuffles in a fixed order. No atomics: a shape gives the same bits
// from run to run. The grid (kernels.py:poe_kl_plan) splits the terms of a
// row over several blocks when the batch rows alone would leave SMs idle.
// No fast-math: expf, logf and the divides are IEEE, and the products are
// rounded before they are summed (__fmul_rn), as PyTorch's separate ops do.
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
// expert-stack gradients: 0.51 MB at MNIST's (3, 100, 2, 64), 0.15 us.
// Design: a block per batch row. It stages the row's precisions (M x L)
// and term weights (T x M) in shared memory; then a thread per (t, l)
// computes S, G_mu / S and G_lv / S and keeps them and mu_f in shared
// memory (3 T x L); then a thread per (m, l) sums its two gradients over
// the terms in index order. Scalar loads, no atomics: a shape gives the
// same bits every run.
//
// C interface (bound with ctypes): poe_kl and poe_kl_bwd launch on
// `stream`, do not synchronise, and return cudaGetLastError() of their
// launch (or cudaErrorInvalidValue for arguments they do not take).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxWarps = 32;
constexpr int kMaxSmem = 48 * 1024;
constexpr int kStage = 2;  // float4s of each slab a thread has in flight
// The PoE's constants, as mmvae_torch/core/poe.py names them: the prior
// expert's precision, PRECISION_EPS (added to each expert's variance) and
// LOGVAR_BOUND (each expert's log-variance is clamped to +-this). Change
// them there and here together.
constexpr float kPrior = 1.0f;
constexpr float kEps = 1e-8f;
constexpr float kBound = 11.0f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

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

// The two factors of weight i of a block's terms from t0 on, masks[t, m]
// and presence[b, m] (1 without presence); the weight is their product,
// taken only where it is stored so that the loads stay in flight.
__device__ __forceinline__ float2 weight_factors(const float* __restrict__ masks,
                                                 const float* __restrict__ presence,
                                                 int t0, int b, int m_experts, int i) {
  const int m = i % m_experts;
  return make_float2(masks[(t0 + i / m_experts) * m_experts + m],
                     presence ? presence[b * m_experts + m] : 1.0f);
}

// Dynamic shared memory: the mu slab (M x L), the precision slab (M x L),
// the group's term weights (terms x M).
template <bool kVec>
__global__ void poe_kl_kernel(const float* __restrict__ mu_e,
                              const float* __restrict__ lv_e,
                              const float* __restrict__ masks,
                              const float* __restrict__ presence,
                              float* __restrict__ mu_f, float* __restrict__ lv_f,
                              float* __restrict__ kl, int n_terms, int batch,
                              int m_experts, int l_dim, int terms) {
  extern __shared__ float4 smem4[];
  float* s_mu = reinterpret_cast<float*>(smem4);
  const int ml = m_experts * l_dim;
  float* s_p = s_mu + ml;
  float* s_w = s_p + ml;
  const int groups = (n_terms + terms - 1) / terms;
  const int b = blockIdx.x / groups;
  const int t0 = (blockIdx.x % groups) * terms;
  const int t_end = min(n_terms, t0 + terms);
  const int tid = threadIdx.x, threads = blockDim.x;
  const size_t base = static_cast<size_t>(b) * ml;

  // Every global load of the staging is issued before the first is used:
  // the factors of the thread's first term weight, then kStage float4s (or
  // 4 kStage scalars) of each slab at a time.
  const int n_w = (t_end - t0) * m_experts;
  const float2 w_first =
      tid < n_w ? weight_factors(masks, presence, t0, b, m_experts, tid) : make_float2(0.0f, 0.0f);
  if (kVec) {
    const float4* m4 = reinterpret_cast<const float4*>(mu_e + base);
    const float4* l4 = reinterpret_cast<const float4*>(lv_e + base);
    float4* sm4 = reinterpret_cast<float4*>(s_mu);
    float4* sp4 = reinterpret_cast<float4*>(s_p);
    for (int i0 = tid; i0 < ml / 4; i0 += kStage * threads) {
      float4 u[kStage], v[kStage];
#pragma unroll
      for (int k = 0; k < kStage; ++k) {
        const int i = i0 + k * threads;
        if (i < ml / 4) {
          u[k] = m4[i];
          v[k] = l4[i];
        }
      }
#pragma unroll
      for (int k = 0; k < kStage; ++k) {
        const int i = i0 + k * threads;
        if (i < ml / 4) {
          sm4[i] = u[k];
          sp4[i] = make_float4(precision(v[k].x), precision(v[k].y),
                               precision(v[k].z), precision(v[k].w));
        }
      }
    }
  } else {
    constexpr int kScalar = 4 * kStage;
    for (int i0 = tid; i0 < ml; i0 += kScalar * threads) {
      float u[kScalar], v[kScalar];
#pragma unroll
      for (int k = 0; k < kScalar; ++k) {
        const int i = i0 + k * threads;
        if (i < ml) {
          u[k] = mu_e[base + i];
          v[k] = lv_e[base + i];
        }
      }
#pragma unroll
      for (int k = 0; k < kScalar; ++k) {
        const int i = i0 + k * threads;
        if (i < ml) {
          s_mu[i] = u[k];
          s_p[i] = precision(v[k]);
        }
      }
    }
  }
  if (tid < n_w) s_w[tid] = __fmul_rn(w_first.x, w_first.y);
  for (int i = tid + threads; i < n_w; i += threads) {
    const float2 f = weight_factors(masks, presence, t0, b, m_experts, i);
    s_w[i] = __fmul_rn(f.x, f.y);
  }
  __syncthreads();

  const int lane = tid % kWarp;
  for (int t = t0 + tid / kWarp; t < t_end; t += threads / kWarp) {
    const float* w = s_w + (t - t0) * m_experts;
    const size_t row = (static_cast<size_t>(t) * batch + b) * l_dim;
    float acc = 0.0f;
    if (kVec) {
      const int l4 = l_dim / 4;
      const float4* sm4 = reinterpret_cast<const float4*>(s_mu);
      const float4* sp4 = reinterpret_cast<const float4*>(s_p);
      float4* mu4 = reinterpret_cast<float4*>(mu_f + row);
      float4* lv4 = reinterpret_cast<float4*>(lv_f + row);
      for (int c = lane; c < l4; c += kWarp) {
        float4 sp = make_float4(0.0f, 0.0f, 0.0f, 0.0f), smp = sp;
#pragma unroll 4
        for (int m = 0; m < m_experts; ++m) {
          const float wm = w[m];
          const float4 p = sp4[m * l4 + c];
          const float4 u = sm4[m * l4 + c];
          const float px = __fmul_rn(p.x, wm), py = __fmul_rn(p.y, wm);
          const float pz = __fmul_rn(p.z, wm), pw = __fmul_rn(p.w, wm);
          sp.x += px;
          sp.y += py;
          sp.z += pz;
          sp.w += pw;
          smp.x += __fmul_rn(u.x, px);
          smp.y += __fmul_rn(u.y, py);
          smp.z += __fmul_rn(u.z, pz);
          smp.w += __fmul_rn(u.w, pw);
        }
        float4 f_mu, f_lv;
        const float kx = fuse(sp.x, smp.x, &f_mu.x, &f_lv.x);
        const float ky = fuse(sp.y, smp.y, &f_mu.y, &f_lv.y);
        const float kz = fuse(sp.z, smp.z, &f_mu.z, &f_lv.z);
        const float kw = fuse(sp.w, smp.w, &f_mu.w, &f_lv.w);
        mu4[c] = f_mu;
        lv4[c] = f_lv;
        acc += kx + ky + kz + kw;
      }
    } else {
      for (int l = lane; l < l_dim; l += kWarp) {
        float sp = 0.0f, smp = 0.0f;
#pragma unroll 4
        for (int m = 0; m < m_experts; ++m) {
          const float p = __fmul_rn(s_p[m * l_dim + l], w[m]);
          sp += p;
          smp += __fmul_rn(s_mu[m * l_dim + l], p);
        }
        float f_mu, f_lv;
        acc += fuse(sp, smp, &f_mu, &f_lv);
        mu_f[row + l] = f_mu;
        lv_f[row + l] = f_lv;
      }
    }
    acc = warp_sum(acc);
    if (lane == 0) kl[static_cast<size_t>(t) * batch + b] = -0.5f * acc;
  }
}

// The clamp's gradient: 1 inside (-11, 11), 0.5 at exactly +-11, 0 beyond
// (and 0 for a NaN, whose other factor is NaN).
__device__ __forceinline__ float clamp_grad(float lv) {
  return (lv > -kBound && lv < kBound) ? 1.0f : ((lv == kBound || lv == -kBound) ? 0.5f : 0.0f);
}

// Dynamic shared memory: the precision slab (M x L), the term weights
// (T x M), then G_mu / S, G_lv / S and mu_f of the row's terms (T x L each).
__global__ void poe_kl_bwd_kernel(const float* __restrict__ mu_e,
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
                                  int batch, int m_experts, int l_dim) {
  extern __shared__ float4 smem4[];
  const int ml = m_experts * l_dim, tl = n_terms * l_dim;
  float* s_p = reinterpret_cast<float*>(smem4);
  float* s_w = s_p + ml;
  float* s_a = s_w + n_terms * m_experts;
  float* s_q = s_a + tl;
  float* s_f = s_q + tl;
  const int b = blockIdx.x;
  const int tid = threadIdx.x, threads = blockDim.x;
  const size_t base = static_cast<size_t>(b) * ml;

  for (int i = tid; i < ml; i += threads) s_p[i] = precision(lv_e[base + i]);
  for (int i = tid; i < n_terms * m_experts; i += threads) {
    const int m = i % m_experts;
    s_w[i] = __fmul_rn(masks[i], presence ? presence[b * m_experts + m] : 1.0f);
  }
  __syncthreads();

  // A thread per (t, l): the posterior's total precision in the forward's
  // order, and the gradients that reach the experts through it.
  for (int i = tid; i < tl; i += threads) {
    const int t = i / l_dim, l = i % l_dim;
    const float* w = s_w + t * m_experts;
    float sp = 0.0f;
    for (int m = 0; m < m_experts; ++m) sp += __fmul_rn(s_p[m * l_dim + l], w[m]);
    const float tot = kPrior + sp;
    const size_t row = (static_cast<size_t>(t) * batch + b) * l_dim + l;
    const float f_mu = mu_f[row];
    const float gk = g_kl[static_cast<size_t>(t) * batch + b];
    const float G_mu = g_mu[row] + __fmul_rn(gk, f_mu);
    const float G_lv = g_lv[row] + __fmul_rn(__fmul_rn(0.5f, gk), expf(lv_f[row]) - 1.0f);
    s_a[i] = G_mu / tot;
    s_q[i] = G_lv / tot;
    s_f[i] = f_mu;
  }
  __syncthreads();

  // A thread per (m, l): both gradients summed over the terms in order.
  for (int i = tid; i < ml; i += threads) {
    const int m = i / l_dim, l = i % l_dim;
    const float u = mu_e[base + i];
    const float v = lv_e[base + i];
    const float p = s_p[i];
    float d_mu = 0.0f, d_q = 0.0f;
    for (int t = 0; t < n_terms; ++t) {
      const float wt = s_w[t * m_experts + m];
      const float a = s_a[t * l_dim + l];
      d_mu += __fmul_rn(a, __fmul_rn(p, wt));
      d_q += __fmul_rn(wt, __fmul_rn(a, u - s_f[t * l_dim + l]) - s_q[t * l_dim + l]);
    }
    const float c = v < -kBound ? -kBound : (v > kBound ? kBound : v);
    const float dp_dc = -__fmul_rn(__fmul_rn(expf(c), p), p);
    d_mu_e[base + i] = d_mu;
    d_lv_e[base + i] = __fmul_rn(__fmul_rn(d_q, dp_dc), clamp_grad(v));
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" const char* poe_kl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// mu_e, lv_e: (batch, m_experts, l_dim); masks: (n_terms, m_experts);
// presence: (batch, m_experts) or null; mu_f, lv_f: (n_terms, batch,
// l_dim); kl: (n_terms, batch); all f32, contiguous. terms, warps, blocks
// and smem: the launch plan (kernels.py:poe_kl_plan): `terms` terms a
// block, `warps` warps a block, blocks == batch * ceil(n_terms / terms),
// smem the bytes of the two slabs and the group's weights, at most 48 KB.
extern "C" int poe_kl(const float* mu_e, const float* lv_e, const float* masks,
                      const float* presence, float* mu_f, float* lv_f, float* kl,
                      int n_terms, int batch, int m_experts, int l_dim, int terms,
                      int warps, int blocks, int smem, cudaStream_t stream) {
  if (n_terms <= 0 || batch <= 0 || m_experts <= 0 || l_dim <= 0 || terms <= 0 ||
      terms > n_terms || warps <= 0 || warps > kMaxWarps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long groups = (n_terms + terms - 1) / terms;
  const long long need =
      4LL * (2LL * m_experts * l_dim + static_cast<long long>(terms) * m_experts);
  if (static_cast<long long>(blocks) != batch * groups || smem < need || smem > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = l_dim % 4 == 0 && aligned16(mu_e) && aligned16(lv_e) &&
                   aligned16(mu_f) && aligned16(lv_f);
  if (vec) {
    poe_kl_kernel<true><<<blocks, warps * kWarp, smem, stream>>>(
        mu_e, lv_e, masks, presence, mu_f, lv_f, kl, n_terms, batch, m_experts,
        l_dim, terms);
  } else {
    poe_kl_kernel<false><<<blocks, warps * kWarp, smem, stream>>>(
        mu_e, lv_e, masks, presence, mu_f, lv_f, kl, n_terms, batch, m_experts,
        l_dim, terms);
  }
  return static_cast<int>(cudaGetLastError());
}

// The forward's arguments, its outputs mu_f and lv_f (T, B, L), the output
// gradients g_mu, g_lv (T, B, L) and g_kl (T, B), and the expert-stack
// gradients d_mu_e, d_lv_e (B, M, L); all f32, contiguous. `blocks` ==
// batch blocks of `threads` threads; smem the bytes of the precision slab,
// the weights and the three (T x L) term arrays, at most 48 KB
// (kernels.py:poe_kl_bwd_plan).
extern "C" int poe_kl_bwd(const float* mu_e, const float* lv_e, const float* masks,
                          const float* presence, const float* mu_f, const float* lv_f,
                          const float* g_mu, const float* g_lv, const float* g_kl,
                          float* d_mu_e, float* d_lv_e, int n_terms, int batch,
                          int m_experts, int l_dim, int threads, int blocks, int smem,
                          cudaStream_t stream) {
  if (n_terms <= 0 || batch <= 0 || m_experts <= 0 || l_dim <= 0 || threads < kWarp ||
      threads > kMaxWarps * kWarp || threads % kWarp != 0 || blocks != batch) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long need = 4LL * (static_cast<long long>(m_experts) * l_dim +
                                static_cast<long long>(n_terms) * m_experts +
                                3LL * n_terms * l_dim);
  if (smem < need || smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  poe_kl_bwd_kernel<<<blocks, threads, smem, stream>>>(
      mu_e, lv_e, masks, presence, mu_f, lv_f, g_mu, g_lv, g_kl, d_mu_e, d_lv_e, n_terms,
      batch, m_experts, l_dim);
  return static_cast<int>(cudaGetLastError());
}
