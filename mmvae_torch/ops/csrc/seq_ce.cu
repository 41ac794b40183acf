// Masked sequence cross-entropy (N, S, V) -> (N,) and its gradient for
// Hopper (sm_90a).
//
// seq_ce_rows replaces mmvae_tpu/ops/kernels.py:masked_seq_ce_pallas
// (_seq_ce_kernel through the pallas_call in _seq_ce_fwd_impl): per
// example row n,
//     out[n] = sum_s [tok[n,s] != pad] * (logsumexp_v l[n,s,v] - l[n,s,tok]).
// The TPU kernel streamed vocab tiles through VMEM with a running max and
// a rescaled exp-sum in scratch, and left the sum over S to XLA. Here a
// warp, or a few lanes, own a token row and a block sums its example's
// tokens.
//
// What bounds it: memory. Each logit costs a max, a subtract, one exp and
// an add against 4 bytes read. A pad token needs none of its logits, and
// its lanes read the token first and leave a pad row at once, so the
// least traffic is the non-pad token rows' logits, the tokens and the
// output: at (2048, 8, 5003) with half the tokens pad, about 163 MB, 49 us
// at 3.35 TB/s. At the MultiMNIST eval shape (200, 5, 13) it is under
// 40 KB and the kernel is bound by launch latency.
//
// Design: a block per example row, its tokens spread over the block a
// token row to a group of `lanes` lanes (kernels.py's seq_ce_plan picks
// the group and the warps from the shape and passes them in). In each
// pass every group scores one token and writes its NLL to shared memory;
// after a barrier one thread adds them in token order, and out[n] is
// written once. No atomics: the result is the same bits from run to run.
// A group reads its token first and leaves a pad row at once.
//
// A warp a token row (lanes == 32, large V), token_nll: a row starts
// wherever (n * S + s) * V * 4 bytes falls, which at odd V is mostly not
// a 16-byte boundary. Lanes peel a scalar head up to that boundary and a
// scalar tail after the last whole float4, and stream the body as
// float4s, kUnroll loads a lane in flight before any is used. Each group
// of loaded values joins the lane's online log-sum-exp (m, s) once: the
// group's max by fmaxf, one rescale of s, then the group's e^(x - m)
// without branches. The lanes then take the warp's max by shuffles,
// rescale their sums to it once and add them by shuffles.
//
// A few lanes a token row (lanes < 32, small V), token_nll_group: with 23
// logits a row a whole warp would spend most of its exps on padding, so
// 32 / lanes token rows share a warp, each lane holding a few logits of
// its row (scalar loads; the warp's groups read neighbouring rows). Max,
// then the sum of e^(x - max), each reduced over the group by shuffles.
//
// The label logit is one load by the group's first lane. No fast-math:
// expf/logf track the plain PyTorch version to rounding.
//
// seq_ce_rows_grad replaces the VJP of the same TPU kernel
// (mmvae_tpu/ops/kernels.py:_seq_ce_bwd): for example row n with upstream
// gradient g[n],
//     d[n,s,v] = g[n] * (softmax(l[n,s])[v] - [v == tok[n,s]]) * [tok[n,s] != pad].
// It takes the forward's layout (seq_ce_plan: a block an example row, a
// token row to a group of `lanes` lanes) and recomputes each row's max and
// exp-sum rather than saving the log-sum-exp in the forward. A group reads
// its token row once for a running (max, exp-sum) per lane, combines them
// over the group by shuffles, then reads the row again (from L1 or L2) and
// writes its gradient once. A pad row writes zeros and reads no logit. No
// shared memory, no barrier, no atomics.
//
// What bounds it: memory. The non-pad rows' logits read once and every
// gradient written once: at (2048, 8, 5003) with half the tokens pad, about
// 164 MB read and 328 MB written, 147 us at 3.35 TB/s. At the MultiMNIST train
// shape (300, 5, 13) it is under 160 KB and the launch bounds it.
//
// C interface (bound with ctypes): seq_ce_rows and seq_ce_rows_grad launch
// on `stream`, do not synchronise, and return cudaGetLastError() of their
// launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kUnroll = 4;      // float4 loads a lane has in flight
constexpr int kMaxWarps = 32;   // warps a block

// s * e^(m - m_new) of a partial (m, s); a lane that saw nothing has
// s == 0 and m == -inf, whose exponent would be NaN, and keeps 0. A NaN
// sum (a NaN logit) stays NaN, so the row's result is NaN, as in the
// plain version.
__device__ __forceinline__ float rescaled(float m, float s, float m_new) {
  return s > 0.0f ? s * expf(m - m_new) : s;
}

// logsumexp(l[0:v]) - l[label] of one token row, by one warp.
__device__ float token_nll(const float* __restrict__ l, int v, long long label,
                           int lane) {
  const float g = (lane == 0 && label >= 0 && label < v) ? l[label] : 0.0f;
  const int misalign = static_cast<int>(reinterpret_cast<uintptr_t>(l) % 16) / 4;
  const int head = min(v, (4 - misalign) % 4);
  const int n4 = (v - head) / 4;
  const int tail = v - head - 4 * n4;
  float m = -INFINITY, s = 0.0f;
  if (lane < head + tail) {
    // The head (lanes below `head`) and the tail (the next `tail` lanes),
    // one scalar a lane: (m, s) = (x, e^(x - x)); a NaN or +inf x gives a
    // NaN s at the first rescale.
    m = l[lane < head ? lane : lane + 4 * n4];
    s = m == -INFINITY ? 0.0f : 1.0f;
  }
  const float4* l4 = reinterpret_cast<const float4*>(l + head);
  const float4 none = make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
  for (int c = lane; c < n4; c += kWarp * kUnroll) {
    float4 q[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) q[u] = c + u * kWarp < n4 ? l4[c + u * kWarp] : none;
    float top = m;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      top = fmaxf(top, fmaxf(fmaxf(q[u].x, q[u].y), fmaxf(q[u].z, q[u].w)));
    }
    // Nothing finite seen yet: every value is -inf and e^(x - 0) adds 0.
    const float ref = top == -INFINITY ? 0.0f : top;
    float acc = rescaled(m, s, ref);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (c + u * kWarp < n4) {
        acc += expf(q[u].x - ref) + expf(q[u].y - ref) + expf(q[u].z - ref) +
               expf(q[u].w - ref);
      }
    }
    m = top;
    s = acc;
  }
  float top = m;
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    top = fmaxf(top, __shfl_xor_sync(0xffffffffu, top, off));
  }
  s = rescaled(m, s, top);
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
  }
  return logf(s) + top - g;
}

// logsumexp(l[0:len]) - l[label] of one token row, by a group of `lanes`
// lanes of a warp (a power of two below 32; `gl` is the lane's place in
// its group). Every lane of the warp calls it; a group with len == 0
// reads nothing.
__device__ float token_nll_group(const float* __restrict__ l, int len,
                                 long long label, int gl, int lanes) {
  const float g = (gl == 0 && label >= 0 && label < len) ? l[label] : 0.0f;
  float m = -INFINITY;
  for (int c = gl; c < len; c += lanes) m = fmaxf(m, l[c]);
  for (int off = lanes / 2; off > 0; off >>= 1) {
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  }
  const float ref = m == -INFINITY ? 0.0f : m;
  float s = 0.0f;
  for (int c = gl; c < len; c += lanes) s += expf(l[c] - ref);
  for (int off = lanes / 2; off > 0; off >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
  }
  return logf(s) + m - g;
}

// One block per example row, a token row to each group of `lanes` lanes;
// `nll` holds one float a group.
template <typename Tok>
__global__ void seq_ce_tokens_kernel(const float* __restrict__ logits,
                                     const Tok* __restrict__ tokens,
                                     float* __restrict__ out, int s_len, int v,
                                     long long pad, int lanes) {
  extern __shared__ float nll[];
  const int lane = threadIdx.x % kWarp;
  const int gl = threadIdx.x % lanes;
  const int slot = threadIdx.x / lanes;  // the group's token in each pass
  const int slots = blockDim.x / lanes;
  const size_t row = blockIdx.x;
  float total = 0.0f;
  // Passes are the same for the whole block, so every lane of a warp
  // reaches the shuffles.
  for (int j0 = 0; j0 < s_len; j0 += slots) {
    const bool live = j0 + slot < s_len;
    const size_t tok_idx = row * s_len + j0 + slot;
    const long long label = live ? static_cast<long long>(tokens[tok_idx]) : pad;
    const bool skip = label == pad;  // the same in every lane of the group
    const float* l = logits + tok_idx * v;
    float val = 0.0f;
    if (lanes == kWarp) {
      if (!skip) val = token_nll(l, v, label, lane);
    } else {
      const float nll_g = token_nll_group(l, skip ? 0 : v, label, gl, lanes);
      if (!skip) val = nll_g;
    }
    if (gl == 0) nll[slot] = val;
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int j = 0; j < min(slots, s_len - j0); ++j) total += nll[j];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) out[row] = total;
}

// The gradient of one token row, by a group of `lanes` lanes as in
// token_nll_group: (e^(l - m) / s - [c == label]) * g for c < v_out, with
// (m, s) the row's max and exp-sum. A pad row (skip) reads nothing and
// writes zeros; v_out == 0 writes nothing. Every lane of the warp calls it.
__device__ void token_grad_group(const float* __restrict__ l, float* __restrict__ d,
                                 int v_out, long long label, bool skip, float g,
                                 int gl, int lanes) {
  const int len = skip ? 0 : v_out;
  // A running (m, s) a lane: a new max rescales s once; -inf adds
  // nothing; a NaN makes s NaN, which every rescale and the group's sum
  // keep, so the whole row's gradient is NaN, as softmax gives.
  float m = -INFINITY, s = 0.0f;
  for (int c = gl; c < len; c += lanes) {
    const float x = l[c];
    if (x > m) {
      s = rescaled(m, s, x) + 1.0f;
      m = x;
    } else if (x != -INFINITY) {
      s += expf(x - m);
    }
  }
  float top = m;
  for (int off = lanes / 2; off > 0; off >>= 1) {
    top = fmaxf(top, __shfl_xor_sync(0xffffffffu, top, off));
  }
  s = rescaled(m, s, top);
  for (int off = lanes / 2; off > 0; off >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
  }
  // A +inf logit: softmax's e^(l - max) is NaN there and so is its sum.
  if (top == INFINITY) s = NAN;
  if (skip) {
    for (int c = gl; c < v_out; c += lanes) d[c] = 0.0f;
    return;
  }
  for (int c = gl; c < v_out; c += lanes) {
    const float p = expf(l[c] - top) / s;
    d[c] = (p - (c == label ? 1.0f : 0.0f)) * g;
  }
}

// One block per example row, a token row to each group of `lanes` lanes.
template <typename Tok>
__global__ void seq_ce_grad_kernel(const float* __restrict__ logits,
                                   const Tok* __restrict__ tokens,
                                   const float* __restrict__ g,
                                   float* __restrict__ dlogits, int s_len, int v,
                                   long long pad, int lanes) {
  const int gl = threadIdx.x % lanes;
  const int slot = threadIdx.x / lanes;  // the group's token in each pass
  const int slots = blockDim.x / lanes;
  const size_t row = blockIdx.x;
  const float g_row = g[row];
  // Passes are the same for the whole block, so every lane of a warp
  // reaches the shuffles.
  for (int j0 = 0; j0 < s_len; j0 += slots) {
    const bool live = j0 + slot < s_len;
    const size_t tok_idx = row * s_len + j0 + slot;
    const long long label = live ? static_cast<long long>(tokens[tok_idx]) : pad;
    token_grad_group(logits + tok_idx * v, dlogits + tok_idx * v, live ? v : 0, label,
                     label == pad, g_row, gl, lanes);
  }
}

bool bad_plan(int n, int s_len, int v, int token_bytes, int lanes, int warps,
              int blocks) {
  return n <= 0 || s_len < 0 || v <= 0 || (token_bytes != 4 && token_bytes != 8) ||
         warps < 1 || warps > kMaxWarps || blocks != n || lanes < 1 || lanes > kWarp ||
         (lanes & (lanes - 1)) != 0;
}

}  // namespace

extern "C" const char* seq_ce_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// tokens: int32 when token_bytes == 4, int64 when token_bytes == 8.
// n blocks (`blocks` == n) of `warps` warps (1-32), a token row to each
// group of `lanes` lanes (1, 2, 4, 8, 16 or 32).
extern "C" int seq_ce_rows(const float* logits, const void* tokens,
                           int token_bytes, float* out, int n, int s_len,
                           int v, long long pad, int lanes, int warps,
                           int blocks, cudaStream_t stream) {
  if (bad_plan(n, s_len, v, token_bytes, lanes, warps, blocks)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(blocks), block(kWarp * warps);
  const size_t smem = sizeof(float) * kWarp * warps / lanes;
  if (token_bytes == 4) {
    seq_ce_tokens_kernel<int32_t><<<grid, block, smem, stream>>>(
        logits, static_cast<const int32_t*>(tokens), out, s_len, v, pad, lanes);
  } else {
    seq_ce_tokens_kernel<int64_t><<<grid, block, smem, stream>>>(
        logits, static_cast<const int64_t*>(tokens), out, s_len, v, pad, lanes);
  }
  return static_cast<int>(cudaGetLastError());
}

// The VJP of seq_ce_rows: dlogits (n, s_len, v) from the logits, the
// tokens and the (n,) upstream gradient g, in the same launch layout.
extern "C" int seq_ce_rows_grad(const float* logits, const void* tokens,
                                int token_bytes, const float* g, float* dlogits,
                                int n, int s_len, int v, long long pad, int lanes,
                                int warps, int blocks, cudaStream_t stream) {
  if (bad_plan(n, s_len, v, token_bytes, lanes, warps, blocks)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(blocks), block(kWarp * warps);
  if (token_bytes == 4) {
    seq_ce_grad_kernel<int32_t><<<grid, block, 0, stream>>>(
        logits, static_cast<const int32_t*>(tokens), g, dlogits, s_len, v, pad, lanes);
  } else {
    seq_ce_grad_kernel<int64_t><<<grid, block, 0, stream>>>(
        logits, static_cast<const int64_t*>(tokens), g, dlogits, s_len, v, pad, lanes);
  }
  return static_cast<int>(cudaGetLastError());
}
