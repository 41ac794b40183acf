// Masked sequence cross-entropy (N, S, V) -> (N,) for Hopper (sm_90a).
//
// seq_ce_rows replaces mmvae_tpu/ops/kernels.py:masked_seq_ce_pallas
// (_seq_ce_kernel through the pallas_call in _seq_ce_fwd_impl): per
// example row n,
//     out[n] = sum_s [tok[n,s] != pad] * (logsumexp_v l[n,s,v] - l[n,s,tok]).
// The TPU kernel streamed vocab tiles through VMEM with a running max and
// a rescaled exp-sum in scratch, and left the sum over S to XLA. Here one
// warp owns an example row and does both.
//
// What bounds it: memory. Each logit costs a compare, a subtract, one
// exp and an add against 4 bytes read. A pad token needs none of its
// logits, and the warp reads its token first and skips the row, so the
// least traffic is the non-pad token rows' logits, the tokens and the
// output. At the MultiMNIST eval shape (200, 5, 13) that is under 40 KB,
// a fraction of a microsecond at 3.35 TB/s: the kernel is bound by launch
// latency there, as the row reductions of row_reduce.cu are.
//
// Design: one warp per example row, rows grid-strided over a fixed number
// of blocks. For each of the row's S tokens, every lane reads the token
// (a warp-uniform branch skips pad tokens), then strides over the V
// logits keeping its own running max m and rescaled sum s (the online
// log-sum-exp that _seq_ce_kernel does across vocab tiles). A shuffle
// tree merges the lanes' (m, s) pairs:
//     m = max(m1, m2),  s = s1 * e^(m1 - m) + s2 * e^(m2 - m),
// where a lane that saw no logit (V < 32) holds (-inf, 0) and adds
// nothing. The label logit is one load by lane 0, not a compare across
// the row. Lane 0 keeps the row's sum over S in a register and writes it
// once, so the sum over S needs no second op. The loop bound handles any
// V, so no column mask is needed; loads are scalar and coalesced across
// the warp (consecutive lanes read consecutive logits).
// No fast-math: expf/logf track the plain PyTorch version to rounding.
//
// C interface (bound with ctypes): seq_ce_rows launches on `stream`, does
// not synchronise, and returns cudaGetLastError() of its launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kMaxBlocks = 4096;

// Adds s * e^(m - m_new) for a partial (m, s); a lane that saw nothing
// has s == 0 and m == -inf, whose exponent would be NaN.
__device__ __forceinline__ float rescaled(float m, float s, float m_new) {
  return s > 0.0f ? s * expf(m - m_new) : 0.0f;
}

template <typename Tok>
__global__ void seq_ce_rows_kernel(const float* __restrict__ logits,
                                   const Tok* __restrict__ tokens,
                                   float* __restrict__ out, int n, int s_len,
                                   int v, long long pad) {
  const int lane = threadIdx.x % kWarp;
  const int warp = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  const int n_warps = gridDim.x * kWarpsPerBlock;
  for (int row = warp; row < n; row += n_warps) {
    float total = 0.0f;
    for (int t = 0; t < s_len; ++t) {
      const size_t tok_idx = static_cast<size_t>(row) * s_len + t;
      const long long label = static_cast<long long>(tokens[tok_idx]);
      if (label == pad) continue;  // same token in every lane
      const float* l = logits + tok_idx * v;
      float m = -INFINITY, s = 0.0f;
      for (int c = lane; c < v; c += kWarp) {
        const float x = l[c];
        if (x > m) {
          s = rescaled(m, s, x) + 1.0f;
          m = x;
        } else if (x != -INFINITY) {
          s += expf(x - m);
        }
      }
#pragma unroll
      for (int off = kWarp / 2; off > 0; off >>= 1) {
        const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
        const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
        const float m_new = fmaxf(m, m2);
        s = rescaled(m, s, m_new) + rescaled(m2, s2, m_new);
        m = m_new;
      }
      if (lane == 0) {
        const float g = (label >= 0 && label < v) ? l[label] : 0.0f;
        total += logf(s) + m - g;
      }
    }
    if (lane == 0) out[row] = total;
  }
}

int n_blocks(int n) {
  const int b = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  return b < kMaxBlocks ? b : kMaxBlocks;
}

}  // namespace

extern "C" const char* seq_ce_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// tokens: int32 when token_bytes == 4, int64 when token_bytes == 8.
extern "C" int seq_ce_rows(const float* logits, const void* tokens,
                           int token_bytes, float* out, int n, int s_len,
                           int v, long long pad, cudaStream_t stream) {
  if (n <= 0 || s_len < 0 || v <= 0 ||
      (token_bytes != 4 && token_bytes != 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(n_blocks(n)), block(kWarp * kWarpsPerBlock);
  if (token_bytes == 4) {
    seq_ce_rows_kernel<int32_t><<<grid, block, 0, stream>>>(
        logits, static_cast<const int32_t*>(tokens), out, n, s_len, v, pad);
  } else {
    seq_ce_rows_kernel<int64_t><<<grid, block, 0, stream>>>(
        logits, static_cast<const int64_t*>(tokens), out, n, s_len, v, pad);
  }
  return static_cast<int>(cudaGetLastError());
}
