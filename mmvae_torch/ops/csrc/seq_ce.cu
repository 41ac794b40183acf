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
// Each token row's max and exp-sum are recomputed rather than saved by the
// forward, whose layout stays as it is.
//
// What bounds it: memory. The non-pad rows' logits read once and every
// gradient written once: at (2048, 8, 5003) with half the tokens pad, about
// 164 MB read and 328 MB written, 145 us at 3.35 TB/s; at the synthetic CUB
// shape (4096, 32, 23) 18.6 MB, 5.5 us. At the MultiMNIST train shape
// (300, 5, 13) it is under 160 KB and the launch bounds it.
//
// Design (kernels.py:seq_ce_grad_plan picks the path, the examples a block,
// the lanes, the warps and the blocks by the shape; kernel_plans.py times
// every path). Blocks walk the chunks of `examples` examples with the grid's
// stride. No atomics: a shape gives the same bits from run to run. The first
// design, a group of lanes a token row in the forward's layout, read the row
// in strided scalars, twice: at CUB's V = 23 each warp access spans 16 rows 92
// B apart (about 12 L1 wavefronts), and at V = 5003 a lane has one scalar load
// in flight. Measured on the H100 (PERF.md) it keeps only the calls it still
// wins.
//
// Small V, staged (path 0: V <= 128 and at least 32 tokens an SM). An
// example's S x V logits are contiguous, so a chunk of examples is one slab
// (2,944 B an example at CUB's shape). The block stages it in shared memory
// with coalesced float4 loads, kStage a thread issued before any is stored,
// at the slab's own 16-byte phase, so a slab that starts off a boundary
// takes a scalar head and tail. The tokens load concurrently with the slab,
// and the pad rows are staged too: a variant that read the tokens first and
// skipped the pad rows' float4s measured slower at every shape (PERF.md).
// After a barrier each token row goes to a group of `lanes` lanes (a power
// of two, up to 16 logits a lane, 32 at an odd V, whose rows start on
// distinct banks): the group's max by shuffles, then e^(l - max) written
// back over the staged logits and summed by shuffles, then the gradient (e
// / sum - [v == tok]) * g written over it; a pad row's is zeros. After a
// second barrier the whole block writes the slab out linearly, element i by
// thread i, as float4 stores at the output's 16-byte phase (from float4
// shared-memory reads where the two phases agree).
//
// Few tokens (path 2: V <= 128 and under 32 tokens an SM, MultiMNIST's train
// shapes): bound by latency, where the first design, with no barrier and no
// shared memory, stays the fastest; kept as it was.
//
// Larger V, a warp a token row (path 1). The forward's (max, exp-sum) pass
// (row_max_expsum, shared with token_nll: float4 loads, kUnroll in flight
// a lane, scalar head and tail), then a second float4 pass that reads the
// row back from L1 or L2 and stores (e^(l - max) / sum - [v == tok]) * g
// with the same peel. Where the gradient and the logits differ in 16-byte
// phase (an offset view of the logits) the second pass is scalar. A pad row
// reads no logit and writes float4 zeros. Once the rows in flight outgrow
// the L2 (V of thousands), the second read goes to device memory: 245 us at
// (2048, 8, 5003) for a 145 us bound (PERF.md). No ported config runs such a
// vocabulary yet.
//
// NaN and +inf: fmaxf skips a NaN, whose e^(l - max) is NaN and makes the
// row's sum, and so its whole gradient, NaN, as softmax does; a +inf logit
// makes its own e^(inf - inf) NaN, and the same follows.
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

// The max of l[0:v] and the sum of e^(l - max), by one warp; every lane
// returns both. A NaN or +inf logit makes the sum NaN.
__device__ float2 row_max_expsum(const float* __restrict__ l, int v, int lane) {
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
  return make_float2(top, s);
}

// logsumexp(l[0:v]) - l[label] of one token row, by one warp.
__device__ float token_nll(const float* __restrict__ l, int v, long long label,
                           int lane) {
  const float g = (lane == 0 && label >= 0 && label < v) ? l[label] : 0.0f;
  const float2 ms = row_max_expsum(l, v, lane);
  return logf(ms.y) + ms.x - g;
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

// ------------------------------------------------------------ gradient ----

// Paths of seq_ce_rows_grad (kernels.py:SEQ_GRAD_*).
constexpr int kStaged = 0, kWarpRow = 1, kGroups = 2;
constexpr int kStage = 4;               // float4s of the slab a thread loads at once
constexpr int kMaxSmem = 48 * 1024;     // bytes of a staged block
constexpr int kMaxGradWarps = 16;       // warps a block (__launch_bounds__)
// A staged token row's label: its vocabulary index, kNoLabel for a non-pad
// token outside [0, v) (no one-hot, as the plain version), or kPadRow.
constexpr int kNoLabel = -1, kPadRow = -2;

__device__ __forceinline__ int label_code(long long label, long long pad, int v) {
  return label == pad ? kPadRow : (label >= 0 && label < v ? static_cast<int>(label) : kNoLabel);
}

__device__ __forceinline__ int phase16(const float* p) {
  return static_cast<int>(reinterpret_cast<uintptr_t>(p) % 16) / 4;
}

// Floats of a staged block's shared memory: the row labels and the chunk's
// g (rounded up to a float4), then the slab and up to 3 floats of phase.
__host__ __device__ __forceinline__ long long staged_floats(int examples, int s_len, int v) {
  const long long rows = static_cast<long long>(examples) * s_len;
  return (rows + examples + 3) / 4 * 4 + rows * v + 4;
}

// Small V: a block stages a chunk of `examples` examples' S x V logits,
// scores each token row by a group of `lanes` lanes in shared memory and
// writes the chunk's gradient linearly (see the note at the top).
template <typename Tok>
__global__ void __launch_bounds__(kMaxGradWarps * kWarp)
seq_ce_grad_staged_kernel(const float* __restrict__ logits, const Tok* __restrict__ tokens,
                          const float* __restrict__ g, float* __restrict__ dlogits, int n,
                          int s_len, int v, long long pad, int lanes, int examples) {
  extern __shared__ float4 smem4[];
  int* s_code = reinterpret_cast<int*>(smem4);
  float* s_g = reinterpret_cast<float*>(smem4) + examples * s_len;
  float* s_slab = reinterpret_cast<float*>(smem4) + (examples * s_len + examples + 3) / 4 * 4;
  const int tid = threadIdx.x, threads = blockDim.x;
  const int gl = tid % lanes, grp = tid / lanes, groups = threads / lanes;
  // Chunk n0 / examples, then every gridDim.x-th; no divide before the loads.
  const int stride = gridDim.x * examples;
  for (int n0 = blockIdx.x * examples; n0 < n; n0 += stride) {
    const int n_ex = min(n, n0 + examples) - n0;
    const int rows = n_ex * s_len, len = rows * v;
    const size_t row0 = static_cast<size_t>(n0) * s_len;
    const float* src = logits + row0 * v;
    float* dst = dlogits + row0 * v;
    // s[i] is slab element i, at src's 16-byte phase: s + head is aligned.
    const int mis = phase16(src);
    float* s = s_slab + mis;
    const int head = min(len, (4 - mis) % 4);
    const int n4 = (len - head) / 4;
    const int tail = len - head - 4 * n4;
    const float4* src4 = reinterpret_cast<const float4*>(src + head);
    float4* s4 = reinterpret_cast<float4*>(s + head);

    // The thread's first label and g, loaded before the slab.
    const long long label0 = tid < rows ? static_cast<long long>(tokens[row0 + tid]) : pad;
    const float g0 = tid < n_ex ? g[n0 + tid] : 0.0f;
    const float x_edge = tid < head + tail ? src[tid < head ? tid : tid + 4 * n4] : 0.0f;
    for (int i0 = tid; i0 < n4; i0 += kStage * threads) {
      float4 q[kStage];
#pragma unroll
      for (int u = 0; u < kStage; ++u) {
        const int i = i0 + u * threads;
        if (i < n4) q[u] = src4[i];
      }
#pragma unroll
      for (int u = 0; u < kStage; ++u) {
        const int i = i0 + u * threads;
        if (i < n4) s4[i] = q[u];
      }
    }
    if (tid < head + tail) s[tid < head ? tid : tid + 4 * n4] = x_edge;
    if (tid < rows) s_code[tid] = label_code(label0, pad, v);
    for (int r = tid + threads; r < rows; r += threads) {
      s_code[r] = label_code(static_cast<long long>(tokens[row0 + r]), pad, v);
    }
    if (tid < n_ex) s_g[tid] = g0;
    for (int e = tid + threads; e < n_ex; e += threads) s_g[e] = g[n0 + e];
    __syncthreads();

    // A token row to each group; the passes are the same for the whole
    // block, so every lane of a warp reaches the shuffles.
    for (int r0 = 0; r0 < rows; r0 += groups) {
      const int r = r0 + grp;
      const int code = r < rows ? s_code[r] : kPadRow;
      const int len_r = code == kPadRow ? 0 : v;  // the same in every lane of the group
      float* x = s + static_cast<size_t>(r < rows ? r : 0) * v;
      float m = -INFINITY;
      for (int c = gl; c < len_r; c += lanes) m = fmaxf(m, x[c]);
      for (int off = lanes / 2; off > 0; off >>= 1) {
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      }
      float sum = 0.0f;
      for (int c = gl; c < len_r; c += lanes) {
        const float e = expf(x[c] - m);
        x[c] = e;
        sum += e;
      }
      for (int off = lanes / 2; off > 0; off >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      }
      if (r < rows) {
        if (code == kPadRow) {
          for (int c = gl; c < v; c += lanes) x[c] = 0.0f;
        } else {
          const float gr = s_g[r / s_len];
          for (int c = gl; c < v; c += lanes) {
            x[c] = (x[c] / sum - (c == code ? 1.0f : 0.0f)) * gr;
          }
        }
      }
    }
    __syncthreads();

    // The slab out, element i by thread i, at dst's 16-byte phase.
    const int mis_o = phase16(dst);
    const int head_o = min(len, (4 - mis_o) % 4);
    const int n4_o = (len - head_o) / 4;
    const int tail_o = len - head_o - 4 * n4_o;
    if (tid < head_o + tail_o) {
      const int i = tid < head_o ? tid : tid + 4 * n4_o;
      dst[i] = s[i];
    }
    float4* dst4 = reinterpret_cast<float4*>(dst + head_o);
    if (mis_o == mis) {
      const float4* so4 = reinterpret_cast<const float4*>(s + head_o);
      for (int i = tid; i < n4_o; i += threads) dst4[i] = so4[i];
    } else {
      for (int i = tid; i < n4_o; i += threads) {
        const float* q = s + head_o + 4 * i;
        dst4[i] = make_float4(q[0], q[1], q[2], q[3]);
      }
    }
    if (n0 + stride < n) __syncthreads();  // the slab is reused
  }
}

// d[0:v] = 0 by one warp: float4 stores from d's 16-byte boundary.
__device__ void zero_row(float* __restrict__ d, int v, int lane) {
  const int head = min(v, (4 - phase16(d)) % 4);
  const int n4 = (v - head) / 4;
  const int tail = v - head - 4 * n4;
  if (lane < head + tail) d[lane < head ? lane : lane + 4 * n4] = 0.0f;
  float4* d4 = reinterpret_cast<float4*>(d + head);
  for (int c = lane; c < n4; c += kWarp) d4[c] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// The gradient of one non-pad token row of v logits, by one warp.
__device__ void token_grad_warp(const float* __restrict__ l, float* __restrict__ d, int v,
                                long long label, float g, int lane) {
  const float2 ms = row_max_expsum(l, v, lane);
  const float top = ms.x, s = ms.y;
  auto grad = [=](float x, int c) {
    return (expf(x - top) / s - (c == label ? 1.0f : 0.0f)) * g;
  };
  const int mis = phase16(l);
  if (mis != phase16(d)) {
    for (int c0 = lane; c0 < v; c0 += kWarp * kUnroll) {
      float q[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (c0 + u * kWarp < v) q[u] = l[c0 + u * kWarp];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int c = c0 + u * kWarp;
        if (c < v) d[c] = grad(q[u], c);
      }
    }
    return;
  }
  const int head = min(v, (4 - mis) % 4);
  const int n4 = (v - head) / 4;
  const int tail = v - head - 4 * n4;
  if (lane < head + tail) {
    const int c = lane < head ? lane : lane + 4 * n4;
    d[c] = grad(l[c], c);
  }
  const float4* l4 = reinterpret_cast<const float4*>(l + head);
  float4* d4 = reinterpret_cast<float4*>(d + head);
  for (int c0 = lane; c0 < n4; c0 += kWarp * kUnroll) {
    float4 q[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (c0 + u * kWarp < n4) q[u] = l4[c0 + u * kWarp];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = c0 + u * kWarp;
      if (i < n4) {
        const int c = head + 4 * i;
        d4[i] = make_float4(grad(q[u].x, c), grad(q[u].y, c + 1), grad(q[u].z, c + 2),
                            grad(q[u].w, c + 3));
      }
    }
  }
}

// Large V: a warp a token row; a block takes the token rows of a chunk of
// `examples` examples, its warps striding over them.
template <typename Tok>
__global__ void __launch_bounds__(kMaxGradWarps * kWarp)
seq_ce_grad_warp_kernel(const float* __restrict__ logits, const Tok* __restrict__ tokens,
                        const float* __restrict__ g, float* __restrict__ dlogits, int n,
                        int s_len, int v, long long pad, int examples) {
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int warps = blockDim.x / kWarp;
  for (int n0 = blockIdx.x * examples; n0 < n; n0 += gridDim.x * examples) {
    const int rows = (min(n, n0 + examples) - n0) * s_len;
    const size_t row0 = static_cast<size_t>(n0) * s_len;
    for (int r = warp; r < rows; r += warps) {
      const size_t tok_idx = row0 + r;
      const long long label = static_cast<long long>(tokens[tok_idx]);
      float* d = dlogits + tok_idx * v;
      if (label == pad) {
        zero_row(d, v, lane);
      } else {
        token_grad_warp(logits + tok_idx * v, d, v, label, g[n0 + r / s_len], lane);
      }
    }
  }
}

// The gradient of one token row by a group of `lanes` lanes, reading the
// row from device memory: (e^(l - m) / s - [c == label]) * g for c <
// v_out, with (m, s) the row's max and exp-sum. A pad row (skip) reads
// nothing and writes zeros; v_out == 0 writes nothing. Every lane of the
// warp calls it.
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

// Few tokens (path 4), the first design's layout: a block per example row, a
// token row to each group of `lanes` lanes, each group reading its row from
// device memory twice (the second time from L1). No shared memory and no
// barrier: where the call is bound by latency, a group's chain is its own
// loads.
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

bool bad_grad_plan(int n, int s_len, int v, int token_bytes, int path, int lanes,
                   int examples, int warps, int blocks) {
  if (n <= 0 || s_len <= 0 || v <= 0 || (token_bytes != 4 && token_bytes != 8) ||
      path < kStaged || path > kGroups || lanes < 1 || lanes > kWarp ||
      (lanes & (lanes - 1)) != 0 || examples < 1 || warps < 1 || warps > kMaxGradWarps ||
      blocks < 1 || blocks > (n + examples - 1) / examples) {
    return true;
  }
  if (path == kGroups) return examples != 1 || blocks != n;
  return path == kStaged && 4 * staged_floats(min(examples, n), s_len, v) > kMaxSmem;
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
// tokens and the (n,) upstream gradient g, in the launch plan of
// kernels.py:seq_ce_grad_plan: `path` (0: staged; 1: a warp a token row;
// 2: a group of `lanes` lanes a token row, read from device memory, a block
// an example: examples == 1, blocks == n), `lanes` a token row on the
// staged and group paths, `examples` a chunk, `warps` a block (1-16) and `blocks` (at most the
// chunks, which they walk with the grid's stride). A staged block's shared
// memory must fit in 48 KB.
extern "C" int seq_ce_rows_grad(const float* logits, const void* tokens,
                                int token_bytes, const float* g, float* dlogits,
                                int n, int s_len, int v, long long pad, int path,
                                int lanes, int examples, int warps, int blocks,
                                cudaStream_t stream) {
  if (bad_grad_plan(n, s_len, v, token_bytes, path, lanes, examples, warps, blocks)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(blocks), block(kWarp * warps);
  const bool wide = token_bytes == 8;
  const int32_t* t32 = static_cast<const int32_t*>(tokens);
  const int64_t* t64 = static_cast<const int64_t*>(tokens);
  if (path == kGroups) {
    if (wide) {
      seq_ce_grad_kernel<int64_t><<<grid, block, 0, stream>>>(
          logits, t64, g, dlogits, s_len, v, pad, lanes);
    } else {
      seq_ce_grad_kernel<int32_t><<<grid, block, 0, stream>>>(
          logits, t32, g, dlogits, s_len, v, pad, lanes);
    }
    return static_cast<int>(cudaGetLastError());
  }
  if (path == kWarpRow) {
    if (wide) {
      seq_ce_grad_warp_kernel<int64_t><<<grid, block, 0, stream>>>(
          logits, t64, g, dlogits, n, s_len, v, pad, examples);
    } else {
      seq_ce_grad_warp_kernel<int32_t><<<grid, block, 0, stream>>>(
          logits, t32, g, dlogits, n, s_len, v, pad, examples);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = 4 * staged_floats(min(examples, n), s_len, v);
  const int ex = min(examples, n);
  if (wide) {
    seq_ce_grad_staged_kernel<int64_t><<<grid, block, smem, stream>>>(
        logits, t64, g, dlogits, n, s_len, v, pad, lanes, ex);
  } else {
    seq_ce_grad_staged_kernel<int32_t><<<grid, block, smem, stream>>>(
        logits, t32, g, dlogits, n, s_len, v, pad, lanes, ex);
  }
  return static_cast<int>(cudaGetLastError());
}
