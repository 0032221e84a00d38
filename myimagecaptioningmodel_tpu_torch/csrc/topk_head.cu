// Beam-search tied-vocab head: per batch row, the top k of
//   logits[v] = proj . table[v] (* scale[v]) + bias[v]
// as (vals, ids), sorted by value and then by ascending index, and the row's
// logsumexp over all V logits.
//
// Replaces myimagecaptioningmodel_tpu/ops/pallas/vocab_head.py::
// topk_vocab_head. The TPU kernel walks the vocab in 1024-row blocks on one
// core and carries a running top-k and a running (max, sum) in VMEM scratch
// from one grid step to the next. Blocks of a CUDA grid run in parallel and
// in no order, so the running state becomes a two-pass reduction, as in
// vocab_head.cu:
//
//   1. topk_partial: grid (32-row vocab block) x (8- or 16-row batch tile).
//      The block's logits come from vocab_block_logits (vocab_block.cuh, the
//      product the greedy head uses: f32, bf16 or int8 + scale tables, rows
//      >= V masked). Then one warp per batch row, one lane per vocab row:
//      the block's (max, sum exp(l - max)) by warp reductions, and its top k
//      by k rounds of a warp argmax, each taking the best row not yet taken.
//      Only M x nblk x k candidates and M x nblk (max, sum) pairs reach
//      device memory, never the [M, V] logits.
//   2. topk_combine: one block per batch row. k rounds over the row's
//      nblk * k candidates, each taking the best candidate that ranks below
//      the previous pick; and lse = M + log(sum_b s_b * exp(m_b - M)) with
//      M the largest block max.
//
// Tie rule: larger, or equal with the lower index, at every comparison. So
// ids come out sorted by value and then ascending index: jax.lax.top_k's
// order and the TPU kernel's (its rounds and its merge take the first
// argmax). 1 <= k <= 32 (a block has 32 rows; beam search uses k = W).
//
// What bounds it on an H100: the product is the greedy head's (the table read
// once per 16-row batch tile; 0.8 GFLOP of FMA on CUDA cores at 128 rows x
// 12416 x 256). With 32-row vocab blocks the partial buffers hold
// 388 x k candidates per row (6.4 MB at 512 rows and k = 4), written and read
// once; the combine reads them with k passes. Larger vocab blocks per CUDA
// block, tensor cores and TMA are later work.
#include "vocab_block.cuh"

namespace capk {

constexpr int kMaxK = 32;  // vocab_head.py's TOPK_MAX_K
constexpr int kCombineThreads = 256;

template <typename T, int MT>
__global__ void __launch_bounds__(kHeadWarps * 32)
    topk_partial(const float* __restrict__ proj,   // [M, E] f32
                 const T* __restrict__ table,      // [V, E]
                 const float* __restrict__ bias,   // [V]
                 const float* __restrict__ scale,  // [V] or null
                 int k,
                 float* __restrict__ part_v,  // [M, nblk, k]
                 int* __restrict__ part_i,    // [M, nblk, k]
                 float* __restrict__ part_m,  // [M, nblk]
                 float* __restrict__ part_s,  // [M, nblk]
                 int M, int V, int E) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float lg[kVocabBlock][MT + 1];
  const int nblk = gridDim.x, m0 = blockIdx.y * MT, v0 = blockIdx.x * kVocabBlock;
  vocab_block_logits<T, MT>(proj, table, bias, scale, M, V, E, m0, v0, smem, lg);

  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int vi = v0 + lane;
  const bool valid = vi < V;
  for (int m = warp; m < MT && m0 + m < M; m += kHeadWarps) {
    const long base = (long)(m0 + m) * nblk + blockIdx.x;
    const float l = lg[lane][m];
    float mx = valid ? l : -INFINITY;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float s = valid ? expf(l - mx) : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) {
      part_m[base] = mx;
      part_s[base] = s;
    }
    bool taken = !valid;
    for (int i = 0; i < k; ++i) {
      float bv = taken ? -INFINITY : l;
      int bi = taken ? INT_MAX : vi;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        if (better(ov, oi, bv, bi)) {
          bv = ov;
          bi = oi;
        }
      }
      // every lane now holds the block's i-th pick; a block with fewer than
      // k rows left gives (-inf, INT_MAX), which loses to every real row
      if (lane == 0) {
        part_v[base * k + i] = bv;
        part_i[base * k + i] = bi;
      }
      taken = taken || vi == bi;
    }
  }
}

// Best (v, i) of the block, left in sh_v[0] / sh_i[0]; ends synchronized.
__device__ __forceinline__ void block_best(float bv, int bi, float* sh_v, int* sh_i) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, bv, off);
    const int oi = __shfl_down_sync(0xffffffffu, bi, off);
    if (better(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
    }
  }
  __syncthreads();  // earlier readers of sh_v / sh_i are done
  if (lane == 0) {
    sh_v[warp] = bv;
    sh_i[warp] = bi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kCombineThreads / 32; ++w) {
      if (better(sh_v[w], sh_i[w], sh_v[0], sh_i[0])) {
        sh_v[0] = sh_v[w];
        sh_i[0] = sh_i[w];
      }
    }
  }
  __syncthreads();
}

// Sum (or max) of v over the block, returned to every thread.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* sh) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = kMax ? fmaxf(v, o) : v + o;
  }
  __syncthreads();
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  v = sh[0];
  for (int w = 1; w < kCombineThreads / 32; ++w) v = kMax ? fmaxf(v, sh[w]) : v + sh[w];
  return v;
}

__global__ void __launch_bounds__(kCombineThreads)
    topk_combine(const float* __restrict__ part_v, const int* __restrict__ part_i,
                 const float* __restrict__ part_m, const float* __restrict__ part_s,
                 int nblk, int k, float* __restrict__ vals, int* __restrict__ ids,
                 float* __restrict__ lse) {
  __shared__ float sh_v[kCombineThreads / 32];
  __shared__ int sh_i[kCombineThreads / 32];
  const int row = blockIdx.x;
  const long n = (long)nblk * k;
  const float* cv = part_v + row * n;
  const int* ci = part_i + row * n;
  // candidates are distinct vocab rows, so "ranks below the previous pick"
  // excludes exactly the ones already taken
  float pv = INFINITY;
  int pi = -1;
  for (int r = 0; r < k; ++r) {
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (long c = threadIdx.x; c < n; c += kCombineThreads) {
      const float v = cv[c];
      const int i = ci[c];
      if (better(pv, pi, v, i) && better(v, i, bv, bi)) {
        bv = v;
        bi = i;
      }
    }
    block_best(bv, bi, sh_v, sh_i);
    pv = sh_v[0];
    pi = sh_i[0];
    if (threadIdx.x == 0) {
      vals[(long)row * k + r] = pv;
      ids[(long)row * k + r] = pi;
    }
  }

  const float* pm = part_m + (long)row * nblk;
  const float* ps = part_s + (long)row * nblk;
  float mx = -INFINITY;
  for (int b = threadIdx.x; b < nblk; b += kCombineThreads) mx = fmaxf(mx, pm[b]);
  mx = block_reduce<true>(mx, sh_v);
  float s = 0.f;
  for (int b = threadIdx.x; b < nblk; b += kCombineThreads) s += ps[b] * expf(pm[b] - mx);
  s = block_reduce<false>(s, sh_v);
  if (threadIdx.x == 0) lse[row] = mx + logf(s);
}

template <typename T, int MT>
static bool launch_topk_partial(const float* proj, const void* table, const float* bias,
                                const float* scale, int k, float* part_v, int* part_i,
                                float* part_m, float* part_s, int M, int V, int E,
                                cudaStream_t stream) {
  static const bool raised = raise_smem_limit(topk_partial<T, MT>);
  const size_t smem = staged_bytes<T, MT>(E);
  if (!raised || smem > kMaxDynamicSmem) return false;
  dim3 grid((V + kVocabBlock - 1) / kVocabBlock, (M + MT - 1) / MT);
  topk_partial<T, MT><<<grid, kHeadWarps * 32, smem, stream>>>(
      proj, static_cast<const T*>(table), bias, scale, k, part_v, part_i, part_m, part_s,
      M, V, E);
  return true;
}

}  // namespace capk

extern "C" {

// vals[M, k], ids[M, k]: the top k of proj[M, E] . table[V, E]^T (* scale[V])
// + bias[V] per row, sorted; lse[M]: the row's logsumexp. table_dtype and
// scale as for capk_vocab_argmax. part_v / part_i hold M x nblk x k and
// part_m / part_s M x nblk elements, nblk = capk_vocab_argmax_nblocks(V).
// Returns cudaGetLastError() (cudaErrorInvalidValue for operands the kernel
// does not take).
int capk_topk_head(int table_dtype, int M, int V, int E, int k, const float* proj,
                   const void* table, const float* bias, const float* scale,
                   float* part_v, int* part_i, float* part_m, float* part_s, float* vals,
                   int* ids, float* lse, cudaStream_t stream) {
  if (M < 1 || k < 1 || k > capk::kMaxK || k > V ||
      (table_dtype == capk::kI8) != (scale != nullptr))
    return (int)cudaErrorInvalidValue;
  const bool ok = capk::dispatch_table_dtype(table_dtype, [&](auto tag) {
    using T = capk::TableT<decltype(tag)>;
    if (E % 8 != 0) return false;
    return M <= 8 ? capk::launch_topk_partial<T, 8>(proj, table, bias, scale, k, part_v,
                                                    part_i, part_m, part_s, M, V, E, stream)
                  : capk::launch_topk_partial<T, 16>(proj, table, bias, scale, k, part_v,
                                                     part_i, part_m, part_s, M, V, E,
                                                     stream);
  });
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  capk::topk_combine<<<M, capk::kCombineThreads, 0, stream>>>(
      part_v, part_i, part_m, part_s, (V + capk::kVocabBlock - 1) / capk::kVocabBlock, k,
      vals, ids, lse);
  return (int)cudaGetLastError();
}

}  // extern "C"
