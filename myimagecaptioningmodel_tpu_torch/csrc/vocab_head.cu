// Greedy tied-vocab head: ids[b] = argmax_v (proj[b] . table[v] (* scale[v])
// + bias[v]).
//
// Replaces myimagecaptioningmodel_tpu/ops/pallas/vocab_head.py::
// greedy_vocab_argmax. The TPU kernel walks the vocab in 2048-row blocks on
// one core and carries a running (max, argmax) in VMEM scratch from one grid
// step to the next. Blocks of a CUDA grid run in parallel and in no order, so
// the running state becomes a two-pass reduction:
//
//   1. vocab_argmax_partial: grid (32-row vocab block) x (8- or 16-row batch
//      tile). The block's logits come from vocab_block_logits
//      (vocab_block.cuh: float32 accumulation of compute-dtype operands, as
//      the TPU kernel's preferred_element_type=float32 dot; an int8 table's
//      scale after the sum, then the bias; rows >= V masked to -inf); the
//      block writes one (max, index) per batch row.
//   2. vocab_argmax_combine: one warp per batch row reduces the block pairs.
//
// Tie rule: jnp.argmax returns the LOWEST index among equal maxima. Every
// comparison here (across the rows of a block, across blocks, across the
// lanes of the combining warp) takes a candidate when its value is larger,
// or equal with a lower index, so any reduction order gives the lowest index.
//
// What bounds it on an H100: the table is read once per 16-row batch tile
// (12416 x 256 bf16 = 6.4 MB, about 2 us of HBM bandwidth, L2 for the later
// tiles; int8 halves it); the [B, V] logits never reach device memory, only
// B x 388 (max, index) pairs do. At B = 128 the product is 0.8 GFLOP of FMA
// on CUDA cores; a tensor-core version is later work.
#include "vocab_block.cuh"

namespace capk {

template <typename T, int MT>
__global__ void __launch_bounds__(kHeadWarps * 32)
    vocab_argmax_partial(const float* __restrict__ proj,   // [M, E] f32
                         const T* __restrict__ table,      // [V, E]
                         const float* __restrict__ bias,   // [V]
                         const float* __restrict__ scale,  // [V] or null
                         float* __restrict__ part_v,       // [M, nblk]
                         int* __restrict__ part_i,         // [M, nblk]
                         int M, int V, int E) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float lg[kVocabBlock][MT + 1];
  const int nblk = gridDim.x, m0 = blockIdx.y * MT, v0 = blockIdx.x * kVocabBlock;
  vocab_block_logits<T, MT>(proj, table, bias, scale, M, V, E, m0, v0, smem, lg);
  for (int m = threadIdx.x; m < MT; m += blockDim.x) {
    const int row = m0 + m;
    if (row >= M) continue;
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int r = 0; r < kVocabBlock; ++r) {
      if (better(lg[r][m], v0 + r, bv, bi)) {
        bv = lg[r][m];
        bi = v0 + r;
      }
    }
    part_v[(long)row * nblk + blockIdx.x] = bv;
    part_i[(long)row * nblk + blockIdx.x] = bi;
  }
}

__global__ void __launch_bounds__(32)
    vocab_argmax_combine(const float* __restrict__ part_v,
                         const int* __restrict__ part_i, int nblk,
                         int* __restrict__ out) {
  const int row = blockIdx.x, lane = threadIdx.x;
  float bv = -INFINITY;
  int bi = INT_MAX;
  for (int b = lane; b < nblk; b += 32) {
    const float v = part_v[(long)row * nblk + b];
    const int i = part_i[(long)row * nblk + b];
    if (better(v, i, bv, bi)) {
      bv = v;
      bi = i;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, bv, off);
    const int oi = __shfl_down_sync(0xffffffffu, bi, off);
    if (better(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
    }
  }
  if (lane == 0) out[row] = bi;
}

template <typename T, int MT>
static bool launch_partial(const float* proj, const void* table, const float* bias,
                           const float* scale, float* part_v, int* part_i, int M, int V,
                           int E, cudaStream_t stream) {
  static const bool raised = raise_smem_limit(vocab_argmax_partial<T, MT>);
  const size_t smem = staged_bytes<T, MT>(E);
  if (!raised || smem > kMaxDynamicSmem) return false;
  dim3 grid((V + kVocabBlock - 1) / kVocabBlock, (M + MT - 1) / MT);
  vocab_argmax_partial<T, MT><<<grid, kHeadWarps * 32, smem, stream>>>(
      proj, static_cast<const T*>(table), bias, scale, part_v, part_i, M, V, E);
  return true;
}

}  // namespace capk

extern "C" {

// Number of vocab blocks, i.e. the width of the wrappers' partial buffers
// (the greedy and the top-k head share the block size).
int capk_vocab_argmax_nblocks(int V) {
  return (V + capk::kVocabBlock - 1) / capk::kVocabBlock;
}

// ids[M] = argmax over proj[M, E] . table[V, E]^T (* scale[V]) + bias[V].
// table_dtype: capk::kF32, kBF16, or kI8 with a float32 scale (null for the
// float tables); proj is float32 and is rounded to the table's dtype (to
// bfloat16 for int8) before the product. E must be a multiple of 8.
// Returns cudaGetLastError() (cudaErrorInvalidValue for operands the kernel
// does not take).
int capk_vocab_argmax(int table_dtype, int M, int V, int E, const float* proj,
                      const void* table, const float* bias, const float* scale,
                      float* part_v, int* part_i, int* out, cudaStream_t stream) {
  if (M < 1 || V < 1 || (table_dtype == capk::kI8) != (scale != nullptr))
    return (int)cudaErrorInvalidValue;
  const bool ok = capk::dispatch_table_dtype(table_dtype, [&](auto tag) {
    using T = capk::TableT<decltype(tag)>;
    if (E % 8 != 0) return false;
    return M <= 8 ? capk::launch_partial<T, 8>(proj, table, bias, scale, part_v, part_i,
                                               M, V, E, stream)
                  : capk::launch_partial<T, 16>(proj, table, bias, scale, part_v, part_i,
                                                M, V, E, stream);
  });
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  capk::vocab_argmax_combine<<<M, 32, 0, stream>>>(part_v, part_i,
                                                   capk_vocab_argmax_nblocks(V), out);
  return (int)cudaGetLastError();
}

}  // extern "C"
