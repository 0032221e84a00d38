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
// Both kernels live in vocab_block.cuh, where kernel E (fused_transformer.cu)
// runs them too.
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
                                                    part_i, part_m, part_s, M, V, E, nullptr, stream)
                  : capk::launch_topk_partial<T, 16>(proj, table, bias, scale, k, part_v,
                                                     part_i, part_m, part_s, M, V, E,
                                                     nullptr, stream);
  });
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  capk::topk_combine<<<M, capk::kCombineThreads, 0, stream>>>(
      part_v, part_i, part_m, part_s, (V + capk::kVocabBlock - 1) / capk::kVocabBlock, k,
      vals, ids, lse, nullptr);
  return (int)cudaGetLastError();
}

}  // extern "C"
