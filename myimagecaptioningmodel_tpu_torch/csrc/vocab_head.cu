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
// Both kernels live in vocab_block.cuh, where kernel D (fused_transformer.cu)
// runs them too.
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
                                               M, V, E, nullptr, stream)
                  : capk::launch_partial<T, 16>(proj, table, bias, scale, part_v, part_i,
                                                M, V, E, nullptr, stream);
  });
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  capk::vocab_argmax_combine<<<M, 32, 0, stream>>>(part_v, part_i, capk_vocab_argmax_nblocks(V),
                                                   out, nullptr);
  return (int)cudaGetLastError();
}

}  // extern "C"
