// Kernel C's launch (topk_head.cu), for the beam entry capk_topk_head and for
// the beam head of the whole-decode kernel E (fused_transformer.cu).
#pragma once

#include <cuda_runtime.h>

namespace capk {

constexpr int kMaxK = 32;  // vocab_head.py's TOPK_MAX_K

// Vocab rows of one tile: the partial buffers hold ceil(V / tile) tiles a row.
int topk_head_vocab_tile();

// Enqueues, per row of proj[M, E], the top k of proj . table[v] (* scale[v]) +
// bias[v] into vals / ids [M, k] (by value, then ascending index) and the
// row's logsumexp into lse[M]: the tile kernel and the merge. part_v /
// part_i hold [M, nvt, k] and part_m / part_s [M, nvt], nvt = ceil(V /
// topk_head_vocab_tile()). Both kernels return at once when skip is not null
// and *skip is set; `pdl` launches both with programmatic dependent launch.
// false for operands the kernels do not take; launch errors are left for
// cudaGetLastError().
bool topk_head_launch(int table_dtype, int M, int V, int E, int k, const float* proj,
                      const void* table, const float* bias, const float* scale, float* part_v,
                      int* part_i, float* part_m, float* part_s, float* vals, int* ids,
                      float* lse, const int* skip, bool pdl, cudaStream_t stream);

}  // namespace capk
