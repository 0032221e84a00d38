// Kernel A's launch (vocab_head.cu), for the greedy entry capk_vocab_argmax
// and for the greedy head of the whole-decode kernel D (fused_transformer.cu).
#pragma once

#include <cuda_runtime.h>

namespace capk {

// Width of kernel A's partial buffers: ceil(V / 32), the column count of
// [M, width] part_v / part_i for every tile configuration.
int vocab_argmax_width(int V);

// Enqueues ids[M] = argmax_v proj[M, E] . table[v] (* scale[v]) + bias[v] on
// `stream`: the tile kernel and the per-row merge. part_v / part_i hold
// [M, pstride] (pstride >= vocab_argmax_width(V)). Both kernels return at
// once when skip is not null and *skip is set; `pdl` launches both with
// programmatic dependent launch (common.cuh's launch_k). false for operands
// the kernels do not take (the caller then reads no CUDA error); launch
// errors are left for cudaGetLastError().
bool vocab_argmax_launch(int table_dtype, int M, int V, int E, const float* proj,
                         const void* table, const float* bias, const float* scale,
                         float* part_v, int* part_i, int pstride, int* out, const int* skip,
                         bool pdl, cudaStream_t stream);

}  // namespace capk
