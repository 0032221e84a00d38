// Kernel A's launch (vocab_head.cu), for the greedy entry capk_vocab_argmax
// and for the greedy heads of the whole decodes of kernels D
// (fused_transformer.cu) and B (fused_step.cu), and their step tail.
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
// errors are left for cudaGetLastError(). out_v, if not null, gets each
// row's winning logit.
bool vocab_argmax_launch(int table_dtype, int M, int V, int E, const float* proj,
                         const void* table, const float* bias, const float* scale,
                         float* part_v, int* part_i, int pstride, int* out, const int* skip,
                         bool pdl, cudaStream_t stream, float* out_v = nullptr);

// The greedy decodes' step tail (kernels D and B's whole decodes), after
// the argmax: with `early`, rows that are done emit <pad> and a row is done
// once it has emitted <stop>, and *flag is set once every row is done (the
// decode's later kernels then return at once); ids_t[B] gets the step's
// words. One block of kGreedyFinishThreads; programmatic dependent launch
// ready (it reads nothing before griddep_wait()).
constexpr int kGreedyFinishThreads = 256;
__global__ void __launch_bounds__(kGreedyFinishThreads)
    greedy_finish(int* word, int* done, int* flag, int* ids_t, int B, int pad, int stop,
                  int early);

}  // namespace capk
