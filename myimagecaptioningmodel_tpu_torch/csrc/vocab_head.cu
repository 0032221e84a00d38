// Greedy tied-vocab head: ids[b] = argmax_v (proj[b] . table[v] + bias[v]).
//
// Replaces myimagecaptioningmodel_tpu/ops/pallas/vocab_head.py::
// greedy_vocab_argmax. The TPU kernel walks the vocab in 2048-row blocks on
// one core and carries a running (max, argmax) in VMEM scratch from one grid
// step to the next. Blocks of a CUDA grid run in parallel and in no order, so
// the running state becomes a two-pass reduction:
//
//   1. vocab_argmax_partial: grid (32-row vocab block) x (8- or 16-row batch
//      tile). Each warp takes 4 table rows; a lane loads 16 bytes of each
//      (the rows' 256 bf16 elements are one coalesced 512-byte read per
//      warp), multiplies them with the batch rows staged in shared memory,
//      and the lane partial sums meet in one warp reduce-scatter. Float32
//      accumulation of compute-dtype operands, as the TPU kernel's
//      preferred_element_type=float32 dot. The block adds the bias, masks
//      rows >= V to -inf and writes one (max, index) per batch row.
//   2. vocab_argmax_combine: one warp per batch row reduces the block pairs.
//
// Tie rule: jnp.argmax returns the LOWEST index among equal maxima. Every
// comparison here (across the rows of a block, across blocks, across the
// lanes of the combining warp) takes a candidate when its value is larger,
// or equal with a lower index, so any reduction order gives the lowest index.
//
// What bounds it on an H100: the table is read once per 16-row batch tile
// (12416 x 256 bf16 = 6.4 MB, about 2 us of HBM bandwidth, L2 for the later
// tiles); the [B, V] logits never reach device memory, only B x 388
// (max, index) pairs do. At B = 128 the product is 0.8 GFLOP of FMA on CUDA
// cores; a tensor-core version is later work.
#include "common.cuh"

namespace capk {

constexpr int kHeadWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kVocabBlock = kHeadWarps * kRowsPerWarp;  // table rows per block

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

template <typename T, int MT>
__global__ void __launch_bounds__(kHeadWarps * 32)
    vocab_argmax_partial(const float* __restrict__ proj,  // [M, E] f32
                         const T* __restrict__ table,     // [V, E]
                         const float* __restrict__ bias,  // [V]
                         float* __restrict__ part_v,      // [M, nblk]
                         int* __restrict__ part_i,        // [M, nblk]
                         int M, int V, int E) {
  constexpr int W = Vec<T>::W, R = kRowsPerWarp, NVAL = R * MT, PER = NVAL / 32;
  constexpr int NCH = MT / W;  // 16-byte chunks of one e across the MT rows
  extern __shared__ __align__(16) unsigned char smem[];
  // Batch rows rounded to T. Element (e, m) lives in 16-byte chunk
  // (e % W, m / W, e / W) of a [W][NCH][EQ] chunk array, so that when lane
  // q reads element j of its e-vector q, the 32 lanes read 32 consecutive
  // chunks (no bank conflicts); a plain [E][MT] layout puts the lanes W * MT
  // elements apart, on the same banks.
  uint4* Pc = reinterpret_cast<uint4*>(smem);
  __shared__ float red_v[kVocabBlock][MT];
  __shared__ int red_i[kVocabBlock][MT];
  const int nblk = gridDim.x, m0 = blockIdx.y * MT, EQ = E / W;
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch) {
    for (int e = threadIdx.x; e < E; e += blockDim.x) {
      float f[W];
#pragma unroll
      for (int j = 0; j < W; ++j) {
        const int row = m0 + ch * W + j;
        f[j] = row < M ? proj[(long)row * E + e] : 0.f;
      }
      Pc[((long)(e % W) * NCH + ch) * EQ + e / W] = pack(f);
    }
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int vbase = blockIdx.x * kVocabBlock + warp * R;
  float acc[NVAL];  // acc[r * MT + m]
#pragma unroll
  for (int i = 0; i < NVAL; ++i) acc[i] = 0.f;
  for (int q = lane; q < EQ; q += 32) {
    float tf[R][W];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (vbase + r < V) {
        load_vec<T>(table + (long)(vbase + r) * E + q * W, tf[r]);
      } else {
#pragma unroll
        for (int j = 0; j < W; ++j) tf[r][j] = 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < W; ++j) {
      float p[MT];
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch) {
        float f[W];
        unpack(Pc[((long)j * NCH + ch) * EQ + q], f);
#pragma unroll
        for (int x = 0; x < W; ++x) p[ch * W + x] = f[x];
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int m = 0; m < MT; ++m) acc[r * MT + m] = fmaf(p[m], tf[r][j], acc[r * MT + m]);
    }
  }
  warp_reduce_scatter<NVAL>(acc, lane);
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int idx = PER * lane + i, r = idx / MT, m = idx % MT, v = vbase + r;
    red_v[warp * R + r][m] = v < V ? acc[i] + bias[v] : -INFINITY;
    red_i[warp * R + r][m] = v;
  }
  __syncthreads();
  for (int m = threadIdx.x; m < MT; m += blockDim.x) {
    const int row = m0 + m;
    if (row >= M) continue;
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int r = 0; r < kVocabBlock; ++r) {
      if (better(red_v[r][m], red_i[r][m], bv, bi)) {
        bv = red_v[r][m];
        bi = red_i[r][m];
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
                           float* part_v, int* part_i, int M, int V, int E,
                           cudaStream_t stream) {
  static const bool raised = raise_smem_limit(vocab_argmax_partial<T, MT>);
  const size_t smem = (size_t)MT * E * sizeof(T);
  if (!raised || smem > kMaxDynamicSmem) return false;
  dim3 grid((V + kVocabBlock - 1) / kVocabBlock, (M + MT - 1) / MT);
  vocab_argmax_partial<T, MT><<<grid, kHeadWarps * 32, smem, stream>>>(
      proj, static_cast<const T*>(table), bias, part_v, part_i, M, V, E);
  return true;
}

}  // namespace capk

extern "C" {

// Number of vocab blocks, i.e. the width of the wrapper's part_v / part_i.
int capk_vocab_argmax_nblocks(int V) {
  return (V + capk::kVocabBlock - 1) / capk::kVocabBlock;
}

// ids[M] = argmax over proj[M, E] . table[V, E]^T + bias[V].
// table_dtype: capk::kF32 or capk::kBF16; proj is float32 and is rounded to
// the table's dtype before the product. E must be a multiple of 8.
// Returns cudaGetLastError() (cudaErrorInvalidValue for shapes the kernel
// does not take).
int capk_vocab_argmax(int table_dtype, int M, int V, int E, const float* proj,
                      const void* table, const float* bias, float* part_v,
                      int* part_i, int* out, cudaStream_t stream) {
  if (M < 1 || E % 8 != 0) return (int)cudaErrorInvalidValue;
  bool ok;
  if (table_dtype == capk::kBF16) {
    using T = __nv_bfloat16;
    ok = M <= 8 ? capk::launch_partial<T, 8>(proj, table, bias, part_v, part_i, M, V, E, stream)
                : capk::launch_partial<T, 16>(proj, table, bias, part_v, part_i, M, V, E, stream);
  } else if (table_dtype == capk::kF32) {
    ok = M <= 8
             ? capk::launch_partial<float, 8>(proj, table, bias, part_v, part_i, M, V, E, stream)
             : capk::launch_partial<float, 16>(proj, table, bias, part_v, part_i, M, V, E, stream);
  } else {
    ok = false;
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  capk::vocab_argmax_combine<<<M, 32, 0, stream>>>(part_v, part_i,
                                                   capk_vocab_argmax_nblocks(V), out);
  return (int)cudaGetLastError();
}

}  // extern "C"
