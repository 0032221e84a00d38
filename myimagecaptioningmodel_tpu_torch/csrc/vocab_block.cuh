// The tied-vocab product of one block, shared by the greedy head
// (vocab_head.cu) and the heads of the whole-decode kernels D and E
// (fused_transformer.cu):
//
//   lg[r][m] = (proj[m0 + m] . table[v0 + r]) (* scale[v0 + r]) + bias[v0 + r]
//
// for the block's 32 vocab rows r and MT batch rows m; rows >= V are -inf.
// The [B, V] logits never reach device memory: each head reduces lg in its
// own epilogue.
//
// Numerics of the TPU kernels' _block_logits
// (myimagecaptioningmodel_tpu/ops/pallas/vocab_head.py): proj is rounded to
// the table's dtype, or to bfloat16 for an int8 table (whose values are exact
// in bfloat16); products accumulate in float32; an int8 table's per-row scale
// multiplies the sum, then the bias is added, as two rounded operations.
//
// Layout: each warp takes 4 table rows; a lane loads 16 bytes of each (8 for
// int8; the rows' elements are one coalesced read per warp), multiplies them with the
// batch rows staged in shared memory, and the lane partial sums meet in one
// warp reduce-scatter.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace capk {

constexpr int kHeadWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kVocabBlock = kHeadWarps * kRowsPerWarp;  // table rows per block

// (v, i) ranks above (bv, bi): larger, or equal with a lower index. Every
// reduction of the heads uses it, so any order gives the lowest index on ties.
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// dtype the batch rows are staged in: the table's, bfloat16 for int8
template <typename T>
struct Stage {
  using type = T;
};
template <>
struct Stage<int8_t> {
  using type = __nv_bfloat16;
};

// A lane's share of a table row: one 16-byte vector, but 8 bytes for int8, so
// that an E=256 row spans the warp's 32 lanes in every dtype (16-byte int8
// vectors left half of the lanes idle). W elements per load.
template <typename T>
struct TableVec {
  using raw = uint4;
  static constexpr int W = Vec<T>::W;
};
template <>
struct TableVec<int8_t> {
  using raw = uint2;
  static constexpr int W = 8;
};

// Element j of a lane's table load, as float; with j known at compile time
// it is a move, a shift, or a shift and a convert, so the raw load stays in
// 2-4 registers instead of W floats. Every int8 value is exact in float and
// in bfloat16.
__device__ __forceinline__ float table_elem(const float*, const uint4& u, int j) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  return __uint_as_float(w[j]);
}
// bf16 is the high half of a float32: element 2i is the low 16 bits of word i
__device__ __forceinline__ float table_elem(const __nv_bfloat16*, const uint4& u, int j) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  return __uint_as_float((j & 1) ? (w[j >> 1] & 0xffff0000u) : (w[j >> 1] << 16));
}
// int8, little-endian: element 4i + b is byte b of word i, sign-extended
__device__ __forceinline__ float table_elem(const int8_t*, const uint2& u, int j) {
  const uint32_t w[2] = {u.x, u.y};
  return (float)((int32_t)(w[j >> 2] << (24 - 8 * (j & 3))) >> 24);
}

template <typename T, int MT>
constexpr size_t staged_bytes(int E) {
  return (size_t)MT * E * sizeof(typename Stage<T>::type);
}

// Fills lg[kVocabBlock][MT + 1] (the +1 keeps a warp's reads of one column
// off a single bank) and ends with __syncthreads(). smem holds
// staged_bytes<T, MT>(E) bytes, 16-byte aligned. E is a multiple of
// TableVec<T>::W and of 8. scale is null for float tables.
template <typename T, int MT>
__device__ __forceinline__ void vocab_block_logits(
    const float* __restrict__ proj, const T* __restrict__ table,
    const float* __restrict__ bias, const float* __restrict__ scale, int M, int V,
    int E, int m0, int v0, unsigned char* smem, float (*lg)[MT + 1]) {
  using S = typename Stage<T>::type;
  using Raw = typename TableVec<T>::raw;
  constexpr int WT = TableVec<T>::W, WS = Vec<S>::W, R = kRowsPerWarp;
  constexpr int NVAL = R * MT, PER = NVAL / 32;
  constexpr int NCH = MT / WS;  // 16-byte chunks of one e across the MT rows
  static_assert(MT % WS == 0, "batch tile must be whole 16-byte vectors");
  // Batch rows rounded to S. Element (e, m) lives in 16-byte chunk
  // (e % WT, m / WS, e / WT) of a [WT][NCH][EQ] chunk array, so that when
  // lane q reads element j of its table load q, the 32 lanes read 32
  // consecutive chunks (no bank conflicts); a plain [E][MT] layout puts the
  // lanes WT * MT elements apart, on the same banks.
  uint4* Pc = reinterpret_cast<uint4*>(smem);
  const int EQ = E / WT;
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch) {
    for (int e = threadIdx.x; e < E; e += blockDim.x) {
      float f[WS];
#pragma unroll
      for (int j = 0; j < WS; ++j) {
        const int row = m0 + ch * WS + j;
        f[j] = row < M ? proj[(long)row * E + e] : 0.f;
      }
      Pc[((long)(e % WT) * NCH + ch) * EQ + e / WT] = pack(f);
    }
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int vbase = v0 + warp * R;
  float acc[NVAL];  // acc[r * MT + m]
#pragma unroll
  for (int i = 0; i < NVAL; ++i) acc[i] = 0.f;
  for (int q = lane; q < EQ; q += 32) {
    // the rows' raw loads; element j is unpacked where it is used
    // (unpacked up front, R * WT floats held the int8 instances at 180-190
    // registers)
    Raw tr[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      tr[r] = vbase + r < V ? __ldg(reinterpret_cast<const Raw*>(table + (long)(vbase + r) * E) + q)
                            : Raw{};
    }
#pragma unroll
    for (int j = 0; j < WT; ++j) {
      float p[MT];
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch) {
        float f[WS];
        unpack(Pc[((long)j * NCH + ch) * EQ + q], f);
#pragma unroll
        for (int x = 0; x < WS; ++x) p[ch * WS + x] = f[x];
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float t = table_elem(table, tr[r], j);
#pragma unroll
        for (int m = 0; m < MT; ++m) acc[r * MT + m] = fmaf(p[m], t, acc[r * MT + m]);
      }
    }
  }
  warp_reduce_scatter<NVAL>(acc, lane);
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int idx = PER * lane + i, r = idx / MT, m = idx % MT, v = vbase + r;
    float l = -INFINITY;
    if (v < V) {
      l = scale != nullptr ? __fmul_rn(acc[i], scale[v]) : acc[i];
      l = __fadd_rn(l, bias[v]);
    }
    lg[warp * R + r][m] = l;
  }
  __syncthreads();
}

// ---- the heads' kernels: kernel A's argmax and kernel E's top-k, each a
// per-block partial and a per-row combine (design in vocab_head.cu; the
// top-k keeps kernel C's order, topk_head.cu). Each returns at once when
// *skip is set: the whole-decode kernels (fused_transformer.cu) pass their
// early-stop flag, kernel A's entry null.
template <typename T, int MT>
__global__ void __launch_bounds__(kHeadWarps * 32)
    vocab_argmax_partial(const float* __restrict__ proj,   // [M, E] f32
                         const T* __restrict__ table,      // [V, E]
                         const float* __restrict__ bias,   // [V]
                         const float* __restrict__ scale,  // [V] or null
                         float* __restrict__ part_v,       // [M, nblk]
                         int* __restrict__ part_i,         // [M, nblk]
                         int M, int V, int E, const int* __restrict__ skip) {
  if (skip != nullptr && *skip) return;
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

static __global__ void __launch_bounds__(32)
    vocab_argmax_combine(const float* __restrict__ part_v,
                         const int* __restrict__ part_i, int nblk,
                         int* __restrict__ out, const int* __restrict__ skip) {
  if (skip != nullptr && *skip) return;
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
                           int E, const int* skip, cudaStream_t stream) {
  static const bool raised = raise_smem_limit(vocab_argmax_partial<T, MT>);
  const size_t smem = staged_bytes<T, MT>(E);
  if (!raised || smem > kMaxDynamicSmem) return false;
  dim3 grid((V + kVocabBlock - 1) / kVocabBlock, (M + MT - 1) / MT);
  vocab_argmax_partial<T, MT><<<grid, kHeadWarps * 32, smem, stream>>>(
      proj, static_cast<const T*>(table), bias, scale, part_v, part_i, M, V, E, skip);
  return true;
}

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
                 int M, int V, int E, const int* __restrict__ skip) {
  if (skip != nullptr && *skip) return;
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

static __global__ void __launch_bounds__(kCombineThreads)
    topk_combine(const float* __restrict__ part_v, const int* __restrict__ part_i,
                 const float* __restrict__ part_m, const float* __restrict__ part_s,
                 int nblk, int k, float* __restrict__ vals, int* __restrict__ ids,
                 float* __restrict__ lse, const int* __restrict__ skip) {
  if (skip != nullptr && *skip) return;
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
                                const int* skip, cudaStream_t stream) {
  static const bool raised = raise_smem_limit(topk_partial<T, MT>);
  const size_t smem = staged_bytes<T, MT>(E);
  if (!raised || smem > kMaxDynamicSmem) return false;
  dim3 grid((V + kVocabBlock - 1) / kVocabBlock, (M + MT - 1) / MT);
  topk_partial<T, MT><<<grid, kHeadWarps * 32, smem, stream>>>(
      proj, static_cast<const T*>(table), bias, scale, k, part_v, part_i, part_m, part_s,
      M, V, E, skip);
  return true;
}

// Calls launch((T*)nullptr) with the table's element type T for a dtype
// code (a generic lambda reads T back with TableT), false for an unknown code.
template <class Launch>
inline bool dispatch_table_dtype(int table_dtype, Launch&& launch) {
  switch (table_dtype) {
    case kF32:
      return launch(static_cast<float*>(nullptr));
    case kBF16:
      return launch(static_cast<__nv_bfloat16*>(nullptr));
    case kI8:
      return launch(static_cast<int8_t*>(nullptr));
    default:
      return false;
  }
}

template <class Tag>
using TableT = typename std::remove_pointer<Tag>::type;

}  // namespace capk
