// The tied-vocab product of one block, shared by the greedy head
// (vocab_head.cu) and the top-k head (topk_head.cu):
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
