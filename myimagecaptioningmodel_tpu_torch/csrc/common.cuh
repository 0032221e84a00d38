// Shared device helpers for the decode-path kernels (vocab_head.cu,
// topk_head.cu, fused_step.cu, fused_transformer.cu): 16-byte vector loads
// unpacked to float, rounding to the compute dtype, the warp product that the
// FMA [M, K] x [K, N] products run through, a warp reduce-scatter, the heads'
// tie rule, and programmatic dependent launch.
//
// The JAX reference computes every product as `dot(a.astype(dt), b)` with a
// float32 accumulator (preferred_element_type=float32). The helpers do the
// same: operands are rounded to the compute dtype T, multiplied and
// accumulated in float.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace capk {

// dtype codes shared with the Python wrappers
enum DType : int { kF32 = 0, kBF16 = 1, kI8 = 2 };

// elements of T in one 16-byte vector
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int W = 4;
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int W = 8;
};

__device__ __forceinline__ float ld(const float* p, long i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, long i) {
  return __bfloat162float(p[i]);
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
// bf16 is the high half of a float32: element 2i is the low 16 bits of word i
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// 16-byte aligned global load of Vec<T>::W elements, as float
template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float (&f)[Vec<T>::W]) {
  unpack(__ldg(reinterpret_cast<const uint4*>(p)), f);
}

// MT consecutive T from 16-byte aligned shared memory, as float
template <typename T, int MT>
__device__ __forceinline__ void load_row(const T* p, float (&a)[MT]) {
  constexpr int W = Vec<T>::W;
  static_assert(MT % W == 0, "row must be whole 16-byte vectors");
#pragma unroll
  for (int q = 0; q < MT / W; ++q) {
    float f[W];
    unpack(reinterpret_cast<const uint4*>(p)[q], f);
#pragma unroll
    for (int j = 0; j < W; ++j) a[q * W + j] = f[j];
  }
}

// W floats rounded to T (to nearest even, as XLA's convert) and packed into
// one 16-byte vector
__device__ __forceinline__ uint4 pack(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}
__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 b = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&b);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Stage rows [m0, m0 + MT) of an [M, K] operand into shared memory as T in
// [K][MT] order (row m of k at At[k * MT + m]), rounded to T; rows >= M are
// zero. value(row, k) returns the float element. A thread takes whole k:
// its MT reads are independent, the warp's reads of one row are coalesced,
// and the k's MT values land as 16-byte vectors.
template <typename T, int MT, class Value>
__device__ __forceinline__ void stage_rows(T* At, int m0, int M, int K, Value value) {
  constexpr int W = Vec<T>::W;
  static_assert(MT % W == 0, "row must be whole 16-byte vectors");
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
#pragma unroll
    for (int q = 0; q < MT / W; ++q) {
      float f[W];
#pragma unroll
      for (int j = 0; j < W; ++j) {
        const int row = m0 + q * W + j;
        f[j] = row < M ? value(row, k) : 0.f;
      }
      reinterpret_cast<uint4*>(At + (long)k * MT)[q] = pack(f);
    }
  }
}

// One warp's share of a product with one 16-byte column vector of a
// row-major weight, K split over KS warps: warp `split` takes, for k in
// [k0, k1), k = k0 + 32 split + lane + 32 KS i, and adds
//   acc[m * W + j] += At[k][m] * w[(k - k0) * ldw + j].
// w points at the vector's first column; rows are ldw elements apart. Each
// lane's loads are independent, so a warp has all of them in flight at once.
template <typename T, int MT, int KS>
__device__ __forceinline__ void colvec_product(const T* __restrict__ At,
                                               const T* __restrict__ w, long ldw,
                                               int k0, int k1, int split, int lane,
                                               float (&acc)[MT * Vec<T>::W]) {
  constexpr int W = Vec<T>::W;
#pragma unroll 4
  for (int k = k0 + 32 * split + lane; k < k1; k += 32 * KS) {
    float wf[W], a[MT];
    load_vec<T>(w + (long)(k - k0) * ldw, wf);
    load_row<T, MT>(At + (long)k * MT, a);
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < W; ++j) acc[m * W + j] = fmaf(a[m], wf[j], acc[m * W + j]);
  }
}

template <int N, int ACTIVE, int OFF>
__device__ __forceinline__ void rs_step(float (&v)[N], int lane) {
  const bool upper = (lane & OFF) != 0;
#pragma unroll
  for (int i = 0; i < ACTIVE / 2; ++i) {
    const float send = upper ? v[i] : v[i + ACTIVE / 2];
    const float keep = upper ? v[i + ACTIVE / 2] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
  }
}

// Sum v over the 32 lanes of the warp, leaving the sums scattered: afterwards
// v[i] for i < N / 32 holds the warp-wide sum of element (N / 32) * lane + i.
template <int N>
__device__ __forceinline__ void warp_reduce_scatter(float (&v)[N], int lane) {
  static_assert(N % 32 == 0, "reduce-scatter needs a multiple of 32 values");
  rs_step<N, N, 16>(v, lane);
  rs_step<N, N / 2, 8>(v, lane);
  rs_step<N, N / 4, 4>(v, lane);
  rs_step<N, N / 8, 2>(v, lane);
  rs_step<N, N / 16, 1>(v, lane);
}

// Dynamic shared memory a kernel may ask for, once raise_smem_limit has run
// on it (the H100 allows 227 KB per block).
constexpr size_t kMaxDynamicSmem = 200 * 1024;

template <class Kernel>
inline bool raise_smem_limit(Kernel* kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)kMaxDynamicSmem) == cudaSuccess;
}

// ---- programmatic dependent launch (kernels D and E, and A's and C's kernels
// as their heads) ----
//
// A kernel launched with `pdl` may start while the kernel before it on the
// stream still runs, once every block of that kernel has called
// griddep_launch_dependents() or exited. griddep_wait() returns when the
// kernels before it have completed and their writes are visible. Both are
// no-ops for a kernel launched without the attribute.
__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void griddep_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// The early-stop flag of kernels D and E, read past every cache: it goes
// from 0 to 1 only, so a 1 read before griddep_wait() is final.
__device__ __forceinline__ bool flag_set(const int* skip) {
  return skip != nullptr && *reinterpret_cast<const volatile int*>(skip) != 0;
}

// The prologue of a kernel that reads nothing before its predecessors end:
// true if it is to return (the flag is set), else it has waited and let its
// dependents launch.
__device__ __forceinline__ bool pdl_enter(const int* skip) {
  if (flag_set(skip)) return true;
  griddep_wait();
  if (flag_set(skip)) return true;
  griddep_launch_dependents();
  return false;
}

// Launches kernel<<<grid, block, smem, stream>>>(args...), with the
// programmatic-stream-serialization attribute when `pdl`. Returns the launch
// error.
template <typename... Params, typename... Args>
inline cudaError_t launch_k(bool pdl, void (*kernel)(Params...), dim3 grid, dim3 block,
                            size_t smem, cudaStream_t stream, Args&&... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pdl ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
}

// ---- the vocab heads' shared rules (kernels A, C, D, E) ----

// (v, i) ranks above (bv, bi): larger, or equal with a lower index. Every
// reduction of the heads uses it, so any order gives the lowest index on ties.
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

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
