// 1x1 convolution as a matrix product, with the batch-norm statistics of its
// output taken in the same pass (kernel F):
//   y[M, N] = x[M, K] @ w[K, N], accumulated in float and stored as T;
//   sum[n] = sum_m y[m, n], sumsq[n] = sum_m y[m, n]^2 over the STORED,
//   rounded y, in float (what the unfused BN reads back from memory).
//
// Replaces myimagecaptioningmodel_tpu/ops/pallas/matmul_bn.py:72
// _matmul_stats. The TPU kernel walks M in blocks on one core and carries the
// two column sums in VMEM from one grid step to the next. Blocks of a CUDA
// grid run in parallel and in no order, so the carried sums become a
// two-pass reduction:
//
//   1. matmul_stats_tiles: grid (gx, ceil(N / 64)). Block (bx, by) takes the
//      128-row tiles bx, bx + gx, bx + 2 gx, ... of the 64-column tile by.
//      For each it computes the [128, 64] product over K in 32-deep chunks
//      staged in shared memory (bf16: tensor cores through nvcuda::wmma,
//      16x16x16 fragments with float accumulators, a 32x32 tile per warp;
//      float32: FMA, an 8x4 tile per thread), rounds it to T, stores it, and
//      adds the rounded values and their squares to per-thread column sums.
//      At the end the block writes one row of partial sums, part_s[bx, :]
//      and part_q[bx, :].
//   2. stats_reduce: per column, the gx partial rows in a fixed order.
//
// No atomics: every sum runs in an order fixed by the shapes and the card,
// so the statistics do not change from run to run. gx is one wave of blocks
// on this card shared among the column tiles (and at most the row tiles),
// so the partial rows stay under about a thousand.
//
// Any M, K, N >= 1: rows, depths and columns past the edge load as zero and
// store nothing. Loads are 16 bytes wide where a row's length in bytes and
// the base address allow (K and N multiples of 8 in bf16, of 4 in float32:
// every conv of MobileNetV2 x1.0), else one element at a time.
//
// What bounds it on an H100: bytes. The 1x1 convs of MobileNetV2 have
// K, N <= 1280, under the card's ~295 bf16 operations per byte, so the
// least time is reading x and w once and writing y once; the statistics add
// only 2 x gx x N floats. The design keeps the statistics out of a second
// read of y (the unfused BN's), and runs the bf16 product on tensor cores,
// not FMA (an FMA product lost to cuBLAS at many rows in the decode
// kernels). x is re-read once per 64-column tile (from L2 for the wide
// convs); the tile loop does not overlap its loads with its products within
// a block (other resident blocks do). TMA, wgmma and a pipelined persistent
// schedule are later work.
#include <mma.h>

#include <type_traits>

#include "common.cuh"

namespace capk {

constexpr int kMBM = 128;  // rows of a tile
constexpr int kMBN = 64;   // columns of a tile
constexpr int kMBK = 32;   // depth staged per chunk
constexpr int kMThreads = 256;
constexpr int kLdC = kMBN + 4;          // float accumulator tile [kMBM][kLdC]
constexpr int kLdAh = kMBK + 8;         // bf16 x tile [kMBM][kLdAh], row-major
constexpr int kLdBh = kMBN + 8;         // bf16 w tile [kMBK][kLdBh]
constexpr int kLdAf = kMBM + 4;         // float32 x tile [kMBK][kLdAf], transposed
constexpr int kLdBf = kMBN + 4;         // float32 w tile [kMBK][kLdBf]
constexpr int kBytesH = (kMBM * kLdAh + kMBK * kLdBh) * 2;
constexpr int kBytesF = (kMBK * kLdAf + kMBK * kLdBf) * 4;
constexpr int kBytesC = kMBM * kLdC * 4;
// the accumulator tile reuses the operand tiles' memory after the K loop
constexpr int kMSmem = kBytesC > (kBytesH > kBytesF ? kBytesH : kBytesF)
                           ? kBytesC
                           : (kBytesH > kBytesF ? kBytesH : kBytesF);

template <typename T>
using Raw = typename std::conditional<sizeof(T) == 2, uint16_t, uint32_t>::type;

// Elements [c, c + W) of a row as raw 16 bytes; those at or past `limit`
// are zero. One 16-byte load when the row allows it (`vec`).
template <typename T>
__device__ __forceinline__ uint4 load_chunk(const T* row, int c, int limit, bool vec) {
  constexpr int W = Vec<T>::W;
  if (vec && c + W <= limit) return __ldg(reinterpret_cast<const uint4*>(row + c));
  union {
    uint4 u;
    Raw<T> r[W];
  } v;
  v.u = make_uint4(0u, 0u, 0u, 0u);
  const Raw<T>* rr = reinterpret_cast<const Raw<T>*>(row);
#pragma unroll
  for (int j = 0; j < W; ++j)
    if (c + j < limit) v.r[j] = rr[c + j];
  return v.u;
}

__device__ __forceinline__ float round_to(float v, float*) { return v; }
__device__ __forceinline__ float round_to(float v, __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Stage the chunk [k0, k0 + kMBK) of x rows [m0, m0 + kMBM) and w columns
// [n0, n0 + kMBN) into shared memory.
template <typename T>
__device__ __forceinline__ void stage(unsigned char* smem, const T* __restrict__ x,
                                      const T* __restrict__ w, int M, int K, int N, int m0,
                                      int n0, int k0, bool vec_x, bool vec_w) {
  constexpr int W = Vec<T>::W;
  constexpr bool kHalf = sizeof(T) == 2;
  constexpr int ldb = kHalf ? kLdBh : kLdBf;
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = As + (kHalf ? kMBM * kLdAh : kMBK * kLdAf);
  constexpr int kChunksA = kMBK / W;
  for (int i = threadIdx.x; i < kMBM * kChunksA; i += kMThreads) {
    const int r = i / kChunksA, c = (i % kChunksA) * W, row = m0 + r;
    const uint4 v = row < M ? load_chunk(x + (long)row * K, k0 + c, K, vec_x)
                            : make_uint4(0u, 0u, 0u, 0u);
    if constexpr (kHalf) {
      *reinterpret_cast<uint4*>(As + r * kLdAh + c) = v;
    } else {  // transposed, so that a thread's 8 rows are contiguous
      float f[4];
      unpack(v, f);
#pragma unroll
      for (int j = 0; j < 4; ++j) As[(c + j) * kLdAf + r] = f[j];
    }
  }
  constexpr int kChunksB = kMBN / W;
  for (int i = threadIdx.x; i < kMBK * kChunksB; i += kMThreads) {
    const int r = i / kChunksB, c = (i % kChunksB) * W, k = k0 + r;
    const uint4 v = k < K ? load_chunk(w + (long)k * N, n0 + c, N, vec_w)
                          : make_uint4(0u, 0u, 0u, 0u);
    *reinterpret_cast<uint4*>(Bs + r * ldb + c) = v;
  }
}

// The [kMBM, kMBN] product of one tile, left in shared memory as float
// Cs[r * kLdC + c]. bf16: tensor cores; warp (wm, wn) of 4 x 2 takes rows
// [32 wm, 32 wm + 32) and columns [32 wn, 32 wn + 32).
__device__ __forceinline__ void tile_product(unsigned char* smem, const __nv_bfloat16* x,
                                             const __nv_bfloat16* w, int M, int K, int N,
                                             int m0, int n0, bool vec_x, bool vec_w) {
  using namespace nvcuda;
  const __nv_bfloat16* As = reinterpret_cast<const __nv_bfloat16*>(smem);
  const __nv_bfloat16* Bs = As + kMBM * kLdAh;
  const int warp = threadIdx.x / 32, wm = warp / 2, wn = warp % 2;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  for (int k0 = 0; k0 < K; k0 += kMBK) {
    __syncthreads();  // earlier readers of the tiles are done
    stage(smem, x, w, M, K, N, m0, n0, k0, vec_x, vec_w);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kMBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wm * 32 + i * 16) * kLdAh + kk, kLdAh);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bs + kk * kLdBh + wn * 32 + j * 16, kLdBh);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
  }
  __syncthreads();  // the accumulator tile overwrites the operand tiles
  float* Cs = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * kLdC + wn * 32 + j * 16, acc[i][j],
                              kLdC, wmma::mem_row_major);
  __syncthreads();
}

// float32: FMA, thread (tr, tc) of 16 x 16 takes rows [8 tr, 8 tr + 8) and
// columns [4 tc, 4 tc + 4), k in order.
__device__ __forceinline__ void tile_product(unsigned char* smem, const float* x,
                                             const float* w, int M, int K, int N, int m0,
                                             int n0, bool vec_x, bool vec_w) {
  const float* As = reinterpret_cast<const float*>(smem);
  const float* Bs = As + kMBK * kLdAf;
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  float acc[8][4] = {};
  for (int k0 = 0; k0 < K; k0 += kMBK) {
    __syncthreads();
    stage(smem, x, w, M, K, N, m0, n0, k0, vec_x, vec_w);
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kMBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(As + kk * kLdAf + tr * 8);
      const float4 a1 = *reinterpret_cast<const float4*>(As + kk * kLdAf + tr * 8 + 4);
      const float4 bv = *reinterpret_cast<const float4*>(Bs + kk * kLdBf + tc * 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  __syncthreads();
  float* Cs = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    *reinterpret_cast<float4*>(Cs + (tr * 8 + i) * kLdC + tc * 4) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kMThreads)
    matmul_stats_tiles(const T* __restrict__ x,  // [M, K]
                       const T* __restrict__ w,  // [K, N]
                       T* __restrict__ y,        // [M, N]
                       float* __restrict__ part_s,  // [gx, N]
                       float* __restrict__ part_q,  // [gx, N]
                       int M, int K, int N) {
  __shared__ __align__(128) unsigned char smem[kMSmem];
  __shared__ float red[2][kMThreads];
  constexpr int W = Vec<T>::W;
  const bool vec_x = K % W == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vec_w = N % W == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const int n0 = blockIdx.y * kMBN;
  const int c = threadIdx.x % kMBN, rg = threadIdx.x / kMBN, n = n0 + c;
  const float* Cs = reinterpret_cast<const float*>(smem);
  float s = 0.f, q = 0.f;
  const int ntm = (M + kMBM - 1) / kMBM;
  for (int tm = blockIdx.x; tm < ntm; tm += gridDim.x) {
    const int m0 = tm * kMBM;
    tile_product(smem, x, w, M, K, N, m0, n0, vec_x, vec_w);
    // a warp stores 32 neighbouring columns of one row
    if (n < N) {
      for (int r = rg; r < kMBM && m0 + r < M; r += kMThreads / kMBN) {
        const float v = round_to(Cs[r * kLdC + c], y);
        store(y + (long)(m0 + r) * N + n, v);
        s += v;
        q = fmaf(v, v, q);
      }
    }
  }
  red[0][threadIdx.x] = s;
  red[1][threadIdx.x] = q;
  __syncthreads();
  if (rg == 0 && n < N) {
#pragma unroll
    for (int g = 1; g < kMThreads / kMBN; ++g) {
      s += red[0][g * kMBN + c];
      q += red[1][g * kMBN + c];
    }
    part_s[(long)blockIdx.x * N + n] = s;
    part_q[(long)blockIdx.x * N + n] = q;
  }
}

constexpr int kReduceGroups = 8;

// sum[n] and sumsq[n] from the rows partial rows: thread (c, g) adds rows
// g, g + 8, ... of column 32 blockIdx.x + c, then group 0 adds the 8 group
// sums in order.
__global__ void __launch_bounds__(32 * kReduceGroups)
    stats_reduce(const float* __restrict__ part_s, const float* __restrict__ part_q, int rows,
                 int N, float* __restrict__ sum, float* __restrict__ sumsq) {
  __shared__ float sh[2][kReduceGroups][32];
  const int c = threadIdx.x % 32, g = threadIdx.x / 32, n = blockIdx.x * 32 + c;
  float s = 0.f, q = 0.f;
  if (n < N) {
    for (int r = g; r < rows; r += kReduceGroups) {
      s += part_s[(long)r * N + n];
      q += part_q[(long)r * N + n];
    }
  }
  sh[0][g][c] = s;
  sh[1][g][c] = q;
  __syncthreads();
  if (g == 0 && n < N) {
    for (int j = 1; j < kReduceGroups; ++j) {
      s += sh[0][j][c];
      q += sh[1][j][c];
    }
    sum[n] = s;
    sumsq[n] = q;
  }
}

// Blocks of one full wave of matmul_stats_tiles<T> on the current device.
template <typename T>
static int wave_blocks() {
  static int cached[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cached[dev] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, matmul_stats_tiles<T>,
                                                      kMThreads, 0) != cudaSuccess)
      return 0;
    cached[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  return cached[dev];
}

// gx: the row-tile blocks of the grid, and so the partial rows; 0 on error.
static int grid_rows(int dtype, int M, int N) {
  if (M < 1 || N < 1) return 0;
  const int wave = dtype == kBF16 ? wave_blocks<__nv_bfloat16>()
                 : dtype == kF32  ? wave_blocks<float>()
                                  : 0;
  if (wave == 0) return 0;
  const int ntm = (M + kMBM - 1) / kMBM, ntn = (N + kMBN - 1) / kMBN;
  const int gx = wave / ntn;
  return gx < 1 ? 1 : (gx < ntm ? gx : ntm);
}

}  // namespace capk

extern "C" {

// Rows of the partial-sum buffers capk_matmul_stats needs for these shapes
// on the current device (0 for operands it does not take, or on error).
int capk_matmul_stats_partial_rows(int dtype, int M, int N) {
  return capk::grid_rows(dtype, M, N);
}

// y[M, N] = x[M, K] @ w[K, N] as dtype (float32 or bf16, both contiguous
// row-major), and sum[N], sumsq[N] of the stored y in float32. part_s and
// part_q hold rows x N floats, rows = capk_matmul_stats_partial_rows(dtype,
// M, N). Returns cudaGetLastError() (cudaErrorInvalidValue for operands the
// kernel does not take).
int capk_matmul_stats(int dtype, int M, int K, int N, const void* x, const void* w, void* y,
                      float* part_s, float* part_q, int rows, float* sum, float* sumsq,
                      cudaStream_t stream) {
  if (K < 1 || rows < 1 || rows != capk::grid_rows(dtype, M, N))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(rows, (N + capk::kMBN - 1) / capk::kMBN);
  if (dtype == capk::kBF16) {
    capk::matmul_stats_tiles<__nv_bfloat16><<<grid, capk::kMThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(y), part_s, part_q, M, K, N);
  } else {
    capk::matmul_stats_tiles<float><<<grid, capk::kMThreads, 0, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), static_cast<float*>(y),
        part_s, part_q, M, K, N);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  capk::stats_reduce<<<(N + 31) / 32, 32 * capk::kReduceGroups, 0, stream>>>(
      part_s, part_q, rows, N, sum, sumsq);
  return (int)cudaGetLastError();
}

}  // extern "C"
