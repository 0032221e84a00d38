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
// two-pass reduction.
//
// What bounds it on an H100: bytes. The 1x1 convs of MobileNetV2 have
// K, N <= 1280, under the card's ~295 bf16 operations per byte, so the least
// time is reading x and w once and writing y once; writing y dominates (at
// conv3_1_expand, K = 16 and N = 96, y is 6x the bytes of x). So the design
// is a stream: every byte of x read once, every byte of y written once in
// 16-byte stores, the loads of the next tiles in flight while a tile is
// multiplied and stored, and nothing else touching device memory.
//
//   1. matmul_stats_tiles: grid (gx, nct), 256 threads. Column tile by
//      covers BN columns of N, BN the smallest of a few widths (bf16: 32 ..
//      256; float32: 32 .. 128) that takes N in nct = ceil(N / max BN)
//      tiles, so N = 96 and 144 are one tile and x is read once. Block
//      (bx, by) is persistent: about one wave of blocks, each walking the
//      128-row tiles bx, bx + gx, ... . K goes in chunks of KC = 16 (K <= 16:
//      the product's depth, not 32), 32, or 64 for the deep bf16 convs
//      (K > 32, N <= 192: fewer, larger chunks in flight). A ring of 4
//      shared-memory stages (3 where that lets two blocks share an SM, or
//      where 4 do not fit) receives (x chunk [128][KC], w chunk [KC][BN]) by
//      cp.async, the stages ahead of the one being multiplied in flight;
//      when K is one chunk, w is loaded once into each stage and stays (the
//      column tile of a block never changes).
//      bf16: tensor cores, mma.sync m16n8k16 with float32 accumulators in
//      registers; warp w takes rows [16 w, 16 w + 16) and all BN columns;
//      A fragments by ldmatrix, B by ldmatrix.trans from the [k][n] tile.
//      float32: FMA in k order (no TF32, which would lose float32's 1e-4
//      limit; the float32 kernel is byte-bound all the same), thread
//      (rows 16 w + l % 4 + 4 i, columns 4 (l / 4) + 32 j).
//      Epilogue: the accumulators, rounded to T, go to a staging tile in
//      shared memory; then thread t copies 16-byte chunk t % (BN / W) of
//      rows t / (BN / W), + G, ... to y (one 16-byte streaming store each, a
//      warp's stores contiguous) and adds the same rounded values and squares
//      to its own column partials: in float over the tile's rows (at most
//      16), then into running sums (double for float32 y, float for bf16:
//      RunSum). At the end the block adds its threads' sums in row-group
//      order and writes one row of partials, part_s[bx, :] and part_q[bx, :].
//   2. stats_reduce: per column, the gx partial rows in a fixed order, in
//      double. So float32 statistics are within about one float32 rounding
//      of exact sums of the stored y.
//
// No atomics: every sum runs in an order fixed by the shapes and the card,
// so the statistics do not change from run to run.
//
// Any M, K, N >= 1: rows, depths and columns past the edge load as zero
// (cp.async zero-fill) and store nothing. Loads and stores are 16 bytes wide
// where a row's length in bytes and the base address allow (K, N multiples of
// 8 in bf16, of 4 in float32: every conv of MobileNetV2 x1.0), else one
// element at a time (synchronous loads into the same stages).
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace capk {
namespace mbn {

constexpr int kBM = 128;  // rows of a tile
constexpr int kThreads = 256;

template <typename T>
struct Cfg;
template <>
struct Cfg<__nv_bfloat16> {
  static constexpr int kMaxBN = 256;
};
template <>
struct Cfg<float> {
  static constexpr int kMaxBN = 128;
};

// Elements of T in a 16-byte vector; every shared row is padded by one
// vector (the staging tile by 8 elements), so that ldmatrix, the float reads
// and the staging stores avoid bank conflicts.
template <typename T>
constexpr int W16 = Vec<T>::W;

// Shared memory of a block when two blocks share an SM (228 KB, less 1 KB
// reserved for each).
constexpr size_t kTwoPerSm = 113 * 1024;

// A launch shape: T, the column tile BN and the deepest K chunk KC (16, 32
// or 64: with_shape). The ring has 4 stages, or 3 where 3 let two blocks
// share an SM and 4 do not, or where 4 do not fit.
template <typename T, int BN_, int KC_>
struct Shape {
  static constexpr int BN = BN_, KC = KC_, W = W16<T>;
  static constexpr int LDX = KC + W;  // x chunk [kBM][LDX]
  static constexpr int LDW = BN + W;  // w chunk [KC][LDW]
  static constexpr int LDY = BN + 8;  // staging tile [kBM][LDY]
  static constexpr int STAGE = kBM * LDX + KC * LDW;
  static constexpr size_t B3 = (3 * (size_t)STAGE + (size_t)kBM * LDY) * sizeof(T);
  static constexpr size_t B4 = (4 * (size_t)STAGE + (size_t)kBM * LDY) * sizeof(T);
  static constexpr int STAGES =
      B4 <= kTwoPerSm ? 4 : B3 <= kTwoPerSm ? 3 : B4 <= kMaxDynamicSmem ? 4 : 3;
  static constexpr size_t SMEM = STAGES == 4 ? B4 : B3;
  // blocks an SM should hold (a register budget per thread): two up to 160
  // columns (three capped the registers at 85 and spilled)
  static constexpr int MIN_BLOCKS = BN <= 160 ? 2 : 1;
};

template <typename T>
using Raw = typename std::conditional<sizeof(T) == 2, uint16_t, uint32_t>::type;

// Stage chunk [k0, k0 + kc) of x rows [m0, m0 + kBM) and, if with_w, the same
// rows of w for columns [n0, n0 + BN).
template <class Sh, typename T>
__device__ __forceinline__ void load_stage(T* xs, T* ws, const T* __restrict__ x,
                                           const T* __restrict__ w, int M, int K, int N,
                                           int m0, int k0, int kc, int n0, bool vec_x,
                                           bool vec_w, bool with_w) {
  constexpr int W = W16<T>;
  const Raw<T>* xr = reinterpret_cast<const Raw<T>*>(x);
  const Raw<T>* wr = reinterpret_cast<const Raw<T>*>(w);
  const int cx = kc / W;  // 16-byte chunks of an x row
  for (int i = threadIdx.x; i < kBM * cx; i += kThreads) {
    const int r = i / cx, c = (i % cx) * W, row = m0 + r, k = k0 + c;
    T* dst = xs + r * Sh::LDX + c;
    if (vec_x) {  // K % W == 0: a chunk is wholly inside or wholly outside
      const bool in = row < M && k < K;
      cp_async16(dst, in ? x + (long)row * K + k : x, in ? 16 : 0);
    } else {
      Raw<T>* d = reinterpret_cast<Raw<T>*>(dst);
#pragma unroll
      for (int j = 0; j < W; ++j) d[j] = row < M && k + j < K ? xr[(long)row * K + k + j] : 0;
    }
  }
  if (!with_w) return;
  const int cw = Sh::BN / W;
  for (int i = threadIdx.x; i < kc * cw; i += kThreads) {
    const int r = i / cw, c = (i % cw) * W, k = k0 + r, n = n0 + c;
    T* dst = ws + r * Sh::LDW + c;
    if (vec_w) {
      const bool in = k < K && n < N;
      cp_async16(dst, in ? w + (long)k * N + n : w, in ? 16 : 0);
    } else {
      Raw<T>* d = reinterpret_cast<Raw<T>*>(dst);
#pragma unroll
      for (int j = 0; j < W; ++j) d[j] = k < K && n + j < N ? wr[(long)k * N + n + j] : 0;
    }
  }
}

// ---- the products of one staged chunk, into the accumulators ----

// bf16, NJ = BN / 8 fragments of 8 columns: acc[j] is the C fragment of
// rows [16 warp, +16) x columns [8 j, 8 j + 8).
template <int NJ>
struct AccBF16 {
  float v[NJ][4];
};
template <class Sh, int NJ>
__device__ __forceinline__ void chunk_product(const __nv_bfloat16* xs, const __nv_bfloat16* ws,
                                              int kc, int /*kn*/, AccBF16<NJ>& acc) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const __nv_bfloat16* a_base = xs + (warp * 16 + (lane & 15)) * Sh::LDX + (lane >> 4) * 8;
  const __nv_bfloat16* b_base = ws + (lane & 15) * Sh::LDW + (lane >> 4) * 8;
  for (int kk = 0; kk < kc; kk += 16) {
    uint32_t a[4];
    ldmatrix_x4(a, a_base + kk);
#pragma unroll
    for (int j = 0; j < NJ; j += 2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, b_base + kk * Sh::LDW + j * 8);
      mma_bf16(acc.v[j], a, b[0], b[1]);
      mma_bf16(acc.v[j + 1], a, b[2], b[3]);
    }
  }
}

// float32, NB = BN / 32: thread (q = lane % 4, p = lane / 4) of warp w holds
// rows 16 w + q + 4 i (i < 4) x columns 4 p + 32 j + e (j < NB, e < 4).
template <int NB>
struct AccF32 {
  float v[4][NB][4];
};
template <class Sh, int NB>
__device__ __forceinline__ void chunk_product(const float* xs, const float* ws, int /*kc*/,
                                              int kn, AccF32<NB>& acc) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const float* a_base = xs + (warp * 16 + (lane & 3)) * Sh::LDX;
  const float* b_base = ws + 4 * (lane >> 2);
  for (int k = 0; k < kn; ++k) {  // only the chunk's real depth, in order
    float a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = a_base[4 * i * Sh::LDX + k];
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const float4 b = *reinterpret_cast<const float4*>(b_base + k * Sh::LDW + 32 * j);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc.v[i][j][0] = fmaf(a[i], b.x, acc.v[i][j][0]);
        acc.v[i][j][1] = fmaf(a[i], b.y, acc.v[i][j][1]);
        acc.v[i][j][2] = fmaf(a[i], b.z, acc.v[i][j][2]);
        acc.v[i][j][3] = fmaf(a[i], b.w, acc.v[i][j][3]);
      }
    }
  }
}

template <int NJ>
__device__ __forceinline__ void zero(AccBF16<NJ>& acc) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc.v[j][e] = 0.f;
}
template <int NB>
__device__ __forceinline__ void zero(AccF32<NB>& acc) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc.v[i][j][e] = 0.f;
}

// The accumulators, rounded to T, into the staging tile ys[kBM][ld_y].
template <class Sh, int NJ>
__device__ __forceinline__ void stage_out(const AccBF16<NJ>& acc, __nv_bfloat16* ys) {
  constexpr int LD = Sh::LDY;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  uint32_t* lo = reinterpret_cast<uint32_t*>(ys + (warp * 16 + lane / 4) * LD + 2 * (lane & 3));
  uint32_t* hi = lo + 8 * LD / 2;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    lo[4 * j] = pack_bf16x2(acc.v[j][0], acc.v[j][1]);
    hi[4 * j] = pack_bf16x2(acc.v[j][2], acc.v[j][3]);
  }
}
template <class Sh, int NB>
__device__ __forceinline__ void stage_out(const AccF32<NB>& acc, float* ys) {
  constexpr int LD = Sh::LDY;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  float* base = ys + (warp * 16 + (lane & 3)) * LD + 4 * (lane >> 2);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NB; ++j)
      *reinterpret_cast<float4*>(base + 4 * i * LD + 32 * j) =
          make_float4(acc.v[i][j][0], acc.v[i][j][1], acc.v[i][j][2], acc.v[i][j][3]);
}

// The running column sums: double for float32 y, whose statistics a float32
// train step is held to at the loss's last bit (float running sums over
// ~100 tiles moved its loss by one ulp); float for bf16 y (its sums read
// within 2e-7 of exact, against a 1e-5 limit), which keeps the wide tiles'
// registers under the two-blocks-an-SM budget.
template <typename T>
using RunSum = typename std::conditional<sizeof(T) == 4, double, float>::type;

// a 16-byte store that streams past the caches (y is not read again soon)
__device__ __forceinline__ void store_stream(void* p, const uint4& v) {
  asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"l"(p), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}

template <typename T, class Acc, class Sh>
__global__ void __launch_bounds__(kThreads, Sh::MIN_BLOCKS)
    matmul_stats_tiles(const T* __restrict__ x,      // [M, K]
                       const T* __restrict__ w,      // [K, N]
                       T* __restrict__ y,            // [M, N]
                       float* __restrict__ part_s,   // [gx, N]
                       float* __restrict__ part_q,   // [gx, N]
                       int M, int K, int N, int kc) {
  constexpr int W = W16<T>, BN = Sh::BN, S = Sh::STAGES;
  constexpr int CPR = BN / W;        // 16-byte chunks of a staged row
  constexpr int G = kThreads / CPR;  // row groups of the copy-out
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  T* ys = smem + S * Sh::STAGE;
  const bool vec_x = K % W == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vec_w = N % W == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const bool vec_y = N % W == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const int n0 = blockIdx.y * BN;
  const int ntm = (M + kBM - 1) / kBM, nk = (K + kc - 1) / kc;
  const int mine = (ntm - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int total = mine * nk;  // (tile, chunk) pairs of this block, in order

  auto fetch = [&](int L) {
    if (L < total) {
      T* xs = smem + (L % S) * Sh::STAGE;
      const int tm = blockIdx.x + (L / nk) * gridDim.x;
      load_stage<Sh>(xs, xs + kBM * Sh::LDX, x, w, M, K, N, tm * kBM, (L % nk) * kc, kc, n0,
                     vec_x, vec_w, nk > 1 || L < S);
    }
    cp_async_commit();  // an empty group past the end keeps the count uniform
  };

  const int cc = threadIdx.x % CPR, rg = threadIdx.x / CPR;
  RunSum<T> s[W], q[W];  // running sums over the tiles
#pragma unroll
  for (int j = 0; j < W; ++j) s[j] = q[j] = 0;
  Acc acc;
#pragma unroll
  for (int L = 0; L < S - 1; ++L) fetch(L);
  for (int L = 0; L < total; ++L) {
    cp_async_wait<S - 2>();  // chunk L has landed
    __syncthreads();         // ... for every thread; chunk L - 1's stage is free
    fetch(L + S - 1);
    const int kci = L % nk;
    if (kci == 0) zero(acc);
    const T* xs = smem + (L % S) * Sh::STAGE;
    chunk_product<Sh>(xs, xs + kBM * Sh::LDX, kc, min(kc, K - kci * kc), acc);
    if (kci != nk - 1) continue;
    // epilogue: stage the rounded tile, then store it and take its sums
    stage_out<Sh>(acc, ys);
    __syncthreads();
    const int m0 = (blockIdx.x + (L / nk) * gridDim.x) * kBM;
    if (rg < G) {
      float ts[W], tq[W];
#pragma unroll
      for (int j = 0; j < W; ++j) ts[j] = tq[j] = 0.f;
      const int n = n0 + cc * W;
      for (int r = rg; r < kBM && m0 + r < M; r += G) {
        const uint4 v = *reinterpret_cast<const uint4*>(ys + r * Sh::LDY + cc * W);
        float f[W];
        unpack(v, f);
#pragma unroll
        for (int j = 0; j < W; ++j) {
          ts[j] += f[j];
          tq[j] = fmaf(f[j], f[j], tq[j]);
        }
        T* dst = y + (long)(m0 + r) * N + n;
        if (vec_y && n + W <= N) {
          store_stream(dst, v);
        } else {
          const Raw<T>* e = reinterpret_cast<const Raw<T>*>(&v);
#pragma unroll
          for (int j = 0; j < W; ++j)
            if (n + j < N) reinterpret_cast<Raw<T>*>(dst)[j] = e[j];
        }
      }
#pragma unroll
      for (int j = 0; j < W; ++j) {
        s[j] += ts[j];
        q[j] += tq[j];
      }
    }
  }
  // the block's row of partials: its threads' sums in row-group order
  cp_async_wait<0>();
  __syncthreads();  // every stage and the staging tile are free
  RunSum<T>* red = reinterpret_cast<RunSum<T>*>(smem_raw);  // [2][G][BN]
  if (rg < G) {
#pragma unroll
    for (int j = 0; j < W; ++j) {
      red[rg * BN + cc * W + j] = s[j];
      red[(G + rg) * BN + cc * W + j] = q[j];
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < BN && n0 + c < N; c += kThreads) {
    RunSum<T> a = 0, b = 0;
    for (int g = 0; g < G; ++g) {
      a += red[g * BN + c];
      b += red[(G + g) * BN + c];
    }
    part_s[(long)blockIdx.x * N + n0 + c] = (float)a;
    part_q[(long)blockIdx.x * N + n0 + c] = (float)b;
  }
}

constexpr int kReduceGroups = 32;

// sum[n] and sumsq[n] from the rows partial rows: thread (c, g) adds rows
// g, g + 32, ... of column 32 blockIdx.x + c, then group 0 adds the 32
// group sums in order.
__global__ void __launch_bounds__(32 * kReduceGroups)
    stats_reduce(const float* __restrict__ part_s, const float* __restrict__ part_q, int rows,
                 int N, float* __restrict__ sum, float* __restrict__ sumsq) {
  __shared__ double sh[2][kReduceGroups][33];
  const int c = threadIdx.x % 32, g = threadIdx.x / 32, n = blockIdx.x * 32 + c;
  double s = 0.0, q = 0.0;
  if (n < N) {
#pragma unroll 4
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
    sum[n] = (float)s;
    sumsq[n] = (float)q;
  }
}

// ---- the launch plan: shape, tiles, blocks ----

template <typename T, int BN>
using AccT = typename std::conditional<sizeof(T) == 2, AccBF16<BN / 8>, AccF32<BN / 32>>::type;

// Blocks of one full wave of the instance on the current device (0 on error);
// also raises its shared-memory limit once.
template <class Sh, typename T>
static int wave_blocks() {
  static int cached[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cached[dev] == 0) {
    int sms = 0, per_sm = 0;
    auto* kernel = matmul_stats_tiles<T, AccT<T, Sh::BN>, Sh>;
    if (Sh::SMEM > kMaxDynamicSmem || !raise_smem_limit(kernel) ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, Sh::SMEM) !=
            cudaSuccess ||
        per_sm < 1)
      return 0;
    cached[dev] = sms * per_sm;
  }
  return cached[dev];
}

// Calls f(Shape<T, BN, KC>{}) for the smallest column tile width of T's list
// that is at least `need`, and KC = 16 for K <= 16 (no stage space for
// zeros), 64 for bf16 with K > 32 where BN <= 192 (the deep-K convs: fewer,
// larger chunks in flight), else 32.
template <typename T, class F>
static bool with_shape(int need, int K, F&& f) {
  auto go = [&](auto bn) {
    constexpr int BN = decltype(bn)::value;
    if (K <= 16) return f(Shape<T, BN, 16>{});
    if constexpr (sizeof(T) == 2 && BN <= 192) {
      if (K > 32) return f(Shape<T, BN, 64>{});
    }
    return f(Shape<T, BN, 32>{});
  };
  if constexpr (sizeof(T) == 2) {
    if (need <= 32) return go(std::integral_constant<int, 32>{});
    if (need <= 64) return go(std::integral_constant<int, 64>{});
    if (need <= 96) return go(std::integral_constant<int, 96>{});
    if (need <= 128) return go(std::integral_constant<int, 128>{});
    if (need <= 160) return go(std::integral_constant<int, 160>{});
    if (need <= 192) return go(std::integral_constant<int, 192>{});
    return go(std::integral_constant<int, 256>{});
  } else {
    if (need <= 32) return go(std::integral_constant<int, 32>{});
    if (need <= 64) return go(std::integral_constant<int, 64>{});
    if (need <= 96) return go(std::integral_constant<int, 96>{});
    return go(std::integral_constant<int, 128>{});
  }
}

struct Plan {
  int nct = 0, gx = 0;  // gx = 0: the operands are not taken
};

// The column tiles and the row-tile blocks of the grid (= the partial rows).
template <typename T>
static Plan plan_for(int M, int K, int N) {
  Plan p;
  if (M < 1 || K < 1 || N < 1) return p;
  const int nct = (N + Cfg<T>::kMaxBN - 1) / Cfg<T>::kMaxBN;
  with_shape<T>((N + nct - 1) / nct, K, [&](auto sh) {
    using Sh = decltype(sh);
    const int wave = wave_blocks<Sh, T>();
    if (wave == 0) return false;
    p.nct = (N + Sh::BN - 1) / Sh::BN;
    const int ntm = (M + kBM - 1) / kBM, gx = wave / p.nct;
    p.gx = gx < 1 ? 1 : (gx < ntm ? gx : ntm);
    return true;
  });
  return p;
}

static Plan plan(int dtype, int M, int K, int N) {
  return dtype == kBF16 ? plan_for<__nv_bfloat16>(M, K, N)
       : dtype == kF32  ? plan_for<float>(M, K, N)
                        : Plan{};
}

template <typename T>
static cudaError_t launch(const Plan& p, int M, int K, int N, const void* x, const void* w,
                          void* y, float* part_s, float* part_q, cudaStream_t stream) {
  const int nct = (N + Cfg<T>::kMaxBN - 1) / Cfg<T>::kMaxBN;
  const bool ok = with_shape<T>((N + nct - 1) / nct, K, [&](auto sh) {
    using Sh = decltype(sh);
    const int kc = K <= 16 ? 16 : K <= 32 ? 32 : Sh::KC;
    matmul_stats_tiles<T, AccT<T, Sh::BN>, Sh><<<dim3(p.gx, p.nct), kThreads, Sh::SMEM, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y), part_s, part_q,
        M, K, N, kc);
    return true;
  });
  return ok ? cudaGetLastError() : cudaErrorInvalidValue;
}

}  // namespace mbn
}  // namespace capk

extern "C" {

// Rows of a tile of kernel F (the rows one pass of a block stores together).
int capk_matmul_stats_row_tile() { return capk::mbn::kBM; }

// Rows of the partial-sum buffers capk_matmul_stats needs for these shapes
// on the current device (0 for operands it does not take, or on error).
int capk_matmul_stats_partial_rows(int dtype, int M, int K, int N) {
  return capk::mbn::plan(dtype, M, K, N).gx;
}

// y[M, N] = x[M, K] @ w[K, N] as dtype (float32 or bf16, both contiguous
// row-major), and sum[N], sumsq[N] of the stored y in float32. part_s and
// part_q hold rows x N floats, rows = capk_matmul_stats_partial_rows(dtype,
// M, K, N). Returns cudaGetLastError() (cudaErrorInvalidValue for operands
// the kernel does not take).
int capk_matmul_stats(int dtype, int M, int K, int N, const void* x, const void* w, void* y,
                      float* part_s, float* part_q, int rows, float* sum, float* sumsq,
                      cudaStream_t stream) {
  const capk::mbn::Plan p = capk::mbn::plan(dtype, M, K, N);
  if (p.gx < 1 || rows != p.gx) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      dtype == capk::kBF16
          ? capk::mbn::launch<__nv_bfloat16>(p, M, K, N, x, w, y, part_s, part_q, stream)
          : capk::mbn::launch<float>(p, M, K, N, x, w, y, part_s, part_q, stream);
  if (err != cudaSuccess) return (int)err;
  capk::mbn::stats_reduce<<<(N + 31) / 32, 32 * capk::mbn::kReduceGroups, 0, stream>>>(
      part_s, part_q, rows, N, sum, sumsq);
  return (int)cudaGetLastError();
}

}  // extern "C"
