// The weight-streaming bf16 product of the decode kernels: kernels D and E
// (fused_transformer.cu) and kernel B (fused_step.cu) run their products on
// it. Design in fused_transformer.cu's note (item 2): the weight is the
// 16-row side of mma.sync m16n8k16 and the batch rows its 8-wide side; a
// block owns NS 16-column strips of the output and a K range; weight slabs
// and activation rows arrive by cp.async through a ring, the weights issued
// before griddep_wait(); K is split across a thread-block cluster, each
// split's float32 partial sums stored into the shared memory of the block
// that finalizes their row, summed there in split order. No workspace, no
// atomic: a product is deterministic.
//
// Two families of instantiations share it, chosen at compile time:
//   D and E (BM = false, NS = 4): bf16 rows, gathered embedding rows or
//     LayerNorm rows; the epilogue rounds the float32 sum to bf16 and adds
//     the rounded bias (epilogue() below, the modes of EMode up to kEEmbed).
//   B (BM = true): A is [bf16 rows or gathered table rows, columns
//     [0, k_split) ; float32 rows, columns [k_split, K)], the float32 rows
//     staged as they are and rounded to bf16 as each fragment is formed; the
//     sums stay float32 (kEF32, kEF32Tanh: + the float32 bias, tanh), or the
//     LSTM cell runs on them (kELstm, NS = 5: a block's 80 columns are the
//     five gates of 16 hidden units, fused_step.py's pack_weights
//     interleaving). nprob problems of one shape may run side by side. A
//     product whose N is an odd multiple of 32 (the projection at E = 32;
//     D's and E's head too, a plain store of rows normalized beforehand)
//     takes NS = 2: 32-column blocks, the epilogue's lanes 0-15.
//
// Every definition here has internal linkage (static kernels and host
// functions, constexpr constants), so each translation unit that includes
// it has its own copy of what it instantiates.
#pragma once

#include <cooperative_groups.h>

#include <algorithm>

#include "common.cuh"
#include "mma.cuh"

namespace capk {

constexpr float kLnEps = 1e-6f;
using bf = __nv_bfloat16;
namespace cg = cooperative_groups;

template <typename T>
__device__ __forceinline__ float to_dt(float v);
template <>
__device__ __forceinline__ float to_dt<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float to_dt<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float gelu_tanh(float x) {
  return x * (0.5f * (1.f + tanhf(0.7978845608028654f * (x + 0.044715f * (x * x * x)))));
}

// ---- products ------------------------------------------------------------------

enum AMode : int { kARows = 0, kALayerNorm = 1, kAGather = 2 };
enum EMode : int {
  kEStore = 0, kEStoreF32 = 1, kEResidual = 2, kEQkv = 3, kEGelu = 4, kEEmbed = 5,
  // kernel B's: the float32 sum, not rounded
  kEF32 = 6, kEF32Tanh = 7, kELstm = 8
};

// out = epilogue(round(round(A @ w) + round(bias))), A = prologue(a).
struct TfDense {
  int a_mode;
  const void* a;      // kARows: T [M, K]; kALayerNorm: float [M, K]; kAGather: T table [V, K]
  const float* ln_g;  // kALayerNorm: [K]
  const float* ln_b;
  const int* word;  // kAGather: [M] table rows; `pad` gathers zeros
  int pad;
  const void* w;      // WT [K, N]: T, or int8 with w_scale
  const float* w_scale;  // int8 weights: [N] per output channel, else null
  const float* bias;  // [N]
  int e_mode;
  void* out;  // kEStore, kEGelu: T [M, N]; kEStoreF32: float [M, N];
              // kEResidual: float x [M, N] += y; kEEmbed: x = y + pos; kEQkv: q T [M, N / 3]
              // kernel B: float [M, N] (kELstm: h' [M, N / 5])
  void* kc;   // kEQkv: this layer's caches [M, n_steps, N / 3], position t written
  void* vc;
  int t, n_steps;
  const float* pos;  // kEEmbed: [N]
  const int* skip;
  // tf_stream only: x's statistics [N / 64][M] (written by kEResidual and
  // kEEmbed, read by kALayerNorm)
  float2* stats;
  // kernel B's products (BM): A's columns [0, k_split) come from `a` (rows or
  // gathered table rows, k_split wide), columns [k_split, K) from the float32
  // rows a2 [M, K - k_split]; nprob problems side by side along the grid's x
  // (problem z: a2, w, bias and out advanced by z of their own sizes)
  const float* a2;
  int k_split, nprob;
  const float* gxb;  // kELstm: [M, 5 H] the gates' other terms, gate q at q H + j
  const float* c_in;  // kELstm: c [M, H]
  float* c_out;       // kELstm: c' [M, H]
  float* s_out;       // kELstm: sentinel [M, H]
};

// The epilogue of one output element from its float32 sum, the column's
// bias, int8 scale (ignored for float weights) and position (kEEmbed):
// the scale applied in T before the bias -> the value written (x's new
// value for kEResidual and kEEmbed).
template <typename T>
__device__ __forceinline__ float epilogue(const TfDense& p, float sum, int row, int col, int N,
                                          float bias, float scale, float pos, float x_old) {
  float y = to_dt<T>(sum);
  if (p.w_scale != nullptr) y = to_dt<T>(y * to_dt<T>(scale));
  y = to_dt<T>(y + to_dt<T>(bias));
  const long o = (long)row * N + col;
  switch (p.e_mode) {
    case kEStore:
      st(static_cast<T*>(p.out) + o, y);
      return y;
    case kEStoreF32:
      static_cast<float*>(p.out)[o] = y;
      return y;
    case kEResidual: {  // x_old: x[row, col] as the kernel found it
      const float v = x_old + y;
      static_cast<float*>(p.out)[o] = v;
      return v;
    }
    case kEGelu:
      st(static_cast<T*>(p.out) + o, gelu_tanh(y));
      return y;
    case kEEmbed: {
      const float v = y + pos;
      static_cast<float*>(p.out)[o] = v;
      return v;
    }
    default: {  // kEQkv
      const int D = N / 3, which = col / D, c = col % D;
      T* dst = which == 0 ? static_cast<T*>(p.out) + (long)row * D + c
                          : static_cast<T*>(which == 1 ? p.kc : p.vc) +
                                ((long)row * p.n_steps + p.t) * D + c;
      st(dst, y);
      return y;
    }
  }
}

// ---- bf16 and int8 weight streams: the weight-streaming product ----

namespace wsp {

constexpr int kNT = 64;        // output columns of a block at NS = 4 (kernels D and E)
constexpr int kKC = 32;        // k rows of a ring stage
constexpr int kLdA = kKC + 8;  // bf16 activation row: 80 B
constexpr int kLdX = kKC + 4;  // float32 activation row (LayerNorm input, kernel B): 144 B
constexpr int kMinBlocks = 128;
constexpr int kMaxSplits = 8;  // a cluster's blocks (the portable cluster size)

// A block of NS 16-column strips: 2 warps a strip (row halves or k halves).
template <int NS>
struct Cols {
  static constexpr int NT = 16 * NS;      // output columns of a block
  static constexpr int THREADS = 64 * NS;
  static constexpr int LDW = NT + 8;      // bf16 weight slab row: ldmatrix rows on distinct banks
  static constexpr int LDW8 = NT + 16;    // int8 weight slab row: byte loads on distinct banks
  static constexpr int LDC = NT + 4;      // float32 row of the block's output tile
};

// MT row tiles of 8 per warp; KG = 2: the warp pairs split each stage's two
// 16-deep steps (8 rows), KG = 1: they split the rows.
template <int MT, int KG>
struct Shape {
  static constexpr int RB = 8 * MT * (2 / KG);  // rows of a block
  static constexpr int STAGES = RB <= 16 ? 16 : RB <= 32 ? 6 : 4;
};
// Rows up to which a product normalizes its LayerNorm rows itself, as its
// fragments are formed; beyond, tf_layernorm writes them once in bf16.
constexpr int kLnRows = 16;

// A ring stage: the weight slab [kKC][NT] (bf16, or int8 copied raw), then
// the stage's LayerNorm gain and offset [2][kKC]; the activation rows
// [RB][kKC], float32 under a LayerNorm and in kernel B's products, else bf16
// (room for the larger).
template <typename WT, int NS>
__host__ __device__ constexpr int w_slab_bytes() {
  return std::is_same<WT, int8_t>::value ? kKC * Cols<NS>::LDW8 : kKC * Cols<NS>::LDW * 2;
}
template <typename WT, int NS>
__host__ __device__ constexpr int w_stage_bytes() {
  return w_slab_bytes<WT, NS>() + 2 * kKC * 4;
}
__host__ __device__ constexpr int a_stage_bytes(int RB, bool f32) {
  return f32 ? RB * kLdX * 4 : RB * kLdA * 2;
}

// Stages of the ring: STAGES; kernel B's products hold only the stages a
// block's K range needs, when it fits (a smaller footprint: more blocks an
// SM, and the next kernel's beside them).
template <int MT, int KG, bool BM>
__host__ __device__ constexpr int ring_stages(int nst, int splits) {
  return BM && (nst + splits - 1) / splits < Shape<MT, KG>::STAGES ? (nst + splits - 1) / splits
                                                                   : Shape<MT, KG>::STAGES;
}
template <typename WT, int MT, int KG, int NS, bool BM>
__host__ __device__ constexpr size_t ring_bytes(int stages) {
  // a LayerNorm product's rows are float32 (<= kLnRows rows), kernel B's
  // may be at any count, else bf16
  return (size_t)stages * (w_stage_bytes<WT, NS>() +
                           a_stage_bytes(Shape<MT, KG>::RB, BM || Shape<MT, KG>::RB <= kLnRows));
}
// The ring, then the partial sums a block receives: a slot per (split, warp
// group) of the rows it finalizes, [splits KG][ceil(RB / splits)][LDC].
template <typename WT, int MT, int KG, int NS, bool BM>
__host__ __device__ constexpr size_t smem_bytes(int nst, int splits) {
  using S = Shape<MT, KG>;
  return ring_bytes<WT, MT, KG, NS, BM>(ring_stages<MT, KG, BM>(nst, splits)) +
         (size_t)splits * KG * ((S::RB + splits - 1) / splits) * Cols<NS>::LDC * 4;
}

// Rows of a block, blocks and K splits (a cluster's blocks) of one product
// of N output columns (all problems side by side), NT a block.
struct Plan {
  int rb, chunks, tiles, splits;
};
static Plan plan(int M, int N, int K, int NT = kNT) {
  Plan s;
  s.rb = M <= 8 ? 8 : M <= 16 ? 16 : M <= 32 ? 32 : M <= 64 ? 64 : 128;
  s.chunks = (M + s.rb - 1) / s.rb;
  s.tiles = N / NT;
  const int nst = K / kKC;
  s.splits = 1;
  while (s.splits * 2 <= nst && s.splits < kMaxSplits &&
         s.tiles * s.chunks * s.splits < kMinBlocks)
    s.splits *= 2;
  return s;
}

// Mean and sum of squared deviations of x's row over one 64-column tile, from
// a warp whose lane holds columns 2 lane and 2 lane + 1; lane 0 writes them.
__device__ __forceinline__ void tile_row_stats(float x0, float x1, float2* dst, int lane) {
  const float mean = warp_sum(x0 + x1) / kNT;
  const float d0 = x0 - mean, d1 = x1 - mean;
  const float m2 = warp_sum(d0 * d0 + d1 * d1);
  if (lane == 0) *dst = make_float2(mean, m2);
}

// Two int8 weights (rows k and k + 1 of column n of a raw slab, rows ld
// bytes apart) as a bf16 pair: exact.
__device__ __forceinline__ uint32_t i8_pair(const int8_t* slab, int ld, int k, int n) {
  return pack_bf16x2((float)slab[k * ld + n], (float)slab[(k + 1) * ld + n]);
}

template <typename WT, int MT, int KG, int NS, bool BM>
static __global__ void __launch_bounds__(Cols<NS>::THREADS, NS == 4 ? 2 : 1)
    tf_stream(TfDense p, int M, int N, int K) {
  using Sh = Shape<MT, KG>;
  using C = Cols<NS>;
  constexpr int RB = Sh::RB, ST = Sh::STAGES, NT = C::NT, THREADS = C::THREADS;
  constexpr bool kI8 = std::is_same<WT, int8_t>::value;
  constexpr int WSB = w_stage_bytes<WT, NS>();
  constexpr int ASB = a_stage_bytes(RB, BM || RB <= kLnRows);
  const int nst = K / kKC;
  const int RS = ring_stages<MT, KG, BM>(nst, gridDim.y);  // the ring's stages
  extern __shared__ __align__(128) unsigned char ws_smem[];
  unsigned char* wring = ws_smem;
  unsigned char* aring = ws_smem + RS * WSB;
  float* Rb = reinterpret_cast<float*>(ws_smem + ring_bytes<WT, MT, KG, NS, BM>(RS));  // partials received
  __shared__ float mu[RB], rstd[RB];
  __shared__ int gword[RB];
  cg::cluster_group cluster = cg::this_cluster();

  int tile = blockIdx.x;
  const int chunk = blockIdx.z;
  const WT* W = static_cast<const WT*>(p.w);
  const float* bias = p.bias;
  const float* a2 = p.a2;
  float* outf = static_cast<float*>(p.out);
  if constexpr (BM) {  // problem z of nprob side by side
    const int tiles = gridDim.x / p.nprob, z = blockIdx.x / tiles;
    tile = blockIdx.x % tiles;
    W += (long)z * K * N;
    bias += (long)z * N;
    a2 += (long)z * M * (K - p.k_split);
    outf += (long)z * M * N;
  }
  const int splits = gridDim.y, split = (int)cluster.block_rank();  // the cluster spans y
  const int n0 = tile * NT, m0 = chunk * RB;
  const int s_beg = (int)((long)split * nst / splits);
  const int n = (int)((long)(split + 1) * nst / splits) - s_beg;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid & 31;
  const bool ln = !BM && RB <= kLnRows && p.a_mode == kALayerNorm;

  if (flag_set(p.skip)) return;
  auto load_w = [&](int j) {  // the block's stage j into slot j % ST
    unsigned char* dst = wring + (j % ST) * WSB;
    const int k0 = (s_beg + j) * kKC;
    constexpr int CPR = NT * (int)sizeof(WT) / 16;  // 16-byte chunks of a slab row
    for (int i = tid; i < kKC * CPR; i += THREADS) {
      const int r = i / CPR, c = i % CPR;
      cp_async16(dst + r * (kI8 ? C::LDW8 : C::LDW * 2) + c * 16,
                 W + (long)(k0 + r) * N + n0 + c * (16 / (int)sizeof(WT)), 16);
    }
    if (ln && tid < 2 * kKC / 4) {  // the gain and offset of the stage's k
      const float* src = (tid < kKC / 4 ? p.ln_g : p.ln_b) + k0 + (tid % (kKC / 4)) * 4;
      cp_async16(dst + w_slab_bytes<WT, NS>() + tid * 16, src, 16);
    }
  };
  // the weights first: they do not depend on the kernel before this one
  for (int j = 0; j < ST; ++j) {
    if (j < n) load_w(j);
    cp_async_commit();
  }
  // the epilogue's operands of this lane's two columns (weights too)
  const int c0 = 2 * lane;
  float2 bias2 = make_float2(0.f, 0.f), scale2 = make_float2(1.f, 1.f),
         pos2 = make_float2(0.f, 0.f);
  if (NS != 5 && c0 < NT) bias2 = __ldg(reinterpret_cast<const float2*>(bias + n0 + c0));
  if (!BM && p.w_scale != nullptr && c0 < NT)
    scale2 = __ldg(reinterpret_cast<const float2*>(p.w_scale + n0 + c0));
  if (!BM && p.e_mode == kEEmbed) pos2 = __ldg(reinterpret_cast<const float2*>(p.pos + n0 + c0));
  griddep_wait();
  if (flag_set(p.skip)) {
    cp_async_wait<0>();
    return;
  }

  if (p.a_mode == kAGather) {
    for (int r = tid; r < RB; r += THREADS)
      gword[r] = m0 + r < M ? __ldcg(p.word + m0 + r) : p.pad;
    __syncthreads();
  }
  // LayerNorm: a warp per row, lane t holding x's tile t (mean, squared
  // deviations), loaded before the rows (which queue behind them)
  constexpr int kRowsPerWarp = RB <= kLnRows ? RB / 8 : 1;
  const int nt = K / kNT;
  float2 st[kRowsPerWarp];
  if (ln) {
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int row = m0 + warp + 8 * i;
      st[i] = lane < nt && row < M ? __ldcg(p.stats + (long)lane * M + row)
                                   : make_float2(0.f, 0.f);
    }
  }
  // float32 rows (a LayerNorm's x; kernel B's columns from k_split on)?
  auto f32_stage = [&](int j) { return BM ? (s_beg + j) * kKC >= p.k_split : ln; };
  auto load_a = [&](int j) {
    unsigned char* dst = aring + (j % ST) * ASB;
    const int k0 = (s_beg + j) * kKC;
    if (f32_stage(j)) {  // float32 rows: 8 chunks a row
      const float* x = BM ? a2 : static_cast<const float*>(p.a);
      const int kx = BM ? k0 - p.k_split : k0, ldx = BM ? K - p.k_split : K;
      for (int i = tid; i < RB * 8; i += THREADS) {
        const int r = i / 8, c = i % 8, row = m0 + r;
        const bool in = row < M;
        cp_async16(dst + (r * kLdX + c * 4) * 4, in ? x + (long)row * ldx + kx + c * 4 : x,
                   in ? 16 : 0);
      }
    } else {  // bf16 rows: the activation, or the word's table row (<pad>: zeros)
      const bf* a = static_cast<const bf*>(p.a);
      const int lda = BM ? p.k_split : K;
      for (int i = tid; i < RB * 4; i += THREADS) {
        const int r = i / 4, c = i % 4, row = m0 + r;
        long src = row < M ? row : -1;
        if (p.a_mode == kAGather) src = gword[r] == p.pad ? -1 : gword[r];
        cp_async16(dst + (r * kLdA + c * 8) * 2, src >= 0 ? a + src * lda + k0 + c * 8 : a,
                   src >= 0 ? 16 : 0);
      }
    }
  };
  for (int j = 0; j < ST && j < n; ++j) load_a(j);
  cp_async_commit();
  griddep_launch_dependents();
  if (ln) {
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {  // equal tiles: the mean of the means, then
      const float mean = warp_sum(st[i].x) / nt;  // M2 = sum M2_t + 64 (mean_t - mean)^2
      const float d = st[i].x - mean;
      const float m2 = warp_sum(lane < nt ? st[i].y + kNT * d * d : 0.f);
      if (lane == 0) {
        mu[warp + 8 * i] = mean;
        rstd[warp + 8 * i] = m0 + warp + 8 * i < M ? rsqrtf(m2 / K + kLnEps) : 0.f;
      }
    }
    __syncthreads();
  }

  const int strip = warp % NS, grp = warp / NS;
  const int r_base = KG == 1 ? grp * 8 * MT : 0;
  const int g = lane >> 2, c = lane & 3;
  float mu_t[MT], rs_t[MT];  // rows r_base + 8 t + g
#pragma unroll
  for (int t = 0; t < MT; ++t) {
    mu_t[t] = ln ? mu[r_base + 8 * t + g] : 0.f;
    rs_t[t] = ln ? rstd[r_base + 8 * t + g] : 0.f;
  }
  float acc[MT][4];
#pragma unroll
  for (int t = 0; t < MT; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
  // stage j's products: its weight slab's fragments (int8 widened, as
  // formed) against the block's rows (normalized as formed, under a
  // LayerNorm up to kLnRows rows; kernel B's float32 rows rounded as formed)
  auto stage = [&](int j) {
    const unsigned char* ws = wring + (j % ST) * WSB;
    const unsigned char* as = aring + (j % ST) * ASB;
    const bool f32 = f32_stage(j);
#pragma unroll
    for (int ks = 0; ks < kKC / 16; ++ks) {
      if (KG == 2 && ks != grp) continue;
      uint32_t a[4];  // the weight's 16 columns x 16 k of this warp's strip
      if constexpr (kI8) {  // widened to bf16 as the fragment is formed
        const int8_t* slab = reinterpret_cast<const int8_t*>(ws);
        const int k = ks * 16 + 2 * c, col = strip * 16 + g;
        a[0] = i8_pair(slab, C::LDW8, k, col);
        a[1] = i8_pair(slab, C::LDW8, k, col + 8);
        a[2] = i8_pair(slab, C::LDW8, k + 8, col);
        a[3] = i8_pair(slab, C::LDW8, k + 8, col + 8);
      } else {
        ldmatrix_x4_trans(a, reinterpret_cast<const bf*>(ws) +
                                 (ks * 16 + (lane & 7) + ((lane >> 4) << 3)) * C::LDW +
                                 strip * 16 + (((lane >> 3) & 1) << 3));
      }
      if (BM && f32) {  // kernel B: the float32 rows rounded to bf16 as the fragment is formed
        const float* X = reinterpret_cast<const float*>(as);
        const int k = ks * 16 + 2 * c;
#pragma unroll
        for (int t = 0; t < MT; ++t) {
          const float* xr = X + (r_base + 8 * t + g) * kLdX + k;
          const float2 x0 = *reinterpret_cast<const float2*>(xr);
          const float2 x1 = *reinterpret_cast<const float2*>(xr + 8);
          mma_bf16(acc[t], a, pack_bf16x2(x0.x, x0.y), pack_bf16x2(x1.x, x1.y));
        }
      } else if (ln) {  // the batch rows normalized to bf16 as the fragment is formed
        const float* X = reinterpret_cast<const float*>(as);
        const float* gb = reinterpret_cast<const float*>(ws + w_slab_bytes<WT, NS>());
        const int k = ks * 16 + 2 * c;
        const float2 g0 = *reinterpret_cast<const float2*>(gb + k);
        const float2 g1 = *reinterpret_cast<const float2*>(gb + k + 8);
        const float2 b0 = *reinterpret_cast<const float2*>(gb + kKC + k);
        const float2 b1 = *reinterpret_cast<const float2*>(gb + kKC + k + 8);
#pragma unroll
        for (int t = 0; t < MT; ++t) {
          const float* xr = X + (r_base + 8 * t + g) * kLdX + k;
          const float2 x0 = *reinterpret_cast<const float2*>(xr);
          const float2 x1 = *reinterpret_cast<const float2*>(xr + 8);
          const float m = mu_t[t], rs = rs_t[t];
          mma_bf16(acc[t], a,
                   pack_bf16x2((x0.x - m) * rs * g0.x + b0.x, (x0.y - m) * rs * g0.y + b0.y),
                   pack_bf16x2((x1.x - m) * rs * g1.x + b1.x, (x1.y - m) * rs * g1.y + b1.y));
        }
      } else {
        const bf* A = reinterpret_cast<const bf*>(as);
#pragma unroll
        for (int t = 0; t < MT; t += 2) {
          const bf* arow = A + (r_base + t * 8 + (lane & 7)) * kLdA + ks * 16 +
                           (((lane >> 3) & 1) << 3);
          if (t + 1 < MT) {
            uint32_t b[4];
            ldmatrix_x4(b, arow + ((lane >> 4) << 3) * kLdA);
            mma_bf16(acc[t], a, b[0], b[1]);
            mma_bf16(acc[t + 1], a, b[2], b[3]);
          } else {
            uint32_t b[2];
            ldmatrix_x2(b, arow);
            mma_bf16(acc[t], a, b[0], b[1]);
          }
        }
      }
    }
  };
  if (n <= ST) {  // the whole K range is in the ring: one wait, no more syncs
    cp_async_wait<0>();
    __syncthreads();
    for (int j = 0; j < n; ++j) stage(j);
  } else {
    for (int j = 0; j < n; ++j) {
      if (j == 0)
        cp_async_wait<0>();
      else
        cp_async_wait<ST - 2>();
      __syncthreads();  // stage j is in; every warp is done with stage j - 1's slot
      if (j >= 1 && j - 1 + ST < n) {
        load_w(j - 1 + ST);
        load_a(j - 1 + ST);
      }
      cp_async_commit();
      stage(j);
    }
  }
  cp_async_wait<0>();

  // Each split's partial sums go straight into the shared memory of the
  // block that finalizes their row (row r: the cluster's block r % splits),
  // one slot per (split, warp group); one cluster barrier; then each block
  // sums its rows' slots in order and runs their epilogue.
  // acc[t]: output columns strip * 16 + g (+ 8), rows r_base + 8 t + 2 c (+ 1)
  const int rpo = (RB + splits - 1) / splits;  // rows a block finalizes, at most
  const int slot = split * KG + (KG == 2 ? grp : 0), slots = splits * KG;

#pragma unroll
  for (int t = 0; t < MT; ++t) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r_base + 8 * t + 2 * c + (e & 1), col = strip * 16 + g + (e & 2 ? 8 : 0);
      if (m0 + r >= M) continue;
      float* dst = splits == 1 ? Rb : cluster.map_shared_rank(Rb, r % splits);
      dst[(slot * rpo + r / splits) * C::LDC + col] = acc[t][e];
    }
  }
  cluster.sync();  // every partial is in place

  if constexpr (BM) {
    if (p.e_mode == kELstm) {
      // the block's 80 columns: gate q of hidden unit j0 + u at column 16 q + u
      // (NS = 5); a thread per (row, unit): i, f, g, o and the sentinel gate,
      // the cell, h' = o tanh(c'), sentinel = s tanh(c')
      const int H = N / 5, j0 = tile * 16;
      for (int i = tid; i < rpo * 16; i += THREADS) {
        const int li = i / 16, u = i % 16, r = split + li * splits, row = m0 + r;
        if (r >= RB || row >= M) continue;
        float z[5];
#pragma unroll
        for (int q = 0; q < 5; ++q) {
          float s = 0.f;  // the slots in order
          for (int sl = 0; sl < slots; ++sl) s += Rb[(sl * rpo + li) * C::LDC + 16 * q + u];
          z[q] = s + __ldg(p.gxb + (long)row * N + (long)q * H + j0 + u);
        }
        const long o = (long)row * H + j0 + u;
        const float c_new = sigmoid(z[1]) * __ldcg(p.c_in + o) + sigmoid(z[0]) * tanhf(z[2]);
        const float tc = tanhf(c_new);
        outf[o] = sigmoid(z[3]) * tc;
        p.c_out[o] = c_new;
        p.s_out[o] = sigmoid(z[4]) * tc;
      }
    } else {  // kEF32, kEF32Tanh (NS = 4, 2): a warp per row, lane columns 2 lane, 2 lane + 1
      for (int li = warp; li < rpo; li += THREADS / 32) {
        const int r = split + li * splits, row = m0 + r;
        if (r >= RB || row >= M) break;
        if (c0 >= NT) continue;  // NS = 2: 32 columns, lanes 0-15
        float s0 = 0.f, s1 = 0.f;  // the slots in order
        for (int q = 0; q < slots; ++q) {
          const float2 v = *reinterpret_cast<const float2*>(Rb + (q * rpo + li) * C::LDC + c0);
          s0 += v.x;
          s1 += v.y;
        }
        float y0 = s0 + bias2.x, y1 = s1 + bias2.y;
        if (p.e_mode == kEF32Tanh) {
          y0 = tanhf(y0);
          y1 = tanhf(y1);
        }
        *reinterpret_cast<float2*>(outf + (long)row * N + n0 + c0) = make_float2(y0, y1);
      }
    }
  } else {
    const bool stats = p.e_mode == kEResidual || p.e_mode == kEEmbed;
    for (int li = warp; li < rpo; li += THREADS / 32) {
      const int r = split + li * splits, row = m0 + r;
      if (r >= RB || row >= M) break;
      if (c0 >= NT) continue;  // NS = 2 (a store, no statistics): lanes 0-15
      float s0 = 0.f, s1 = 0.f;  // the slots in order
      for (int q = 0; q < slots; ++q) {
        const float2 v = *reinterpret_cast<const float2*>(Rb + (q * rpo + li) * C::LDC + c0);
        s0 += v.x;
        s1 += v.y;
      }
      const float2 xo = p.e_mode == kEResidual  // x as the kernel found it
                            ? *reinterpret_cast<const float2*>(static_cast<const float*>(p.out) +
                                                               (long)row * N + n0 + c0)
                            : make_float2(0.f, 0.f);
      const float x0 = epilogue<bf>(p, s0, row, n0 + c0, N, bias2.x, scale2.x, pos2.x, xo.x);
      const float x1 = epilogue<bf>(p, s1, row, n0 + c0 + 1, N, bias2.y, scale2.y, pos2.y, xo.y);
      if (stats) tile_row_stats(x0, x1, p.stats + (long)tile * M + row, lane);
    }
  }
}

template <typename WT, int MT, int KG, int NS, bool BM>
static bool launch_shape(const TfDense& p, int M, int N, int K, const Plan& s, bool pdl,
                         cudaStream_t stream) {
  size_t most = 0;
  for (int sp = 1; sp <= kMaxSplits; sp *= 2)
    most = std::max(most, smem_bytes<WT, MT, KG, NS, BM>(1 << 20, sp));
  static const bool raised =
      cudaFuncSetAttribute(tf_stream<WT, MT, KG, NS, BM>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most) == cudaSuccess;
  if (!raised) return false;
  const size_t smem = smem_bytes<WT, MT, KG, NS, BM>(K / kKC, s.splits);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(s.tiles, s.splits, s.chunks);
  cfg.blockDim = Cols<NS>::THREADS;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;  // a cluster: the K splits of a tile
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = s.splits;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pdl ? 2 : 1;
  return cudaLaunchKernelEx(&cfg, tf_stream<WT, MT, KG, NS, BM>, p, M, N, K) == cudaSuccess;
}

// false for shapes it does not take: N (each problem's) a multiple of the
// block's columns, K of 32 (of 64 under a LayerNorm, whose row statistics
// tiles must also fit the activation ring; kernel B: k_split too).
template <typename WT, int NS = 4, bool BM = false>
static bool launch(const TfDense& p, int M, int N, int K, bool pdl, cudaStream_t stream) {
  constexpr int NT = Cols<NS>::NT;
  if (M < 1 || N < NT || N % NT || K < kKC || K % kKC ||
      (p.a_mode == kALayerNorm && (BM || M > kLnRows || K % kNT || K / kNT > 32)))
    return false;  // (a LayerNorm row's statistics tiles: one a lane)
  if (BM ? (p.nprob < 1 || p.k_split < 0 || p.k_split > K || p.k_split % kKC ||
            (p.k_split < K && p.a2 == nullptr) || (p.e_mode == kELstm) != (NS == 5) ||
            (p.e_mode != kELstm && p.e_mode != kEF32 && p.e_mode != kEF32Tanh))
         : ((p.a_mode == kALayerNorm || p.e_mode == kEResidual || p.e_mode == kEEmbed) &&
            p.stats == nullptr))
    return false;
  // D's and E's 32-column blocks (the head at E = 32): a store only; the
  // LayerNorm preamble takes 8 warps, x's statistics 64-column tiles
  if (!BM && NS == 2 &&
      (p.a_mode == kALayerNorm || (p.e_mode != kEStore && p.e_mode != kEStoreF32)))
    return false;
  const Plan s = plan(M, N * (BM ? p.nprob : 1), K, NT);
  switch (s.rb) {
    case 8:
      return launch_shape<WT, 1, 2, NS, BM>(p, M, N, K, s, pdl, stream);
    case 16:
      return launch_shape<WT, 1, 1, NS, BM>(p, M, N, K, s, pdl, stream);
    case 32:
      return launch_shape<WT, 2, 1, NS, BM>(p, M, N, K, s, pdl, stream);
    case 64:
      return launch_shape<WT, 4, 1, NS, BM>(p, M, N, K, s, pdl, stream);
    default:
      return launch_shape<WT, 8, 1, NS, BM>(p, M, N, K, s, pdl, stream);
  }
}

// Output columns of a block for a product of N columns (kernel B's gate
// aside): 64, or 32 where N is an odd multiple of 32 (E = 32).
constexpr int block_cols(int N) { return N % kNT ? Cols<2>::NT : Cols<4>::NT; }

// launch() in blocks of block_cols(N) columns.
template <typename WT, bool BM = false>
static bool launch_by_cols(const TfDense& p, int M, int N, int K, bool pdl,
                           cudaStream_t stream) {
  return N % kNT ? launch<WT, 2, BM>(p, M, N, K, pdl, stream)
                 : launch<WT, 4, BM>(p, M, N, K, pdl, stream);
}

}  // namespace wsp

}  // namespace capk
