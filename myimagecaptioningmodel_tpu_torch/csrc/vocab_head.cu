// Greedy tied-vocab head (kernel A): ids[m] = argmax_v (proj[m] . table[v]
// (* scale[v]) + bias[v]), for the greedy entry (capk_vocab_argmax) and for
// the greedy head of the whole-decode kernel D (fused_transformer.cu, through
// vocab_head.cuh).
//
// Replaces myimagecaptioningmodel_tpu/ops/pallas/vocab_head.py:89
// greedy_vocab_argmax. The TPU kernel walks the vocab in 2048-row blocks on
// one core and carries a running (max, argmax) in VMEM scratch from one grid
// step to the next. Blocks of a CUDA grid run in parallel and in no order, so
// the running state becomes per-tile partials and a merge.
//
// Numerics (the TPU kernel's _block_logits): proj is rounded to the table's
// dtype, or to bfloat16 for an int8 table (whose values are exact in
// bfloat16); products accumulate in float32; an int8 table's per-row scale
// multiplies the sum, then the bias is added, as two rounded operations.
//
// What bounds it on an H100: the table's bytes (12416 x 256 bf16 = 6.4 MB,
// 1.91 us at 3.35 TB/s; int8 half), at the served batch (8 rows) and at the
// offline batch (128 rows, 1.95 us) alike; the B = 128 product is 0.81 GFLOP,
// 0.82 us at the bf16 tensor-core peak (12 us on FMA units). The design is
// kernel C's tile (topk_head.cu) with an argmax for the selection:
//
//   1. argmax_tile: grid (vocab tiles of VT rows) x (batch chunks of MB
//      rows). A block copies its VT table rows into shared memory with
//      cp.async (int8: the raw bytes, then widened to bf16 in shared memory,
//      exactly), rounds its MB proj rows to the staged dtype as it stores
//      them, and multiplies, E in chunks through two buffers, chunk c + 1's
//      table copy and proj loads in flight while chunk c multiplies (chunks
//      of 256 for the small tiles below, which take the served E = 256 in
//      one, and of 128 for the large one; float32: 64); each table row is
//      read once per block of batch rows:
//      bf16 / int8 tables: tensor cores, mma.sync m16n8k16. Vocab rows are
//        the product's 16-row side and batch rows its 8-wide side (8 rows
//        fill an n-tile), E the depth, float32 accumulators in registers;
//        warp (wm, wn) of WM x WN takes VT / WM vocab rows x MB / WN batch
//        rows.
//      float32 tables: FMA in e order; thread (p, q) takes vocab rows
//        p + GV i x batch rows q + GB j.
//      The logits never leave the registers: each thread takes the best of
//      its own vocab rows, in ascending order, for each of its batch rows;
//      the lanes that hold the same batch rows meet by shuffles, the warps
//      through a few words of shared memory, and one (max, index) per
//      (row, tile) goes to part_v / part_i.
//   2. argmax_merge: a warp per batch row over the row's tiles, 16 loads a
//      lane in flight at a time; it also writes the winning logit when the
//      caller asks for it (out_v, the vocab-parallel decode's merge over
//      ranks: the value of the tile kernel's own sum, not a recomputation). A merge inside the tile kernel (the last
//      block to take a ticket) measured slower on an H100 (chip_probe.py):
//      the release fence before every block's ticket added ~1.2 us to each
//      block, more than this kernel's ~2 us.
//
// Tiles, on 132 SMs:
//   M <= 8:  VT = 32, MB = 8, 2 warps: 388 blocks at V = 12416, about three
//            an SM in one wave (21 KB of shared memory each at E = 256, up to
//            ten fit), so each SM has ~48 KB of table in flight, against
//            ~15 KB that its share of the HBM rate times the latency asks for;
//   M <= 16: VT = 32, MB = 16, the same grid;
//   M > 16:  VT = 96, MB = 128, 8 warps (2 x 4; 3 m-tiles x 4 n-tiles each):
//            130 blocks at B = 128, one an SM in one wave (122 KB of shared
//            memory in bf16 at E = 256, 146 KB int8). Each block stages the
//            128 proj rows again (128 KB of float32 from L2, each block from
//            another row first): 16.6 MB of L2 reads against the table's
//            6.4 MB, where 32-row tiles would read 50 MB.
//   Batch rows past M are skipped by whole n-tiles.
//
// Tie rule: jnp.argmax returns the LOWEST index among equal maxima. Every
// comparison takes a candidate when its value is larger, or equal with a
// lower index (better(), common.cuh), so any order gives the lowest index.
#include "vocab_head.cuh"

#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace capk {
namespace argmax {

// A tile: VT vocab rows x MB batch rows, WM x WN warps.
template <int VT_, int MB_, int WM_, int WN_>
struct Shape {
  static constexpr int VT = VT_, MB = MB_, WM = WM_, WN = WN_, THREADS = 32 * WM * WN;
  // bf16 chunk depth: the small tiles take E = 256 in one chunk, the large
  // one in two, the second loading while the first multiplies (each the
  // faster of the two on an H100)
  static constexpr int KC16 = MB <= 16 ? 256 : 128;
  // tensor cores: a warp's m-tiles and n-tiles
  static constexpr int MTW = VT / (16 * WM), NTW = MB / (8 * WN);
  static_assert(MTW * 16 * WM == VT && NTW * 8 * WN == MB, "whole fragments");
  static_assert(NTW == 1 || NTW % 2 == 0, "n-tiles load in pairs");
  // float32: thread (p, q) = (t / GB, t % GB), RV vocab x RB batch rows
  static constexpr int GB = MB <= 16 ? 8 : 16, GV = THREADS / GB;
  static constexpr int RV = VT / GV, RB = MB / GB;
  static_assert(RV * GV == VT && RB * GB == MB && GB <= 32, "whole float32 micro-tiles");
};
using Small8 = Shape<32, 8, 2, 1>;
using Small16 = Shape<32, 16, 2, 1>;
using Large = Shape<96, 128, 2, 4>;

// The staged dtype S, the chunk depth KC and what one chunk's depth is
// padded to: a 16-deep k-step, or a float4.
template <typename T, class Sh>
struct Staged {
  using S = __nv_bfloat16;
  static constexpr int KC = Sh::KC16, PAD = 16;
};
template <class Sh>
struct Staged<float, Sh> {
  using S = float;
  static constexpr int KC = 64, PAD = 4;
};

// Padded depth of the chunk of n remaining elements of E.
template <typename T, class Sh>
__host__ __device__ constexpr int depth_of(int n) {
  using St = Staged<T, Sh>;
  return n >= St::KC ? St::KC : (n + St::PAD - 1) / St::PAD * St::PAD;
}
// A staged row: the deepest chunk + 16 bytes against bank conflicts.
template <typename T, class Sh>
__host__ __device__ constexpr int row_ld(int E) {
  return depth_of<T, Sh>(E) + 16 / (int)sizeof(typename Staged<T, Sh>::S);
}
// One chunk's buffer: table rows, proj rows, int8's raw rows.
template <typename T, class Sh>
__host__ __device__ constexpr size_t buffer_bytes(int E) {
  const size_t rows =
      (size_t)(Sh::VT + Sh::MB) * row_ld<T, Sh>(E) * sizeof(typename Staged<T, Sh>::S);
  return rows + (sizeof(T) == 1 ? (size_t)Sh::VT * depth_of<T, Sh>(E) : 0);
}
// Two buffers when E takes more than one chunk: chunk c + 1 loads while c multiplies.
template <typename T, class Sh>
__host__ __device__ constexpr size_t smem_bytes(int E) {
  return buffer_bytes<T, Sh>(E) * (E > Staged<T, Sh>::KC ? 2 : 1);
}

// One chunk's buffer, carved from the kernel's shared memory.
template <typename T, class Sh>
struct Buf {
  using S = typename Staged<T, Sh>::S;
  S *tab, *pj;
  int8_t* raw;
  __device__ __forceinline__ Buf(unsigned char* smem, int buf, int E) {
    unsigned char* b = smem + buf * buffer_bytes<T, Sh>(E);
    tab = reinterpret_cast<S*>(b);
    pj = tab + Sh::VT * row_ld<T, Sh>(E);
    raw = reinterpret_cast<int8_t*>(pj + Sh::MB * row_ld<T, Sh>(E));
  }
};

// The chunk [k0, k0 + kp) of table rows [v0, v0 + VT) with cp.async (int8:
// its raw bytes), and for float32 tables the proj rows [m0, m0 + MB) too;
// zero past V, M and E. One commit group.
template <typename T, class Sh>
__device__ __forceinline__ void issue_chunk(const Buf<T, Sh>& bf, const float* __restrict__ proj,
                                            const T* __restrict__ table, int M, int V, int E,
                                            int v0, int m0, int k0, int kp) {
  constexpr int KC = Staged<T, Sh>::KC;
  const int ld = row_ld<T, Sh>(E), rld = depth_of<T, Sh>(E);
  // a row's copies: 16 bytes each, but 8 for int8 rows that are not 16-byte
  // aligned (E % 16 != 0); KC / elements a copy of them, a power of two, so
  // the loops shift rather than divide, and skip the copies past kp
  auto rows = [&](auto tw_c) {
    constexpr int TW = decltype(tw_c)::value, VPR = KC / TW, SH = VPR == 32 ? 5 : VPR == 16 ? 4 : 3;
    static_assert(VPR == 1 << SH, "a power of two");
    for (int i = threadIdx.x; i < Sh::VT * VPR; i += Sh::THREADS) {
      const int r = i >> SH, c = (i & (VPR - 1)) * TW, v = v0 + r;
      if (c >= kp) continue;
      const bool in = v < V && k0 + c < E;  // E % TW == 0: a copy is wholly in or out
      const T* src = in ? table + (long)v * E + k0 + c : table;
      if constexpr (sizeof(T) != 1)
        cp_async16(bf.tab + r * ld + c, src, in ? 16 : 0);
      else if constexpr (TW == 16)
        cp_async16(bf.raw + r * rld + c, src, in ? 16 : 0);
      else
        cp_async8(bf.raw + r * rld + c, src, in ? 8 : 0);
    }
  };
  if (sizeof(T) == 1 && E % 16 != 0)
    rows(std::integral_constant<int, 8>{});
  else
    rows(std::integral_constant<int, 16 / sizeof(T)>{});
  if constexpr (sizeof(typename Staged<T, Sh>::S) == 4) {  // float32 proj: a copy as well
    constexpr int VPR = KC / 4, SH = VPR == 16 ? 4 : 5;
    static_assert(VPR == 1 << SH, "a power of two");
    for (int i = threadIdx.x; i < Sh::MB * VPR; i += Sh::THREADS) {
      const int r = i >> SH, c = (i & (VPR - 1)) * 4, row = m0 + r;
      if (c >= kp) continue;
      const bool in = row < M && k0 + c < E;
      cp_async16(bf.pj + r * ld + c, in ? proj + (long)row * E + k0 + c : proj, in ? 16 : 0);
    }
  }
  cp_async_commit();
}

// bf16 staging of proj: a thread's share of one chunk's rows, 8 floats an
// item, loaded into registers (load_proj, in flight while the previous chunk
// multiplies) and then rounded and stored (store_proj).
template <class Sh>
struct ProjRegs {
  static constexpr int VPR = Sh::KC16 / 8;  // 8-float items a proj row
  static constexpr int N = Sh::MB * VPR / Sh::THREADS;
  static_assert(Sh::MB * VPR % Sh::THREADS == 0, "whole items");
  float4 u[N][2];
};
// The proj row of item i: each block starts at another row (every block
// reads the same rows, so in step they would all ask the same L2 lines).
template <class Sh>
__device__ __forceinline__ int proj_row(int i) {
  static_assert((Sh::MB & (Sh::MB - 1)) == 0, "MB a power of two");
  return (i / ProjRegs<Sh>::VPR + blockIdx.x) & (Sh::MB - 1);
}
template <class Sh>
__device__ __forceinline__ void load_proj(ProjRegs<Sh>& pr, const float* __restrict__ proj, int M,
                                          int E, int m0, int k0, int kp) {
#pragma unroll
  for (int b = 0; b < ProjRegs<Sh>::N; ++b) {
    const int i = threadIdx.x + b * Sh::THREADS, r = proj_row<Sh>(i), c = (i % ProjRegs<Sh>::VPR) * 8;
    const int row = m0 + r;
    const bool in = c < kp && row < M && k0 + c < E;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      pr.u[b][h] = in ? __ldg(reinterpret_cast<const float4*>(proj + (long)row * E + k0 + c) + h)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}
template <class Sh>
__device__ __forceinline__ void store_proj(const ProjRegs<Sh>& pr, __nv_bfloat16* pj, int ld,
                                           int kp) {
#pragma unroll
  for (int b = 0; b < ProjRegs<Sh>::N; ++b) {
    const int i = threadIdx.x + b * Sh::THREADS, r = proj_row<Sh>(i), c = (i % ProjRegs<Sh>::VPR) * 8;
    if (c >= kp) continue;
    const float f[8] = {pr.u[b][0].x, pr.u[b][0].y, pr.u[b][0].z, pr.u[b][0].w,
                        pr.u[b][1].x, pr.u[b][1].y, pr.u[b][1].z, pr.u[b][1].w};
    *reinterpret_cast<uint4*>(pj + r * ld + c) = pack(f);
  }
}

// int8 -> bf16 in shared memory, exactly: a chunk's raw rows into its table rows.
template <class Sh>
__device__ __forceinline__ void widen(const Buf<int8_t, Sh>& bf, int E, int kp) {
  const int ld = row_ld<int8_t, Sh>(E), rld = depth_of<int8_t, Sh>(E);
  constexpr int VPR = Sh::KC16 / 8;
  for (int i = threadIdx.x; i < Sh::VT * VPR; i += Sh::THREADS) {
    const int r = i / VPR, c = (i % VPR) * 8;
    if (c >= kp) continue;
    const uint2 u = *reinterpret_cast<const uint2*>(bf.raw + r * rld + c);
    float f[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) f[j] = table_elem(static_cast<const int8_t*>(nullptr), u, j);
    *reinterpret_cast<uint4*>(bf.tab + r * ld + c) = pack(f);
  }
}

// Each (v, i) against lane ^ off's, the better kept.
template <int N>
__device__ __forceinline__ void shfl_best(float (&bv)[N], int (&bi)[N], int off) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv[n], off);
    const int oi = __shfl_xor_sync(0xffffffffu, bi[n], off);
    if (better(ov, oi, bv[n], bi[n])) {
      bv[n] = ov;
      bi[n] = oi;
    }
  }
}

// The chunk loop: chunk c multiplies (product(buf, c's Buf, kp)) while chunk
// c + 1's table copy and (bf16) proj loads are in flight. Ends synchronized.
template <typename T, class Sh, class Product>
__device__ __forceinline__ void chunks(unsigned char* smem, const float* __restrict__ proj,
                                       const T* __restrict__ table, int M, int V, int E, int v0,
                                       int m0, Product&& product) {
  constexpr int KC = Staged<T, Sh>::KC;
  constexpr bool kBf16 = sizeof(typename Staged<T, Sh>::S) == 2;
  const int nch = (E + KC - 1) / KC, ld = row_ld<T, Sh>(E);
  auto kp_of = [&](int c) { return depth_of<T, Sh>(E - c * KC); };
  ProjRegs<Sh> pr;
  issue_chunk<T, Sh>(Buf<T, Sh>(smem, 0, E), proj, table, M, V, E, v0, m0, 0, kp_of(0));
  if (nch > 1)
    issue_chunk<T, Sh>(Buf<T, Sh>(smem, 1, E), proj, table, M, V, E, v0, m0, KC, kp_of(1));
  if constexpr (kBf16) {
    load_proj<Sh>(pr, proj, M, E, m0, 0, kp_of(0));
    store_proj<Sh>(pr, Buf<T, Sh>(smem, 0, E).pj, ld, kp_of(0));
  }
  for (int c = 0; c < nch; ++c) {
    const Buf<T, Sh> bf(smem, c & 1, E);
    if constexpr (kBf16) {
      if (c + 1 < nch) load_proj<Sh>(pr, proj, M, E, m0, (c + 1) * KC, kp_of(c + 1));
    }
    if (c + 1 < nch)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();  // chunk c's table (and float32 proj) copies are in
    if constexpr (sizeof(T) == 1) {
      widen<Sh>(bf, E, kp_of(c));
      __syncthreads();
    }
    product(bf, kp_of(c));
    if constexpr (kBf16) {
      if (c + 1 < nch) store_proj<Sh>(pr, Buf<T, Sh>(smem, (c + 1) & 1, E).pj, ld, kp_of(c + 1));
    }
    __syncthreads();  // chunk c's buffer is free; chunk c + 1's proj is in
    if (c + 2 < nch)
      issue_chunk<T, Sh>(bf, proj, table, M, V, E, v0, m0, (c + 2) * KC, kp_of(c + 2));
  }
}

// bf16 operands (bf16 and int8 tables): the tile's products on tensor
// cores; each warp leaves the best (logit, vocab row) of its vocab rows for
// each of its batch rows in red_v[wm][col] / red_i[wm][col].
template <typename T, class Sh>
__device__ __forceinline__ void tile_best_tc(unsigned char* smem, const float* __restrict__ proj,
                                             const T* __restrict__ table,
                                             const float* __restrict__ bias,
                                             const float* __restrict__ scale, int M, int V, int E,
                                             int v0, int m0, float (*red_v)[Sh::MB],
                                             int (*red_i)[Sh::MB]) {
  constexpr int MTW = Sh::MTW, NTW = Sh::NTW;
  const int ld = row_ld<T, Sh>(E);
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  const int wm = warp % Sh::WM, wn = warp / Sh::WM;
  const int vr = wm * (Sh::VT / Sh::WM), br = wn * (Sh::MB / Sh::WN);
  // n-tiles of this warp that hold a row < M
  const int live = min(NTW, max(0, (M - m0 - br + 7) / 8));
  // the epilogue's scale and bias, loaded before the product hides them
  float sc[MTW][2], bs[MTW][2];
#pragma unroll
  for (int i = 0; i < MTW; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int v = v0 + vr + 16 * i + 8 * h + g;
      sc[i][h] = scale != nullptr && v < V ? scale[v] : 1.f;
      bs[i][h] = v < V ? bias[v] : 0.f;
    }
  float acc[MTW][NTW][4];
#pragma unroll
  for (int i = 0; i < MTW; ++i)
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  chunks<T, Sh>(smem, proj, table, M, V, E, v0, m0, [&](const Buf<T, Sh>& bf, int kp) {
    if (live == 0) return;
    const __nv_bfloat16* a_base = bf.tab + (vr + (lane & 15)) * ld + (lane >> 4) * 8;
    // B from proj's [n][k] rows: x4 gives (n 0-7, k 0-7), (n 0-7, k 8-15),
    // (n 8-15, k 0-7), (n 8-15, k 8-15) of an n-tile pair; x2 the first two
    const __nv_bfloat16* b_base =
        bf.pj + (br + (lane & 7) + (NTW > 1 ? (lane >> 4) << 3 : 0)) * ld + ((lane >> 3) & 1) * 8;
    for (int kk = 0; kk < kp; kk += 16) {
      uint32_t a[MTW][4], b[NTW][2];
#pragma unroll
      for (int i = 0; i < MTW; ++i) ldmatrix_x4(a[i], a_base + 16 * i * ld + kk);
      if constexpr (NTW == 1) {
        ldmatrix_x2(b[0], b_base + kk);
      } else {
#pragma unroll
        for (int jj = 0; jj < NTW / 2; ++jj) {
          uint32_t r[4];
          ldmatrix_x4(r, b_base + 16 * jj * ld + kk);
          b[2 * jj][0] = r[0];
          b[2 * jj][1] = r[1];
          b[2 * jj + 1][0] = r[2];
          b[2 * jj + 1][1] = r[3];
        }
      }
#pragma unroll
      for (int i = 0; i < MTW; ++i)
#pragma unroll
        for (int j = 0; j < NTW; ++j)
          if (j < live) mma_bf16(acc[i][j], a[i], b[j][0], b[j][1]);
    }
  });
  float bv[NTW][2];
  int bi[NTW][2];
#pragma unroll
  for (int j = 0; j < NTW; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      bv[j][e] = -INFINITY;
      bi[j][e] = INT_MAX;
    }
  // this thread's vocab rows vr + 16 i + 8 h + g, in ascending order
#pragma unroll
  for (int i = 0; i < MTW; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int v = v0 + vr + 16 * i + 8 * h + g;
      if (v >= V) continue;
#pragma unroll
      for (int j = 0; j < NTW; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float l = acc[i][j][2 * h + e];
          if (scale != nullptr) l = __fmul_rn(l, sc[i][h]);
          l = __fadd_rn(l, bs[i][h]);
          if (better(l, v, bv[j][e], bi[j][e])) {
            bv[j][e] = l;
            bi[j][e] = v;
          }
        }
    }
  // lanes g = 0..7 of one c hold the same batch rows
  float fv[2 * NTW];
  int fi[2 * NTW];
#pragma unroll
  for (int n = 0; n < 2 * NTW; ++n) {
    fv[n] = bv[n / 2][n % 2];
    fi[n] = bi[n / 2][n % 2];
  }
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) shfl_best(fv, fi, off);
  if (g == 0) {
#pragma unroll
    for (int n = 0; n < 2 * NTW; ++n) {
      const int col = br + 8 * (n / 2) + 2 * c + n % 2;
      red_v[wm][col] = fv[n];
      red_i[wm][col] = fi[n];
    }
  }
}

// float32 tables: FMA in e order; each warp leaves its best per batch row in
// red_v[warp][col] / red_i[warp][col].
template <class Sh>
__device__ __forceinline__ void tile_best_fma(unsigned char* smem, const float* __restrict__ proj,
                                              const float* __restrict__ table,
                                              const float* __restrict__ bias,
                                              const float* __restrict__ /*scale*/, int M, int V,
                                              int E, int v0, int m0, float (*red_v)[Sh::MB],
                                              int (*red_i)[Sh::MB]) {
  constexpr int RV = Sh::RV, RB = Sh::RB, GV = Sh::GV, GB = Sh::GB;
  const int ld = row_ld<float, Sh>(E);
  const int p = threadIdx.x / GB, q = threadIdx.x % GB;
  float bs[RV];
#pragma unroll
  for (int i = 0; i < RV; ++i) bs[i] = v0 + p + GV * i < V ? bias[v0 + p + GV * i] : 0.f;
  float acc[RV][RB];
#pragma unroll
  for (int i = 0; i < RV; ++i)
#pragma unroll
    for (int j = 0; j < RB; ++j) acc[i][j] = 0.f;
  chunks<float, Sh>(smem, proj, table, M, V, E, v0, m0, [&](const Buf<float, Sh>& bf, int kp) {
    for (int e = 0; e < kp; e += 4) {
      float4 a[RV], b[RB];
#pragma unroll
      for (int i = 0; i < RV; ++i)
        a[i] = *reinterpret_cast<const float4*>(bf.tab + (p + GV * i) * ld + e);
#pragma unroll
      for (int j = 0; j < RB; ++j)
        b[j] = *reinterpret_cast<const float4*>(bf.pj + (q + GB * j) * ld + e);
#pragma unroll
      for (int i = 0; i < RV; ++i)
#pragma unroll
        for (int j = 0; j < RB; ++j) {
          acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
          acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
          acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
          acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
        }
    }
  });
  float bv[RB];
  int bi[RB];
#pragma unroll
  for (int j = 0; j < RB; ++j) {
    bv[j] = -INFINITY;
    bi[j] = INT_MAX;
  }
#pragma unroll
  for (int i = 0; i < RV; ++i) {  // vocab rows p + GV i, ascending
    const int v = v0 + p + GV * i;
    if (v >= V) continue;
#pragma unroll
    for (int j = 0; j < RB; ++j) {
      const float l = __fadd_rn(acc[i][j], bs[i]);
      if (better(l, v, bv[j], bi[j])) {
        bv[j] = l;
        bi[j] = v;
      }
    }
  }
  // the lanes of one q differ in p's low bits, lane bits log2(GB) and up
#pragma unroll
  for (int off = GB; off < 32; off <<= 1) shfl_best(bv, bi, off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  if (lane < GB) {
#pragma unroll
    for (int j = 0; j < RB; ++j) {
      red_v[warp][q + GB * j] = bv[j];
      red_i[warp][q + GB * j] = bi[j];
    }
  }
}

template <typename T, class Sh>
__global__ void __launch_bounds__(Sh::THREADS)
    argmax_tile(const float* __restrict__ proj,   // [M, E] f32
                const T* __restrict__ table,      // [V, E]
                const float* __restrict__ bias,   // [V]
                const float* __restrict__ scale,  // [V] or null
                int M, int V, int E,
                float* __restrict__ part_v,  // [M, pstride]
                int* __restrict__ part_i,    // [M, pstride]
                int pstride, const int* __restrict__ skip) {
  if (pdl_enter(skip)) return;
  // the vocab groups that meet in shared memory: the WM warp rows of the
  // tensor-core tile, every warp of the float32 one
  constexpr int NG = sizeof(typename Staged<T, Sh>::S) == 2 ? Sh::WM : Sh::THREADS / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red_v[NG][Sh::MB];
  __shared__ int red_i[NG][Sh::MB];
  const int v0 = blockIdx.x * Sh::VT, m0 = blockIdx.y * Sh::MB;
  if constexpr (sizeof(typename Staged<T, Sh>::S) == 2)
    tile_best_tc<T, Sh>(smem, proj, table, bias, scale, M, V, E, v0, m0, red_v, red_i);
  else
    tile_best_fma<Sh>(smem, proj, table, bias, scale, M, V, E, v0, m0, red_v, red_i);
  __syncthreads();
  for (int t = threadIdx.x; t < Sh::MB && m0 + t < M; t += Sh::THREADS) {
    float bv = red_v[0][t];
    int bi = red_i[0][t];
#pragma unroll
    for (int w = 1; w < NG; ++w) {
      if (better(red_v[w][t], red_i[w][t], bv, bi)) {
        bv = red_v[w][t];
        bi = red_i[w][t];
      }
    }
    part_v[(long)(m0 + t) * pstride + blockIdx.x] = bv;
    part_i[(long)(m0 + t) * pstride + blockIdx.x] = bi;
  }
}

constexpr int kMergeWarps = 8, kMergeBatch = 16;

// A warp per batch row: each lane takes tiles lane, lane + 32, ..., loaded
// kMergeBatch at a time (their loads in flight together; one round for up
// to 512 tiles), then the lanes meet by shuffles, all by better().
__global__ void __launch_bounds__(kMergeWarps * 32)
    argmax_merge(const float* __restrict__ part_v, const int* __restrict__ part_i,
                 int pstride, int ntiles, int M, int* __restrict__ out,
                 float* __restrict__ out_v, const int* __restrict__ skip) {
  if (pdl_enter(skip)) return;
  const int row = blockIdx.x * kMergeWarps + threadIdx.x / 32, lane = threadIdx.x & 31;
  if (row >= M) return;  // a whole warp
  const float* pv = part_v + (long)row * pstride;
  const int* pi = part_i + (long)row * pstride;
  float bv[1] = {-INFINITY};
  int bi[1] = {INT_MAX};
  for (int t0 = lane; t0 < ntiles; t0 += 32 * kMergeBatch) {
    float v[kMergeBatch];
    int i[kMergeBatch];
#pragma unroll
    for (int q = 0; q < kMergeBatch; ++q) {
      const int t = t0 + 32 * q;
      v[q] = t < ntiles ? pv[t] : -INFINITY;
      i[q] = t < ntiles ? pi[t] : INT_MAX;
    }
#pragma unroll
    for (int q = 0; q < kMergeBatch; ++q) {
      if (better(v[q], i[q], bv[0], bi[0])) {
        bv[0] = v[q];
        bi[0] = i[q];
      }
    }
  }
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) shfl_best(bv, bi, off);
  if (lane == 0) {
    out[row] = bi[0];
    if (out_v != nullptr) out_v[row] = bv[0];
  }
}

template <typename T, class Sh>
static bool launch(int M, int V, int E, const float* proj, const void* table, const float* bias,
                   const float* scale, float* part_v, int* part_i, int pstride, int* out,
                   const int* skip, bool pdl, cudaStream_t stream, float* out_v) {
  static const bool raised = raise_smem_limit(argmax_tile<T, Sh>);
  const size_t smem = smem_bytes<T, Sh>(E);
  if (!raised || smem > kMaxDynamicSmem) return false;
  const int ntiles = (V + Sh::VT - 1) / Sh::VT;
  if (launch_k(pdl, argmax_tile<T, Sh>, dim3(ntiles, (M + Sh::MB - 1) / Sh::MB), Sh::THREADS,
               smem, stream, proj, static_cast<const T*>(table), bias, scale, M, V, E, part_v,
               part_i, pstride, skip) != cudaSuccess)
    return true;  // reported by the caller
  launch_k(pdl, argmax_merge, (M + kMergeWarps - 1) / kMergeWarps, kMergeWarps * 32, 0, stream,
           part_v, part_i, pstride, ntiles, M, out, out_v, skip);
  return true;
}

}  // namespace argmax

int vocab_argmax_width(int V) { return (V + 31) / 32; }  // the smallest VT

bool vocab_argmax_launch(int table_dtype, int M, int V, int E, const float* proj,
                         const void* table, const float* bias, const float* scale,
                         float* part_v, int* part_i, int pstride, int* out, const int* skip,
                         bool pdl, cudaStream_t stream, float* out_v) {
  if (M < 1 || V < 1 || E < 8 || E % 8 != 0 || (table_dtype == kI8) != (scale != nullptr) ||
      pstride < vocab_argmax_width(V))
    return false;
  return dispatch_table_dtype(table_dtype, [&](auto tag) {
    using T = TableT<decltype(tag)>;
    if (M <= 8)
      return argmax::launch<T, argmax::Small8>(M, V, E, proj, table, bias, scale, part_v, part_i,
                                               pstride, out, skip, pdl, stream, out_v);
    if (M <= 16)
      return argmax::launch<T, argmax::Small16>(M, V, E, proj, table, bias, scale, part_v,
                                                part_i, pstride, out, skip, pdl, stream, out_v);
    return argmax::launch<T, argmax::Large>(M, V, E, proj, table, bias, scale, part_v, part_i,
                                            pstride, out, skip, pdl, stream, out_v);
  });
}

// Greedy: done rows emit <pad>, a row is done once it has emitted <stop>, and
// the flag is set once every row is done (early stop only); ids row t.
__global__ void __launch_bounds__(kGreedyFinishThreads)
    greedy_finish(int* __restrict__ word, int* __restrict__ done, int* __restrict__ flag,
                  int* __restrict__ ids_t, int B, int pad, int stop, int early) {
  if (pdl_enter(flag)) return;
  int live = 0;
  for (int r = threadIdx.x; r < B; r += blockDim.x) {
    int wd = word[r];
    if (early) {
      if (done[r]) wd = pad;
      const int d = done[r] | (wd == stop);
      done[r] = d;
      live |= !d;
      word[r] = wd;
    }
    ids_t[r] = wd;
  }
  if (!__syncthreads_or(live) && early && threadIdx.x == 0) *flag = 1;
}

}  // namespace capk

extern "C" {

// Width of the wrappers' partial buffers, [M, width] each.
int capk_vocab_argmax_nblocks(int V) { return capk::vocab_argmax_width(V); }

// Vocab rows of one tile of the tile kernel for M batch rows.
int capk_vocab_argmax_vocab_tile(int M) {
  static_assert(capk::argmax::Small8::VT == capk::argmax::Small16::VT, "one small tile");
  return M <= 16 ? capk::argmax::Small16::VT : capk::argmax::Large::VT;
}

// ids[M] = argmax over proj[M, E] . table[V, E]^T (* scale[V]) + bias[V].
// table_dtype: capk::kF32, kBF16, or kI8 with a float32 scale (null for the
// float tables); proj is float32 and is rounded to the table's dtype (to
// bfloat16 for int8) before the product. E must be a multiple of 8.
// part_v / part_i hold M x capk_vocab_argmax_nblocks(V) elements. out_v
// (null: not written) gets each row's winning logit, as the tile kernel
// summed it.
// Returns cudaGetLastError() (cudaErrorInvalidValue for operands the kernel
// does not take).
int capk_vocab_argmax(int table_dtype, int M, int V, int E, const float* proj,
                      const void* table, const float* bias, const float* scale,
                      float* part_v, int* part_i, int* out, float* out_v,
                      cudaStream_t stream) {
  if (!capk::vocab_argmax_launch(table_dtype, M, V, E, proj, table, bias, scale, part_v, part_i,
                                 capk::vocab_argmax_width(V), out, nullptr, false, stream,
                                 out_v))
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
