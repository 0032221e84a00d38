// Beam-search tied-vocab head (kernel C): per batch row, the top k of
//   logits[v] = proj . table[v] (* scale[v]) + bias[v]
// as (vals, ids), sorted by value and then by ascending index, and the row's
// logsumexp over all V logits.
//
// Replaces myimagecaptioningmodel_tpu/ops/pallas/vocab_head.py:206
// topk_vocab_head. The TPU kernel walks the vocab in 1024-row blocks on one
// core and carries a running top-k and a running (max, sum) in VMEM scratch
// from one grid step to the next. Blocks of a CUDA grid run in parallel and
// in no order, so the running state becomes per-tile partials and a combine.
//
// Numerics (the TPU kernel's _block_logits): proj is rounded to the
// table's dtype, or to bfloat16 for an int8 table (whose values are exact in
// bfloat16); products accumulate in float32; an int8 table's scale
// multiplies the sum, then the bias is added, as two rounded operations.
//
// What bounds it on an H100: at the beam's 32 rows, the table's bytes (6.4 MB
// in bf16, 1.9 us); at 512 rows, the product (3.3 GFLOP, 3.3 us at the bf16
// tensor-core peak). The design reads the table once per 128 batch rows and
// keeps the [M, V] logits out of device memory:
//
//   1. topk_tile: grid (V / 128 vocab tiles) x (M / 128 batch chunks), 256
//      threads. A block stages its 128 table rows once (cp.async for bf16 and
//      float32; int8 widened to bf16 as it is staged, exactly) and keeps them
//      for every batch row of its chunk, which it takes in sub-tiles of 64
//      rows (32 for float32), proj rounded as it is staged.
//      bf16 / int8: tensor cores, mma.sync m16n8k16; vocab rows are the
//      product's 16-row side, batch rows its 8-wide side, E the depth,
//      float32 accumulators in registers; warp w takes vocab rows
//      [32 (w % 4), + 32) x batch rows [32 (w / 4), + 32), the fragments of
//      the next 16-deep step loading while one multiplies.
//      float32: FMA in e order, each thread 4 vocab x 4 batch rows.
//      The sub-tile's logits (scale, bias, rows >= V at -inf) go to shared
//      memory, where each batch row is read by QT = 4 (8) neighbouring
//      threads, 32 (16) vocab rows each, all loaded at once: the row's max
//      and sum exp(l - max) by shuffles; a threshold from each thread's two
//      largest logits (no logit below it can be in the tile's top k, for
//      k <= 2 QT) leaves a few candidates a thread, which go into a sorted
//      top-KB list in registers in ascending vocab order (KB = k rounded up
//      to 4, 8, 16 or 32); then k rounds of a shuffle argmax over the QT
//      list heads. Only k candidates and one (max, sum) per row and 128-row
//      tile reach device memory: 4x fewer than 32-row tiles wrote.
//   2. topk_merge: one warp per batch row. Each lane inserts the candidates
//      of tiles lane, lane + 32, ... into its own sorted list; k rounds of a
//      warp argmax over the lanes' heads; lse = M + log(sum_t s_t
//      exp(m_t - M)), M the largest tile max, summed by a fixed butterfly.
//
// The merge stays a second kernel: a last-block-done merge inside topk_tile
// needs a counter zeroed before every call (one more launch, or state kept
// between calls that calls on two streams would share) and would run every
// row's merge on the one SM that finishes last.
//
// Tie rule: larger, or equal with the lower index (better(), common.cuh),
// at every comparison: within a thread the vocab rows come in ascending
// order, so a strictly-better test keeps the earlier row first; lists, heads
// and lanes merge with better(). So ids come out sorted by value and then
// ascending index: jax.lax.top_k's order. 1 <= k <= 32.
//
// Kernel E (fused_transformer.cu) runs both kernels as its head each step
// (topk_head.cuh), with its early-stop flag and programmatic dependent launch.
#include "topk_head.cuh"

#include "common.cuh"
#include "mma.cuh"

namespace capk {
namespace topk {

constexpr int kThreads = 256;
constexpr int kVT = 128;  // vocab rows of a tile
constexpr int kMB = 128;  // batch rows of a block's chunk

// Per table dtype: the staged element type S, the batch sub-tile BT, and the
// threads per batch row in the selection, QT = 256 / BT.
template <typename T>
struct Cfg {
  using S = __nv_bfloat16;
  static constexpr int BT = 64;
};
template <>
struct Cfg<float> {
  using S = float;
  static constexpr int BT = 32;
};

// The product's depth: E padded to 16 (to 4 for float32).
template <typename T>
__host__ __device__ constexpr int ep_of(int E) {
  return sizeof(typename Cfg<T>::S) == 2 ? (E + 15) / 16 * 16 : (E + 3) / 4 * 4;
}
// A staged row: + 16 bytes against bank conflicts.
template <typename T>
__host__ __device__ constexpr int ld_e(int E) {
  return ep_of<T>(E) + 16 / (int)sizeof(typename Cfg<T>::S);
}
// Logits [kVT][ld_lg]: the selection's reads fall on distinct banks.
template <typename T>
__host__ __device__ constexpr int ld_lg() {
  return Cfg<T>::BT + 32 / (kThreads / Cfg<T>::BT);
}
template <typename T>
__host__ __device__ constexpr size_t smem_bytes(int E) {
  using S = typename Cfg<T>::S;
  const size_t tab = (size_t)kVT * ld_e<T>(E) * sizeof(S);
  const size_t pj = (size_t)Cfg<T>::BT * ld_e<T>(E) * sizeof(S);
  const size_t lg = (size_t)kVT * ld_lg<T>() * sizeof(float);
  return tab + (pj > lg ? pj : lg);  // proj's sub-tile and the logits share memory
}

// ---- staging ----

// Table rows [v0, v0 + kVT) as S, rows >= V and columns >= E zero.
__device__ __forceinline__ void stage_table(__nv_bfloat16* tab, const __nv_bfloat16* table,
                                            int V, int E, int v0) {
  const int cpr = ep_of<__nv_bfloat16>(E) / 8, ld = ld_e<__nv_bfloat16>(E);
  for (int i = threadIdx.x; i < kVT * cpr; i += kThreads) {
    const int r = i / cpr, c = (i % cpr) * 8, v = v0 + r;
    const bool in = v < V && c < E;  // E % 8 == 0
    cp_async16(tab + r * ld + c, in ? table + (long)v * E + c : table, in ? 16 : 0);
  }
}
__device__ __forceinline__ void stage_table(float* tab, const float* table, int V, int E,
                                            int v0) {
  const int cpr = ep_of<float>(E) / 4, ld = ld_e<float>(E);
  for (int i = threadIdx.x; i < kVT * cpr; i += kThreads) {
    const int r = i / cpr, c = (i % cpr) * 4, v = v0 + r;
    const bool in = v < V && c < E;
    cp_async16(tab + r * ld + c, in ? table + (long)v * E + c : table, in ? 16 : 0);
  }
}
// Synchronous staging loads go in batches of kBatch a thread, all in flight
// before the first is used.
constexpr int kBatch = 8;

// int8: 8 values a thread, widened to bf16 (exact) and stored as 16 bytes
__device__ __forceinline__ void stage_table(__nv_bfloat16* tab, const int8_t* table, int V,
                                            int E, int v0) {
  const int cpr = ep_of<int8_t>(E) / 8, ld = ld_e<int8_t>(E), total = kVT * cpr;
  for (int i0 = threadIdx.x; i0 < total; i0 += kThreads * kBatch) {
    uint2 raw[kBatch];
#pragma unroll
    for (int p = 0; p < kBatch; ++p) {
      const int i = i0 + p * kThreads, r = i / cpr, c = (i % cpr) * 8, v = v0 + r;
      raw[p] = make_uint2(0u, 0u);
      if (i < total && v < V && c < E)
        raw[p] = __ldg(reinterpret_cast<const uint2*>(table + (long)v * E + c));
    }
#pragma unroll
    for (int p = 0; p < kBatch; ++p) {
      const int i = i0 + p * kThreads, r = i / cpr, c = (i % cpr) * 8;
      if (i >= total) break;
      float f[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) f[j] = table_elem(table, raw[p], j);
      *reinterpret_cast<uint4*>(tab + r * ld + c) = pack(f);
    }
  }
}

// proj rows [m0, m0 + BT) rounded to S, rows >= M and columns >= E zero.
template <typename T>
__device__ __forceinline__ void stage_proj(typename Cfg<T>::S* pj, const float* proj, int M,
                                           int E, int m0) {
  using S = typename Cfg<T>::S;
  constexpr int W = Vec<S>::W;
  const int cpr = ep_of<T>(E) / W, ld = ld_e<T>(E), total = Cfg<T>::BT * cpr;
  for (int i0 = threadIdx.x; i0 < total; i0 += kThreads * kBatch) {
    float4 u[kBatch][W / 4];
#pragma unroll
    for (int p = 0; p < kBatch; ++p) {
      const int i = i0 + p * kThreads, r = i / cpr, c = (i % cpr) * W, row = m0 + r;
#pragma unroll
      for (int j = 0; j < W / 4; ++j) {
        u[p][j] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (i < total && row < M && c + 4 * j < E)
          u[p][j] = __ldg(reinterpret_cast<const float4*>(proj + (long)row * E + c + 4 * j));
      }
    }
#pragma unroll
    for (int p = 0; p < kBatch; ++p) {
      const int i = i0 + p * kThreads, r = i / cpr, c = (i % cpr) * W;
      if (i >= total) break;
      float f[W];
#pragma unroll
      for (int j = 0; j < W / 4; ++j) {
        f[4 * j] = u[p][j].x;
        f[4 * j + 1] = u[p][j].y;
        f[4 * j + 2] = u[p][j].z;
        f[4 * j + 3] = u[p][j].w;
      }
      *reinterpret_cast<uint4*>(pj + r * ld + c) = pack(f);
    }
  }
}

// ---- the sub-tile's logits into lg[kVT][ld_lg] ----

// bf16 operands (bf16 and int8 tables): warp w takes vocab rows [32 (w % 4),
// + 32) x batch rows [32 (w / 4), + 32) of the sub-tile, 2 x 4 fragments
// (each A fragment read by two warps and each B fragment by four, against
// one and eight for 16-row warp strips: a fifth less shared-memory traffic).
template <typename T>
__device__ __forceinline__ void tile_logits(const __nv_bfloat16* tab, const __nv_bfloat16* pj,
                                            float* lg, const float* bias, const float* scale,
                                            int V, int E, int v0) {
  static_assert(Cfg<T>::BT == 64, "warps tile 128 vocab x 64 batch rows as 4 x 2");
  constexpr int LDL = ld_lg<T>();
  const int ld = ld_e<T>(E), ep = ep_of<T>(E);
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int vr = 32 * (warp % 4), br = 32 * (warp / 4);
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  const __nv_bfloat16* a_base = tab + (vr + (lane & 15)) * ld + (lane >> 4) * 8;
  // B from proj's [n][k] rows: matrices (n 0-7, k 0-7), (n 0-7, k 8-15),
  // (n 8-15, k 0-7), (n 8-15, k 8-15) of a fragment pair
  const __nv_bfloat16* b_base =
      pj + (br + (lane & 7) + ((lane >> 4) << 3)) * ld + ((lane >> 3) & 1) * 8;
  // the epilogue's bias and scale, loaded before the product hides them
  float sc[2][2], bi[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int v = v0 + vr + 16 * i + lane / 4 + 8 * h;
      sc[i][h] = scale != nullptr && v < V ? scale[v] : 1.f;
      bi[i][h] = v < V ? bias[v] : 0.f;
    }
  // the fragments of step kk + 16 load while step kk multiplies
  using Frags = uint32_t[2][4];
  Frags a0, b0, a1, b1;
  auto load = [&](Frags& a, Frags& b, int kk) {
#pragma unroll
    for (int i = 0; i < 2; ++i) ldmatrix_x4(a[i], a_base + 16 * i * ld + kk);
#pragma unroll
    for (int j = 0; j < 2; ++j) ldmatrix_x4(b[j], b_base + 16 * j * ld + kk);
  };
  auto product = [&](const Frags& a, const Frags& b) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        mma_bf16(acc[i][2 * j], a[i], b[j][0], b[j][1]);
        mma_bf16(acc[i][2 * j + 1], a[i], b[j][2], b[j][3]);
      }
  };
  load(a0, b0, 0);
  for (int kk = 0; kk < ep; kk += 32) {  // ep is a multiple of 16
    if (kk + 16 < ep) load(a1, b1, kk + 16);
    product(a0, b0);
    if (kk + 16 >= ep) break;
    if (kk + 32 < ep) load(a0, b0, kk + 32);
    product(a1, b1);
  }
  __syncthreads();  // every warp is done with proj, which lg overwrites
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = vr + 16 * i + lane / 4 + 8 * h, v = v0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float l[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float s = acc[i][j][2 * h + e];
          l[e] = v < V ? __fadd_rn(scale != nullptr ? __fmul_rn(s, sc[i][h]) : s, bi[i][h])
                       : -INFINITY;
        }
        *reinterpret_cast<float2*>(lg + r * LDL + br + 8 * j + 2 * (lane & 3)) =
            make_float2(l[0], l[1]);
      }
    }
}

// float32: thread (p = t / 8, q = t % 8) takes vocab rows p + 32 i and batch
// rows q + 8 j (i, j < 4), e in order.
template <typename T>
__device__ __forceinline__ void tile_logits(const float* tab, const float* pj, float* lg,
                                            const float* bias, const float* /*scale*/, int V,
                                            int E, int v0) {
  constexpr int LDL = ld_lg<T>();
  const int ld = ld_e<T>(E);
  const int p = threadIdx.x / 8, q = threadIdx.x % 8;
  float acc[4][4] = {};
  for (int e = 0; e < E; e += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = *reinterpret_cast<const float4*>(tab + (p + 32 * i) * ld + e);
      b[i] = *reinterpret_cast<const float4*>(pj + (q + 8 * i) * ld + e);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
      }
  }
  __syncthreads();  // every thread is done with proj, which lg overwrites
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = p + 32 * i, v = v0 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      lg[r * LDL + q + 8 * j] = v < V ? __fadd_rn(acc[i][j], bias[v]) : -INFINITY;
  }
}

// ---- a sorted top-KB list in registers ----

template <int KB>
struct TopList {
  float v[KB];
  int i[KB];
  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int j = 0; j < KB; ++j) {
      v[j] = -INFINITY;
      i[j] = INT_MAX;
    }
  }
  // Insert (cv, ci) if it ranks above the last entry; entries it displaces
  // move down one place, the last drops out.
  __device__ __forceinline__ bool offer(float cv, int ci) {
    if (!better(cv, ci, v[KB - 1], i[KB - 1])) return false;
#pragma unroll
    for (int j = 0; j < KB; ++j) {
      if (better(cv, ci, v[j], i[j])) {
        const float tv = v[j];
        const int ti = i[j];
        v[j] = cv;
        i[j] = ci;
        cv = tv;
        ci = ti;
      }
    }
    return true;
  }
  __device__ __forceinline__ void pop() {
#pragma unroll
    for (int j = 0; j + 1 < KB; ++j) {
      v[j] = v[j + 1];
      i[j] = i[j + 1];
    }
    v[KB - 1] = -INFINITY;
    i[KB - 1] = INT_MAX;
  }
};

// The best head over the G lanes of an aligned lane group (xor butterfly),
// returned to each of them.
template <int G>
__device__ __forceinline__ void group_best(float& bv, int& bi) {
#pragma unroll
  for (int off = 1; off < G; off <<= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
    if (better(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
    }
  }
}
template <int G>
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = 1; off < G; off <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
template <int G>
__device__ __forceinline__ float group_min(float x) {
#pragma unroll
  for (int off = 1; off < G; off <<= 1) x = fminf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
template <int G>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = 1; off < G; off <<= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int KB>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? 1 : 2)
    topk_tile(const float* __restrict__ proj,   // [M, E] f32
              const T* __restrict__ table,      // [V, E]
              const float* __restrict__ bias,   // [V]
              const float* __restrict__ scale,  // [V] or null
              int M, int V, int E, int k,
              float* __restrict__ part_v,  // [M, nvt, k]
              int* __restrict__ part_i,    // [M, nvt, k]
              float* __restrict__ part_m,  // [M, nvt]
              float* __restrict__ part_s,  // [M, nvt]
              const int* __restrict__ skip) {
  if (pdl_enter(skip)) return;
  using S = typename Cfg<T>::S;
  constexpr int BT = Cfg<T>::BT, QT = kThreads / BT, LDL = ld_lg<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  S* tab = reinterpret_cast<S*>(smem);
  S* pj = tab + kVT * ld_e<T>(E);
  float* lg = reinterpret_cast<float*>(pj);
  const int nvt = gridDim.x, tile = blockIdx.x, v0 = tile * kVT;
  const int m_end = min(M, (int)(blockIdx.y + 1) * kMB);
  const int b = threadIdx.x / QT, q = threadIdx.x % QT;

  stage_table(tab, table, V, E, v0);
  cp_async_commit();
  for (int m0 = blockIdx.y * kMB; m0 < m_end; m0 += BT) {
    __syncthreads();  // the previous sub-tile's selection is done with lg
    stage_proj<T>(pj, proj, M, E, m0);
    cp_async_wait<0>();
    __syncthreads();
    tile_logits<T>(tab, pj, lg, bias, scale, V, E, v0);
    __syncthreads();

    // selection: batch row b, vocab rows q, q + QT, ... in ascending order,
    // all read first (their loads in flight together).
    constexpr int VPT = kVT / QT;
    static_assert(VPT <= 32, "one candidate bit a logit");
    float l[VPT];
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int r = q + QT * i;
      l[i] = v0 + r < V ? lg[r * LDL + b] : -INFINITY;
    }
    // Each thread's two largest logits, in two independent chains. The QT
    // threads' largest are QT distinct logits of the tile, so its QT-th
    // largest is at least their minimum; with the second largest, its
    // 2 QT-th largest is at least the minimum of those: a threshold below
    // which no logit can be among the tile's top k, for k <= 2 QT.
    float m1[2] = {-INFINITY, -INFINITY}, m2[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      m2[i & 1] = fmaxf(m2[i & 1], fminf(m1[i & 1], l[i]));
      m1[i & 1] = fmaxf(m1[i & 1], l[i]);
    }
    const float t1 = fmaxf(m1[0], m1[1]);
    const float t2 = fmaxf(fminf(m1[0], m1[1]), fmaxf(m2[0], m2[1]));
    const float mx = group_max<QT>(t1);
    const float tau = k <= QT ? group_min<QT>(t1) : k <= 2 * QT ? group_min<QT>(t2) : -INFINITY;
    // sum exp(l - max) in four chains, added in a fixed order; a bit for
    // each logit >= tau
    float se[4] = {0.f, 0.f, 0.f, 0.f};
    uint32_t cand = 0;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      se[i & 3] += __expf(l[i] - mx);  // -inf rows add 0
      if (v0 + q + QT * i < V && l[i] >= tau) cand |= 1u << i;
    }
    float s = (se[0] + se[1]) + (se[2] + se[3]);
    // the top-KB list of the candidates, in ascending order (a warp runs as
    // many rounds as its lane with the most candidates, not VPT)
    TopList<KB> top;
    top.clear();
    while (cand != 0) {
      const int r = q + QT * (__ffs(cand) - 1);
      cand &= cand - 1;
      top.offer(lg[r * LDL + b], v0 + r);
    }
    s = group_sum<QT>(s);
    const int row = m0 + b;
    const bool writes = q == 0 && row < M;
    const long base = (long)row * nvt + tile;
    for (int j = 0; j < k; ++j) {
      float bv = top.v[0];
      int bi = top.i[0];
      group_best<QT>(bv, bi);
      if (top.i[0] == bi) top.pop();
      if (writes) {
        part_v[base * k + j] = bv;
        part_i[base * k + j] = bi;
      }
    }
    if (writes) {
      part_m[base] = mx;
      part_s[base] = s;
    }
  }
}

constexpr int kMergeWarps = 8;
constexpr int kMergeTiles = 4;  // (max, sum) pairs a lane loads at once

template <int KB>
__global__ void __launch_bounds__(kMergeWarps * 32)
    topk_merge(const float* __restrict__ part_v, const int* __restrict__ part_i,
               const float* __restrict__ part_m, const float* __restrict__ part_s, int M,
               int nvt, int k, float* __restrict__ vals, int* __restrict__ ids,
               float* __restrict__ lse, const int* __restrict__ skip) {
  if (pdl_enter(skip)) return;
  const int row = blockIdx.x * kMergeWarps + threadIdx.x / 32, lane = threadIdx.x & 31;
  if (row >= M) return;  // a whole warp
  TopList<KB> top;
  top.clear();
  const float* cv = part_v + (long)row * nvt * k;
  const int* ci = part_i + (long)row * nvt * k;
#pragma unroll 4
  for (int c = lane; c < nvt * k; c += 32) top.offer(cv[c], ci[c]);
  for (int j = 0; j < k; ++j) {
    float bv = top.v[0];
    int bi = top.i[0];
    group_best<32>(bv, bi);
    if (top.i[0] == bi) top.pop();
    if (lane == 0) {
      vals[(long)row * k + j] = bv;
      ids[(long)row * k + j] = bi;
    }
  }
  // lse over the tiles' (max, sum) pairs, 32 x kMergeTiles tiles a round
  // (one round for V <= 16384), each round's loads in flight together
  const float* pm = part_m + (long)row * nvt;
  const float* ps = part_s + (long)row * nvt;
  float mx = -INFINITY, s = 0.f;
  for (int t0 = 0; t0 < nvt; t0 += 32 * kMergeTiles) {
    float tm[kMergeTiles], ts[kMergeTiles];
#pragma unroll
    for (int j = 0; j < kMergeTiles; ++j) {
      const int t = t0 + lane + 32 * j;
      tm[j] = t < nvt ? pm[t] : -INFINITY;
      ts[j] = t < nvt ? ps[t] : 0.f;
    }
    float rm = -INFINITY;
#pragma unroll
    for (int j = 0; j < kMergeTiles; ++j) rm = fmaxf(rm, tm[j]);
    const float nm = fmaxf(mx, group_max<32>(rm));
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < kMergeTiles; ++j) rs += ts[j] * __expf(tm[j] - nm);  // -inf adds 0
    s = s * __expf(mx - nm) + group_sum<32>(rs);
    mx = nm;
  }
  if (lane == 0) lse[row] = mx + logf(s);
}

// Calls f(std::integral_constant<int, KB>) for k rounded up to 4, 8, 16, 32.
template <class F>
static bool with_kb(int k, F&& f) {
  if (k <= 4) return f(std::integral_constant<int, 4>{});
  if (k <= 8) return f(std::integral_constant<int, 8>{});
  if (k <= 16) return f(std::integral_constant<int, 16>{});
  return f(std::integral_constant<int, 32>{});
}

template <typename T, int KB>
static bool launch(int M, int V, int E, int k, const float* proj, const void* table,
                   const float* bias, const float* scale, float* part_v, int* part_i,
                   float* part_m, float* part_s, float* vals, int* ids, float* lse,
                   const int* skip, bool pdl, cudaStream_t stream) {
  static const bool raised = raise_smem_limit(topk_tile<T, KB>);
  const size_t smem = smem_bytes<T>(E);
  if (!raised || smem > kMaxDynamicSmem) return false;
  const int nvt = (V + kVT - 1) / kVT;
  if (launch_k(pdl, topk_tile<T, KB>, dim3(nvt, (M + kMB - 1) / kMB), kThreads, smem, stream,
               proj, static_cast<const T*>(table), bias, scale, M, V, E, k, part_v, part_i,
               part_m, part_s, skip) != cudaSuccess)
    return true;  // reported by the caller
  launch_k(pdl, topk_merge<KB>, (M + kMergeWarps - 1) / kMergeWarps, kMergeWarps * 32, 0,
           stream, part_v, part_i, part_m, part_s, M, nvt, k, vals, ids, lse, skip);
  return true;
}

}  // namespace topk

int topk_head_vocab_tile() { return topk::kVT; }

bool topk_head_launch(int table_dtype, int M, int V, int E, int k, const float* proj,
                      const void* table, const float* bias, const float* scale, float* part_v,
                      int* part_i, float* part_m, float* part_s, float* vals, int* ids,
                      float* lse, const int* skip, bool pdl, cudaStream_t stream) {
  if (M < 1 || V < 1 || E < 8 || E % 8 != 0 || k < 1 || k > kMaxK || k > V ||
      (table_dtype == kI8) != (scale != nullptr))
    return false;
  return dispatch_table_dtype(table_dtype, [&](auto tag) {
    using T = TableT<decltype(tag)>;
    return topk::with_kb(k, [&](auto kb) {
      return topk::launch<T, decltype(kb)::value>(M, V, E, k, proj, table, bias, scale, part_v,
                                                  part_i, part_m, part_s, vals, ids, lse, skip,
                                                  pdl, stream);
    });
  });
}

}  // namespace capk

extern "C" {

// Vocab rows of one tile of capk_topk_head: the partial buffers hold
// ceil(V / tile) tiles per row.
int capk_topk_head_vocab_tile() { return capk::topk_head_vocab_tile(); }

// vals[M, k], ids[M, k]: the top k of proj[M, E] . table[V, E]^T (* scale[V])
// + bias[V] per row, sorted; lse[M]: the row's logsumexp. table_dtype and
// scale as for capk_vocab_argmax; E a multiple of 8. part_v / part_i hold
// M x nvt x k and part_m / part_s M x nvt elements, nvt = ceil(V /
// capk_topk_head_vocab_tile()). skip, if not null, is a device flag: both
// kernels return at once when it is set (the LSTM beam decode's early
// stop). Returns cudaGetLastError() (cudaErrorInvalidValue for operands the
// kernel does not take).
int capk_topk_head(int table_dtype, int M, int V, int E, int k, const float* proj,
                   const void* table, const float* bias, const float* scale,
                   float* part_v, int* part_i, float* part_m, float* part_s, float* vals,
                   int* ids, float* lse, const int* skip, cudaStream_t stream) {
  if (!capk::topk_head_launch(table_dtype, M, V, E, k, proj, table, bias, scale, part_v, part_i,
                              part_m, part_s, vals, ids, lse, skip, false, stream))
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
