// The whole transformer decode, greedy (kernel D) and beam search (kernel E),
// enqueued on one stream from one C call per decode.
//
// Replaces myimagecaptioningmodel_tpu/ops/pallas/fused_transformer.py::
// fused_greedy_decode and ::fused_beam_decode. The TPU
// kernel is one program with a sequential grid over the T steps: it keeps the
// KV caches (73 MB at full width) in VMEM and streams the 117 MB of layer
// weights and the image memory through DMA rings every step. An H100 SM has
// 227 KB of shared memory and the L2 50 MB, so here caches, weights and
// memory all live in device memory, and a step is a sequence of kernels,
// split where a product's output feeds the next product's whole contraction.
// Per layer and step:
//
//   qkv     LayerNorm(x) @ w_qkv + b: the LayerNorm is applied while the
//           block stages its rows; the epilogue writes q and appends k, v to
//           the cache at step t (before attention reads it);
//   attn    self-attention, one block per (row, head) over slots <= t;
//   wo      ctx @ w_o + b, added to the float32 residual x;
//   xq      LayerNorm(x) @ w_xq + b;
//   xattn   cross-attention over the M memory slots, one block per (image,
//           head) for all the image's rows (beam rows are slot-major, so
//           row r's image is r % n_img and the memory is never repeated);
//   xo      ctx @ w_xo + b, added to x;
//   fc1     GELU(LayerNorm(x) @ w_fc1 + b) (tanh form);
//   fc2     hmid @ w_fc2 + b, added to x.
//
// Then the head: LayerNorm(x) @ out_proj + b into proj [B, E] (float32
// holding compute-dtype values), kernel A's tile and merge kernels
// (vocab_head.cu, greedy) or the top-k partial and combine kernels of
// vocab_block.cuh (beam, k = W), and
//   greedy_finish  early-stop bookkeeping and row t of the ids, or
//   beam_select    per image the top W of the W * W candidates (ties to the
//                  lowest flat index w * W + k), finished/length bookkeeping,
//                  words and back-pointers of step t;
//   beam_reorder   the caches' positions <= t gathered by source row into the
//                  second cache buffer (the host swaps the two each step);
// and the next word's embedding: its table row (<pad> -> 0) @ in_proj + b +
// pos[t + 1] into x (none after the last step: pos has max_positions rows).
//
// Early stop: greedy_finish / beam_select set a device flag once every row
// (beam) is done; every kernel reads it first and returns at once, the TPU
// kernel's skipped grid steps without a host round trip. 37 kernels a greedy
// step at 4 layers (38 beam), all enqueued before the first runs.
//
// Layout, for Hopper: caches [L, B, T, D], so one row's history is
// contiguous (attention reads slot s of head h as 128 adjacent values; the
// reorder moves (t + 1) D contiguous values per row and layer); memory
// [L, 2, n_img, M, D] as precompute gives it, one image's slots contiguous.
//
// Numerics, as models/transformer.py: a product rounds its operands to the
// compute dtype T, accumulates in float32, rounds the result to T and adds the
// bias rounded to T; LayerNorm (eps 1e-6, biased variance), softmax, the
// residual stream, q . k and the logits in float32; softmax weights rounded to
// T before the weighted sum.
//
// int8 (the TPU kernel's int8_stream and int8_kv): the four layer streams
// (w_qkv, w_o | w_xq | w_xo, w_fc1, w_fc2) may be int8 with a float32 scale
// per output channel. A product converts each weight to float when it loads
// it (exact: |w| <= 127; the tensor-core product stages it as bf16, also
// exact) and its epilogue multiplies the rounded product by the scale rounded
// to T, in T, before the bias: (x @ w_q) * s + b as layers.dense does. Half the
// bytes of the float streams are read. The cross-attention memory may be
// int8 with a float32 scale per (layer, K|V, channel) (greedy only): the
// attention multiplies the query by K's scale (float, then rounded to T) and
// the float context by V's before its one rounding.
//
// What bounds it on an H100: bytes. Each step reads the layer weights (117 MB
// in bf16 at D = 1024, F = 4096, L = 4), the table (6.4 MB), the image memory
// (0.82 MB an image) and the caches; the products have 8-512 rows, below the
// card's ~295 bf16 operations per byte. Below 32 rows, and in float32, the
// products are the split-K FMA products of fused_step.cu (a warp owns a
// 16-byte column vector, 2-8 warps split K, the batch rows staged once per
// block in shared memory), every weight byte read once per 8- or 16-row
// tile; from 32 rows on (B >= 32 greedy, beam search on 8+ images) bf16
// products run on tensor cores (tf_dense_tc, with the measurements behind
// the threshold). At 8 rows a decode is bound by its ~1,300 short kernels'
// latencies, not by bytes: a CUDA graph or programmatic dependent launch
// over them, a pipelined (TMA / wgmma) product and a persistent schedule
// are later work.
#include <mma.h>

#include "vocab_block.cuh"
#include "vocab_head.cuh"

namespace capk {

constexpr int kMaxBeam = 8;  // fused_transformer.py's BEAM_MAX: W * W <= 64 candidates
constexpr float kNegInf = -1e9f;
constexpr float kLnEps = 1e-6f;
constexpr int kAttnThreads = 128;
constexpr int kTailThreads = 256;

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

__device__ __forceinline__ bool skipped(const int* skip) { return skip != nullptr && *skip; }

// int8 weights and memory as float: exact. Byte b of a little-endian word,
// sign-extended.
__device__ __forceinline__ float ld(const int8_t* p, long i) { return (float)p[i]; }
__device__ __forceinline__ float i8_at(uint32_t word, int b) {
  return (float)((int32_t)(word << (24 - 8 * b)) >> 24);
}
// A lane's int8 weight vector, as many elements as a 16-byte vector of the
// compute dtype (8 bytes for bf16, 4 for float32), as float.
__device__ __forceinline__ void load_i8(const int8_t* p, float (&f)[8]) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    f[b] = i8_at(u.x, b);
    f[4 + b] = i8_at(u.y, b);
  }
}
__device__ __forceinline__ void load_i8(const int8_t* p, float (&f)[4]) {
  const uint32_t u = __ldg(reinterpret_cast<const unsigned int*>(p));
#pragma unroll
  for (int b = 0; b < 4; ++b) f[b] = i8_at(u, b);
}

// ---- products ------------------------------------------------------------------

enum AMode : int { kARows = 0, kALayerNorm = 1, kAGather = 2 };
enum EMode : int { kEStore = 0, kEStoreF32 = 1, kEResidual = 2, kEQkv = 3, kEGelu = 4, kEEmbed = 5 };

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
  void* kc;   // kEQkv: this layer's caches [M, n_steps, N / 3], position t written
  void* vc;
  int t, n_steps;
  const float* pos;  // kEEmbed: [N]
  const int* skip;
};

// Per-row mean and 1 / std of the block's rows [m0, m0 + rows) of the float32
// x (kALayerNorm only; two passes, a warp per row), then __syncthreads().
__device__ __forceinline__ void ln_stats(const TfDense& p, int m0, int rows, int M, int K,
                                         float* mu, float* rstd) {
  if (p.a_mode != kALayerNorm) return;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  for (int m = warp; m < rows; m += blockDim.x / 32) {
    const float* x = static_cast<const float*>(p.a) + (long)(m0 + m) * K;
    float s = 0.f, q = 0.f;
    if (m0 + m < M)
      for (int k = lane; k < K; k += 32) s += x[k];
    const float mean = warp_sum(s) / K;
    if (m0 + m < M)
      for (int k = lane; k < K; k += 32) {
        const float d = x[k] - mean;
        q = fmaf(d, d, q);
      }
    const float var = warp_sum(q) / K;
    if (lane == 0) {
      mu[m] = mean;
      rstd[m] = rsqrtf(var + kLnEps);
    }
  }
  __syncthreads();
}

// Element (row, k) of the product's A operand, as float; mu / rstd hold the
// block's rows from m0.
template <typename T>
__device__ __forceinline__ float a_value(const TfDense& p, int row, int k, int K, int m0,
                                         const float* mu, const float* rstd) {
  if (p.a_mode == kALayerNorm)
    return (static_cast<const float*>(p.a)[(long)row * K + k] - mu[row - m0]) *
               rstd[row - m0] * p.ln_g[k] +
           p.ln_b[k];
  const T* a = static_cast<const T*>(p.a);
  if (p.a_mode == kAGather) {
    const int wd = p.word[row];
    return wd == p.pad ? 0.f : ld(a, (long)wd * K + k);
  }
  return ld(a, (long)row * K + k);
}

// The epilogue of one output element from its float32 sum (an int8 weight's
// scale applied in T before the bias).
template <typename T>
__device__ __forceinline__ void epilogue(const TfDense& p, float sum, int row, int col, int N) {
  float y = to_dt<T>(sum);
  if (p.w_scale != nullptr) y = to_dt<T>(y * to_dt<T>(p.w_scale[col]));
  y = to_dt<T>(y + to_dt<T>(p.bias[col]));
  const long o = (long)row * N + col;
  switch (p.e_mode) {
    case kEStore:
      st(static_cast<T*>(p.out) + o, y);
      break;
    case kEStoreF32:
      static_cast<float*>(p.out)[o] = y;
      break;
    case kEResidual:
      static_cast<float*>(p.out)[o] += y;
      break;
    case kEGelu:
      st(static_cast<T*>(p.out) + o, gelu_tanh(y));
      break;
    case kEEmbed:
      static_cast<float*>(p.out)[o] = y + p.pos[col];
      break;
    default: {  // kEQkv
      const int D = N / 3, which = col / D, c = col % D;
      T* dst = which == 0 ? static_cast<T*>(p.out) + (long)row * D + c
                          : static_cast<T*>(which == 1 ? p.kc : p.vc) +
                                ((long)row * p.n_steps + p.t) * D + c;
      st(dst, y);
    }
  }
}

// MT batch rows per block; CV column vectors with K split over KS warps each
// (as fused_step.cu's dense: at MT = 8 one vector and 8 splits, at MT = 16
// four vectors and 2 splits).
template <int MT>
struct TfTile {
  static constexpr int CV = MT <= 8 ? 1 : 4, KS = MT <= 8 ? 8 : 2;
};

// One warp's share of the product with one column vector of the weight (as
// common.cuh's colvec_product, for T or int8 weights).
template <typename T, typename WT, int MT, int KS>
__device__ __forceinline__ void tf_colvec(const T* __restrict__ At, const WT* __restrict__ w,
                                          long ldw, int K, int split, int lane,
                                          float (&acc)[MT * Vec<T>::W]) {
  constexpr int W = Vec<T>::W;
#pragma unroll 4
  for (int k = 32 * split + lane; k < K; k += 32 * KS) {
    float wf[W], a[MT];
    if constexpr (std::is_same<WT, int8_t>::value)
      load_i8(w + (long)k * ldw, wf);
    else
      load_vec<T>(w + (long)k * ldw, wf);
    load_row<T, MT>(At + (long)k * MT, a);
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < W; ++j) acc[m * W + j] = fmaf(a[m], wf[j], acc[m * W + j]);
  }
}

template <typename T, typename WT, int MT, int CV, int KS>
__global__ void __launch_bounds__(CV * KS * 32) tf_dense(TfDense p, int M, int N, int K) {
  if (skipped(p.skip)) return;
  constexpr int W = Vec<T>::W, NVAL = MT * W, PER = NVAL / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  T* At = reinterpret_cast<T*>(smem);  // [K][MT]
  __shared__ float part[KS][CV][NVAL];
  __shared__ float mu[MT], rstd[MT];
  const int m0 = blockIdx.y * MT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  ln_stats(p, m0, MT, M, K, mu, rstd);
  const float *mu_p = mu, *rstd_p = rstd;
  stage_rows<T, MT>(At, m0, M, K, [&](int row, int k) -> float {
    return a_value<T>(p, row, k, K, m0, mu_p, rstd_p);
  });
  __syncthreads();

  // warp (v, s): column vector v of the block, K split s
  const int v = warp % CV, s = warp / CV;
  const int col0 = (blockIdx.x * CV + v) * W;
  float acc[NVAL];
#pragma unroll
  for (int i = 0; i < NVAL; ++i) acc[i] = 0.f;
  if (col0 < N)
    tf_colvec<T, WT, MT, KS>(At, static_cast<const WT*>(p.w) + col0, N, K, s, lane, acc);
  warp_reduce_scatter<NVAL>(acc, lane);
#pragma unroll
  for (int i = 0; i < PER; ++i) part[s][v][PER * lane + i] = acc[i];
  __syncthreads();

  for (int e = threadIdx.x; e < CV * NVAL; e += blockDim.x) {
    const int ev = e / NVAL, et = e % NVAL;
    const int row = m0 + et / W, col = (blockIdx.x * CV + ev) * W + et % W;
    if (row >= M || col >= N) continue;
    float sum = 0.f;
#pragma unroll
    for (int x = 0; x < KS; ++x) sum += part[x][ev][et];
    epilogue<T>(p, sum, row, col, N);
  }
}

// bf16 products on tensor cores (nvcuda::wmma 16x16x16, float accumulators).
// A block takes a [32, 16] output tile and its 4 warps split K in quarters:
// each warp loads kTcUnroll k-steps of its tiles at a time, a 16-byte vector
// per lane and all in flight together, into its own shared-memory tiles and
// takes its fragments from there (B: the row-major [K, N] weight; A: the
// activation rows [M, K], which the wrapper pads to whole 32-row tiles with
// zeros, or for a LayerNorm or gather prologue the block's 32 rows prepared
// once in shared memory, a warp per row with the row in registers); the four
// partial tiles meet in shared memory for the epilogue, added in a fixed
// order. Takes K a multiple of 64 (and at most 1024 under a LayerNorm) and N
// a multiple of 16; other shapes take the FMA product. Every weight byte is
// read from device memory once per product, and once per 32-row tile from
// L2. Used from kTcMinRows rows: in a full-width bf16 decode on an H100 its
// products took 13.1 ms against the FMA products' 11.3 at 8 rows, 17.5
// against 22.5 at 32 and 35.6 against 52 at 128. Fragments loaded straight
// from device memory (4-byte loads) had taken 17.8, 24.5 and 37.5; a
// [32, 64] tile staged per 32-deep chunk without the K split 101 ms for the
// whole decode at 32 rows and 97 at 128. At 512 rows each block re-reads
// (and re-normalizes) its 32 rows once per 16 columns; a wider tile there is
// later work.
constexpr int kTcM = 32, kTcN = 16, kTcWarps = 4, kTcUnroll = 4, kTcMaxLnK = 1024;
constexpr int kTcMinRows = 32;

__device__ __forceinline__ uint2 pack4(float a, float b, float c, float d) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b), hi = __floats2bfloat162_rn(c, d);
  return make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                    *reinterpret_cast<const uint32_t*>(&hi));
}

// The block's rows [m0, m0 + kTcM) of a LayerNorm or gather A operand into
// As [kTcM][lda] as bf16; rows >= M are zero.
__device__ __forceinline__ void tc_stage_rows(const TfDense& p, __nv_bfloat16* As, int lda,
                                              int m0, int M, int K) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  constexpr int kChunks = kTcMaxLnK / 128;  // float4 chunks per lane
  for (int r = warp; r < kTcM; r += kTcWarps) {
    const int row = m0 + r;
    __nv_bfloat16* dst = As + (long)r * lda;
    if (row >= M) {
      for (int k = 8 * lane; k < K; k += 256)
        *reinterpret_cast<uint4*>(dst + k) = make_uint4(0u, 0u, 0u, 0u);
      continue;
    }
    if (p.a_mode == kAGather) {
      const int wd = p.word[row];
      const __nv_bfloat16* src = static_cast<const __nv_bfloat16*>(p.a) + (long)wd * K;
      for (int k = 8 * lane; k < K; k += 256)
        *reinterpret_cast<uint4*>(dst + k) =
            wd == p.pad ? make_uint4(0u, 0u, 0u, 0u)
                        : __ldg(reinterpret_cast<const uint4*>(src + k));
      continue;
    }
    const float* x = static_cast<const float*>(p.a) + (long)row * K;  // kALayerNorm
    float4 v[kChunks];
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int k = 4 * (32 * c + lane);
      v[c] = k < K ? __ldg(reinterpret_cast<const float4*>(x + k))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      s += (v[c].x + v[c].y) + (v[c].z + v[c].w);
    }
    const float mean = warp_sum(s) / K;
    float q = 0.f;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      if (4 * (32 * c + lane) >= K) continue;
      const float d0 = v[c].x - mean, d1 = v[c].y - mean, d2 = v[c].z - mean, d3 = v[c].w - mean;
      q = fmaf(d0, d0, q);
      q = fmaf(d1, d1, q);
      q = fmaf(d2, d2, q);
      q = fmaf(d3, d3, q);
    }
    const float rstd = rsqrtf(warp_sum(q) / K + kLnEps);
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int k = 4 * (32 * c + lane);
      if (k >= K) continue;
      const float* g = p.ln_g + k;
      const float* b = p.ln_b + k;
      *reinterpret_cast<uint2*>(dst + k) =
          pack4((v[c].x - mean) * rstd * g[0] + b[0], (v[c].y - mean) * rstd * g[1] + b[1],
                (v[c].z - mean) * rstd * g[2] + b[2], (v[c].w - mean) * rstd * g[3] + b[3]);
    }
  }
}

// A lane's 8 weights of a 16 x 16 tile row: 16 bytes of bf16, or 8 of int8
// converted to bf16 (exact) when they are stored.
template <typename WT>
struct TcRaw;
template <>
struct TcRaw<__nv_bfloat16> {
  using type = uint4;
  static __device__ __forceinline__ uint4 load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ uint4 to_bf16(const uint4& u) { return u; }
};
template <>
struct TcRaw<int8_t> {
  using type = uint2;
  static __device__ __forceinline__ uint2 load(const int8_t* p) {
    return __ldg(reinterpret_cast<const uint2*>(p));
  }
  static __device__ __forceinline__ uint4 to_bf16(const uint2& u) {
    float f[8];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      f[b] = i8_at(u.x, b);
      f[4 + b] = i8_at(u.y, b);
    }
    return pack(f);
  }
};

template <typename WT>
__global__ void __launch_bounds__(kTcWarps * 32) tf_dense_tc(TfDense p, int M, int N, int K) {
  if (skipped(p.skip)) return;
  using namespace nvcuda;
  using bf = __nv_bfloat16;
  extern __shared__ __align__(32) unsigned char tc_smem[];  // As [kTcM][K + 8] (prologue modes)
  __shared__ __align__(32) bf Bw[kTcWarps][kTcUnroll][16 * kTcN];  // a warp's weight tiles
  __shared__ __align__(32) bf Aw[kTcWarps][kTcUnroll][kTcM * 16];  // its row tiles (kARows)
  __shared__ __align__(32) float Cs[kTcWarps][kTcM * kTcN];
  const int m0 = blockIdx.y * kTcM, n0 = blockIdx.x * kTcN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const bool rows = p.a_mode == kARows;
  const bf* A = static_cast<const bf*>(p.a) + (long)m0 * K;
  const bf* As = reinterpret_cast<const bf*>(tc_smem);
  const int lda = K + 8;
  if (!rows) {
    tc_stage_rows(p, reinterpret_cast<bf*>(tc_smem), lda, m0, M, K);
    __syncthreads();
  }
  // lane's 16-byte share of a 16 x 16 tile: row lane / 2, columns (lane % 2) * 8
  const int tr = lane / 2, tc = (lane % 2) * 8;
  const WT* w = static_cast<const WT*>(p.w) + n0 + tc;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);
  const int kq = K / kTcWarps, k_hi = (warp + 1) * kq;
  for (int k0 = warp * kq; k0 < k_hi; k0 += 16 * kTcUnroll) {
    typename TcRaw<WT>::type bv[kTcUnroll];
    uint4 av[kTcUnroll][2];
#pragma unroll
    for (int u = 0; u < kTcUnroll; ++u) {  // every load of the kTcUnroll k-steps in flight
      const int k = k0 + 16 * u;
      if (k >= k_hi) continue;
      bv[u] = TcRaw<WT>::load(w + (long)(k + tr) * N);
      if (rows) {
        av[u][0] = __ldg(reinterpret_cast<const uint4*>(A + (long)tr * K + k + tc));
        av[u][1] = __ldg(reinterpret_cast<const uint4*>(A + (long)(tr + 16) * K + k + tc));
      }
    }
#pragma unroll
    for (int u = 0; u < kTcUnroll; ++u) {
      if (k0 + 16 * u >= k_hi) continue;
      *reinterpret_cast<uint4*>(&Bw[warp][u][tr * kTcN + tc]) = TcRaw<WT>::to_bf16(bv[u]);
      if (rows) {
        *reinterpret_cast<uint4*>(&Aw[warp][u][tr * 16 + tc]) = av[u][0];
        *reinterpret_cast<uint4*>(&Aw[warp][u][(tr + 16) * 16 + tc]) = av[u][1];
      }
    }
    __syncwarp();
#pragma unroll
    for (int u = 0; u < kTcUnroll; ++u) {
      const int k = k0 + 16 * u;
      if (k >= k_hi) continue;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf, wmma::row_major> a0, a1;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf, wmma::row_major> b;
      wmma::load_matrix_sync(b, Bw[warp][u], kTcN);
      if (rows) {
        wmma::load_matrix_sync(a0, Aw[warp][u], 16);
        wmma::load_matrix_sync(a1, Aw[warp][u] + 16 * 16, 16);
      } else {
        wmma::load_matrix_sync(a0, As + k, lda);
        wmma::load_matrix_sync(a1, As + 16L * lda + k, lda);
      }
      wmma::mma_sync(acc[0], a0, b, acc[0]);
      wmma::mma_sync(acc[1], a1, b, acc[1]);
    }
    __syncwarp();  // the tiles are read before the next k-steps overwrite them
  }
  wmma::store_matrix_sync(Cs[warp], acc[0], kTcN, wmma::mem_row_major);
  wmma::store_matrix_sync(Cs[warp] + 16 * kTcN, acc[1], kTcN, wmma::mem_row_major);
  __syncthreads();
  for (int e = threadIdx.x; e < kTcM * kTcN; e += blockDim.x) {
    const int row = m0 + e / kTcN, col = n0 + e % kTcN;
    if (row < M && col < N)
      epilogue<bf>(p, ((Cs[0][e] + Cs[1][e]) + Cs[2][e]) + Cs[3][e], row, col, N);
  }
}

static bool tc_takes(const TfDense& p, int N, int K) {
  return K % (16 * kTcWarps) == 0 && N % 16 == 0 && (p.a_mode != kALayerNorm || K <= kTcMaxLnK);
}

template <typename WT>
static bool launch_tf_dense_tc(const TfDense& p, int M, int N, int K, cudaStream_t stream) {
  // the block's static tiles take 32 KB, so its dynamic limit stays below
  // raise_smem_limit's 200 KB (static and dynamic share the 227 KB)
  constexpr size_t kTcMaxDynamic = 160 * 1024;
  static const bool raised =
      cudaFuncSetAttribute(tf_dense_tc<WT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kTcMaxDynamic) == cudaSuccess;
  const size_t smem = p.a_mode == kARows ? 0 : (size_t)kTcM * (K + 8) * 2;
  if (!raised || smem > kTcMaxDynamic) return false;
  tf_dense_tc<WT><<<dim3(N / kTcN, (M + kTcM - 1) / kTcM), kTcWarps * 32, smem, stream>>>(
      p, M, N, K);
  return true;
}

template <typename T, typename WT, int MT>
static bool launch_tf_tile(const TfDense& p, int M, int N, int K, cudaStream_t stream) {
  constexpr int CV = TfTile<MT>::CV, KS = TfTile<MT>::KS;
  static const bool raised = raise_smem_limit(tf_dense<T, WT, MT, CV, KS>);
  const size_t smem = (size_t)MT * K * sizeof(T);
  if (!raised || smem > kMaxDynamicSmem || N % Vec<T>::W != 0) return false;
  const int cols = CV * Vec<T>::W;
  dim3 grid((N + cols - 1) / cols, (M + MT - 1) / MT);
  tf_dense<T, WT, MT, CV, KS><<<grid, CV * KS * 32, smem, stream>>>(p, M, N, K);
  return true;
}

template <typename T, typename WT>
static bool launch_tf_dense_w(const TfDense& p, int M, int N, int K, cudaStream_t stream) {
  if (std::is_same<T, __nv_bfloat16>::value && M >= kTcMinRows && tc_takes(p, N, K))
    return launch_tf_dense_tc<typename std::conditional<std::is_same<WT, int8_t>::value, int8_t,
                                                        __nv_bfloat16>::type>(p, M, N, K, stream);
  if (M > 8 && (size_t)16 * K * sizeof(T) <= kMaxDynamicSmem)
    return launch_tf_tile<T, WT, 16>(p, M, N, K, stream);
  return launch_tf_tile<T, WT, 8>(p, M, N, K, stream);
}

// T weights, or int8 weights when the product has their scales
template <typename T>
static bool launch_tf_dense(const TfDense& p, int M, int N, int K, cudaStream_t stream) {
  return p.w_scale != nullptr ? launch_tf_dense_w<T, int8_t>(p, M, N, K, stream)
                              : launch_tf_dense_w<T, T>(p, M, N, K, stream);
}

// ---- attention -------------------------------------------------------------------

// Block (g, h) attends for rows g + n_grp * j, j < per_grp (self-attention:
// one row per group; cross-attention: the W slot-major rows of image g),
// head h, over n_slots keys at k + g * ld_grp + s * D + h * dh:
//   out = round(sum_s round(softmax_s(q . k_s / sqrt(dh))) v_s).
// int8 keys and values (KT = int8_t) come with their scales [D]: the query is
// round(q * k_scale), and out = round(k_scale-free sum * v_scale).
template <typename T, typename KT>
__global__ void __launch_bounds__(kAttnThreads)
    tf_attention(const T* __restrict__ q,  // [B, D]
                 const KT* __restrict__ k, const KT* __restrict__ v,
                 const float* __restrict__ k_scale, const float* __restrict__ v_scale,
                 T* __restrict__ out,  // [B, D]
                 int n_grp, int per_grp, long ld_grp, int n_slots, int D, int dh,
                 const int* __restrict__ skip) {
  if (skipped(skip)) return;
  extern __shared__ float sm[];
  float* qh = sm;      // [dh]
  float* w = sm + dh;  // [n_slots]
  const int g = blockIdx.x, h = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31, nw = blockDim.x / 32;
  const long kb = (long)g * ld_grp + (long)h * dh;
  const float scale = sqrtf((float)dh);
  for (int j = 0; j < per_grp; ++j) {
    const long row = g + (long)n_grp * j;
    __syncthreads();  // the previous row's readers of qh and w are done
    for (int d = threadIdx.x; d < dh; d += blockDim.x) {
      const float qv = ld(q, row * D + h * dh + d);
      qh[d] = k_scale != nullptr ? to_dt<T>(qv * k_scale[h * dh + d]) : qv;
    }
    __syncthreads();
    for (int s = warp; s < n_slots; s += nw) {
      float acc = 0.f;
      for (int d = lane; d < dh; d += 32) acc = fmaf(qh[d], ld(k, kb + (long)s * D + d), acc);
      acc = warp_sum(acc);
      if (lane == 0) w[s] = acc / scale;
    }
    __syncthreads();
    float mx = -INFINITY, den = 0.f;
    for (int s = 0; s < n_slots; ++s) mx = fmaxf(mx, w[s]);
    for (int s = 0; s < n_slots; ++s) den += expf(w[s] - mx);
    __syncthreads();  // every thread has read the scores
    for (int s = threadIdx.x; s < n_slots; s += blockDim.x) w[s] = to_dt<T>(expf(w[s] - mx) / den);
    __syncthreads();
    for (int d = threadIdx.x; d < dh; d += blockDim.x) {
      float acc = 0.f;
#pragma unroll 8
      for (int s = 0; s < n_slots; ++s) acc = fmaf(w[s], ld(v, kb + (long)s * D + d), acc);
      st(out + row * D + h * dh + d, v_scale != nullptr ? acc * v_scale[h * dh + d] : acc);
    }
  }
}

template <typename T, typename KT = T>
static bool launch_attention(const void* q, const void* k, const void* v, void* out,
                             int n_grp, int per_grp, long ld_grp, int n_slots, int D,
                             int heads, const int* skip, cudaStream_t stream,
                             const float* k_scale = nullptr, const float* v_scale = nullptr) {
  const int dh = D / heads;
  const size_t smem = ((size_t)dh + n_slots) * sizeof(float);
  if (smem > 48 * 1024) return false;
  tf_attention<T, KT><<<dim3(n_grp, heads), kAttnThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KT*>(k), static_cast<const KT*>(v), k_scale,
      v_scale, static_cast<T*>(out), n_grp, per_grp, ld_grp, n_slots, D, dh, skip);
  return true;
}

// ---- the step's tail -------------------------------------------------------------

// Greedy: done rows emit <pad>, a row is done once it has emitted <stop>, and
// the flag is set once every row is done (early stop only); ids row t.
__global__ void __launch_bounds__(kTailThreads)
    greedy_finish(int* __restrict__ word, int* __restrict__ done, int* __restrict__ flag,
                  int* __restrict__ ids_t, int B, int pad, int stop, int early) {
  if (*flag) return;
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

// Beam: per image (one warp each) the top W of the W * W candidates
// scores[src] + logp, logp = vals - lse of the source row's top W words, or
// the single zero-cost <pad> for a finished source; ties to the lowest flat
// index w * W + k. Lane j then writes new slot j: score, finished, length,
// word, source row, and step t's word and back-pointer.
__global__ void __launch_bounds__(kTailThreads)
    beam_select(const float* __restrict__ vals, const int* __restrict__ ids_k,  // [B, W]
                const float* __restrict__ lse,                                  // [B]
                float* __restrict__ scores, int* __restrict__ fin, int* __restrict__ lens,
                int* __restrict__ word, int* __restrict__ src_rows,
                int* __restrict__ words_t, int* __restrict__ srcs_t,  // step t's [B]
                int* __restrict__ flag, int n_img, int W, int pad, int stop, int early) {
  if (*flag) return;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int nc = W * W;
  for (int i = warp; i < n_img; i += blockDim.x / 32) {
    float cv[2];
    int cw[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {  // lane holds candidates lane and lane + 32
      const int c = lane + 32 * hh;
      cv[hh] = -INFINITY;
      cw[hh] = pad;
      if (c < nc) {
        const int w = c / W, kk = c % W, r = w * n_img + i;
        const bool f = fin[r] != 0;
        const float lp = f ? (kk == 0 ? 0.f : kNegInf) : vals[(long)r * W + kk] - lse[r];
        cv[hh] = scores[r] + lp;
        cw[hh] = f ? pad : ids_k[(long)r * W + kk];
      }
    }
    float sel_v = 0.f;
    int sel_c = 0, sel_w = pad;
    for (int j = 0; j < W; ++j) {
      float bv = cv[0];
      int bc = lane;
      if (better(cv[1], lane + 32, bv, bc)) {
        bv = cv[1];
        bc = lane + 32;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
        const int oc = __shfl_xor_sync(0xffffffffu, bc, off);
        if (better(ov, oc, bv, bc)) {
          bv = ov;
          bc = oc;
        }
      }
      const int hi = bc >> 5;
      const int wsel = __shfl_sync(0xffffffffu, hi ? cw[1] : cw[0], bc & 31);
      if (lane == (bc & 31)) cv[hi] = -INFINITY;  // taken
      if (lane == j) {
        sel_v = bv;
        sel_c = bc;
        sel_w = wsel;
      }
    }
    int src = 0, prev_f = 0, plen = 0;
    if (lane < W) {  // read every source state before any slot is written
      src = sel_c / W;
      prev_f = fin[src * n_img + i];
      plen = lens[src * n_img + i];
    }
    __syncwarp();
    if (lane < W) {
      const int r = lane * n_img + i;
      scores[r] = sel_v;
      fin[r] = prev_f | (sel_w == stop);
      lens[r] = plen + (prev_f ? 0 : 1);
      word[r] = sel_w;
      src_rows[r] = src * n_img + i;
      words_t[r] = sel_w;
      srcs_t[r] = src;
    }
  }
  if (early) {
    __syncthreads();
    int live = 0;
    for (int r = threadIdx.x; r < n_img * W; r += blockDim.x) live |= fin[r] == 0;
    if (!__syncthreads_or(live) && threadIdx.x == 0) *flag = 1;
  }
}

// Caches [L, B, n_steps, D]: row r of layer l, positions [0, n_pos), from row
// src_rows[r] of the source buffer (grid (B, L, 2): k and v).
template <typename T>
__global__ void __launch_bounds__(kTailThreads)
    beam_reorder(const T* __restrict__ kc, const T* __restrict__ vc, T* __restrict__ kc_out,
                 T* __restrict__ vc_out, const int* __restrict__ src_rows, int B, int n_steps,
                 int D, int n_pos, const int* __restrict__ skip) {
  if (skipped(skip)) return;
  const int r = blockIdx.x, l = blockIdx.y;
  const long row_len = (long)n_steps * D;
  const T* src = (blockIdx.z ? vc : kc) + ((long)l * B + src_rows[r]) * row_len;
  T* dst = (blockIdx.z ? vc_out : kc_out) + ((long)l * B + r) * row_len;
  const long n = (long)n_pos * D * sizeof(T) / 16;
  for (long i = threadIdx.x; i < n; i += blockDim.x)
    reinterpret_cast<uint4*>(dst)[i] = __ldg(reinterpret_cast<const uint4*>(src) + i);
}

// ---- one decode --------------------------------------------------------------------

// fused_transformer.py's _PTR_FIELDS then _WORK_FIELDS, in order
struct TfPtrs {
  const void *w_qkv, *w_o, *w_xq, *w_xo, *w_fc1, *w_fc2;
  const float *b_qkv, *b_misc, *b_fc1, *ln;
  const void *mem_kv, *table;
  const float* out_bias;
  const void* in_proj_w;
  const float *in_proj_b, *pos, *lnf;
  const void* out_proj_w;
  const float* out_proj_b;
  const float *s_qkv, *s_misc, *s_fc1, *s_fc2, *mem_scale;  // int8 only, else null
  float* x;
  void *q, *ctx, *hmid;
  float* proj;
  int* word;
  void *kc0, *vc0, *kc1, *vc1;
  float* part_v;
  int* part_i;
  float *part_m, *part_s, *vals;
  int* ids_k;
  float* lse;
  int *done, *flag;
  float* scores;
  int *lens, *src_rows, *words_tm, *srcs_tm;
};
static_assert(sizeof(TfPtrs) == 48 * sizeof(void*), "one pointer per field");

// fused_transformer.py's ints, in order
enum TfArg : int {
  kDtype, kLayers, kDim, kFfn, kSlots, kImages, kBeam, kVocab, kEmb, kSteps, kHeads,
  kStart, kPad, kStop, kEarly, kWInt8, kMemInt8, kNumArgs
};

template <typename T>
static int decode(const int* a, const TfPtrs& p, cudaStream_t stream, int* launches) {
  const int L = a[kLayers], D = a[kDim], F = a[kFfn], M = a[kSlots], n_img = a[kImages];
  const int W = a[kBeam], V = a[kVocab], E = a[kEmb], S = a[kSteps], heads = a[kHeads];
  const int pad = a[kPad], stop = a[kStop], early = a[kEarly];
  const bool beam = W > 0;
  const int B = n_img * (beam ? W : 1), MT = B <= 8 ? 8 : 16;
  const int nblk = (V + kVocabBlock - 1) / kVocabBlock;
  const long cache_layer = (long)B * S * D;
  const bool w8 = a[kWInt8] != 0, m8 = a[kMemInt8] != 0;
  // element `off` of a layer stream or of the memory, T or int8
  auto at = [](const void* base, long off, bool i8) -> const void* {
    return static_cast<const char*>(base) + off * (i8 ? 1 : (long)sizeof(T));
  };
  auto scale = [&](const float* s, long off) -> const float* { return w8 ? s + off : nullptr; };
  T *kc = static_cast<T*>(p.kc0), *vc = static_cast<T*>(p.vc0);
  T *kc_alt = static_cast<T*>(p.kc1), *vc_alt = static_cast<T*>(p.vc1);
  int n = 0;
  cudaError_t err;
#define TF_LAUNCH(...)                                               \
  do {                                                               \
    if (!(__VA_ARGS__)) return (int)cudaErrorInvalidValue;           \
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;  \
    ++n;                                                             \
  } while (0)
  auto dense = [&](int a_mode, const void* in, const float* g, const float* b, const void* w,
                   const float* bias, int e_mode, void* out, int N, int K,
                   const float* w_scale = nullptr) {
    TfDense d{};
    d.a_mode = a_mode;
    d.a = in;
    d.ln_g = g;
    d.ln_b = b;
    d.word = p.word;
    d.pad = pad;
    d.w = w;
    d.w_scale = w_scale;
    d.bias = bias;
    d.e_mode = e_mode;
    d.out = out;
    d.skip = p.flag;
    return d;
  };
  auto embed = [&](int t) {  // x = table[word] @ in_proj + b + pos[t]
    TfDense d = dense(kAGather, p.table, nullptr, nullptr, p.in_proj_w, p.in_proj_b, kEEmbed,
                      p.x, D, E);
    d.pos = p.pos + (long)t * D;
    return launch_tf_dense<T>(d, B, D, E, stream);
  };

  TF_LAUNCH(embed(0));
  for (int t = 0; t < S; ++t) {
    for (int l = 0; l < L; ++l) {
      const float* ln = p.ln + (long)l * 6 * D;
      const float* bm = p.b_misc + (long)l * 4 * D;
      const float* sm = scale(p.s_misc, (long)l * 3 * D);
      TfDense qkv = dense(kALayerNorm, p.x, ln, ln + D, at(p.w_qkv, (long)l * D * 3 * D, w8),
                          p.b_qkv + (long)l * 3 * D, kEQkv, p.q, 3 * D, D,
                          scale(p.s_qkv, (long)l * 3 * D));
      qkv.kc = kc + l * cache_layer;
      qkv.vc = vc + l * cache_layer;
      qkv.t = t;
      qkv.n_steps = S;
      TF_LAUNCH(launch_tf_dense<T>(qkv, B, 3 * D, D, stream));
      TF_LAUNCH(launch_attention<T>(p.q, kc + l * cache_layer, vc + l * cache_layer, p.ctx, B,
                                    1, (long)S * D, t + 1, D, heads, p.flag, stream));
      TF_LAUNCH(launch_tf_dense<T>(dense(kARows, p.ctx, nullptr, nullptr,
                                         at(p.w_o, (long)l * D * D, w8), bm, kEResidual, p.x, D,
                                         D, sm),
                                   B, D, D, stream));
      TF_LAUNCH(launch_tf_dense<T>(dense(kALayerNorm, p.x, ln + 2 * D, ln + 3 * D,
                                         at(p.w_xq, (long)l * D * D, w8), bm + D, kEStore, p.q,
                                         D, D, w8 ? sm + D : nullptr),
                                   B, D, D, stream));
      const long mk = (long)(2 * l) * n_img * M * D, mv = mk + (long)n_img * M * D;
      TF_LAUNCH(m8 ? launch_attention<T, int8_t>(p.q, at(p.mem_kv, mk, true),
                                                 at(p.mem_kv, mv, true), p.ctx, n_img,
                                                 beam ? W : 1, (long)M * D, M, D, heads, p.flag,
                                                 stream, p.mem_scale + (long)(2 * l) * D,
                                                 p.mem_scale + (long)(2 * l + 1) * D)
                   : launch_attention<T>(p.q, at(p.mem_kv, mk, false), at(p.mem_kv, mv, false),
                                         p.ctx, n_img, beam ? W : 1, (long)M * D, M, D, heads,
                                         p.flag, stream));
      TF_LAUNCH(launch_tf_dense<T>(dense(kARows, p.ctx, nullptr, nullptr,
                                         at(p.w_xo, (long)l * D * D, w8), bm + 2 * D, kEResidual,
                                         p.x, D, D, w8 ? sm + 2 * D : nullptr),
                                   B, D, D, stream));
      TF_LAUNCH(launch_tf_dense<T>(dense(kALayerNorm, p.x, ln + 4 * D, ln + 5 * D,
                                         at(p.w_fc1, (long)l * D * F, w8), p.b_fc1 + (long)l * F,
                                         kEGelu, p.hmid, F, D, scale(p.s_fc1, (long)l * F)),
                                   B, F, D, stream));
      TF_LAUNCH(launch_tf_dense<T>(dense(kARows, p.hmid, nullptr, nullptr,
                                         at(p.w_fc2, (long)l * F * D, w8), bm + 3 * D,
                                         kEResidual, p.x, D, F, scale(p.s_fc2, (long)l * D)),
                                   B, D, F, stream));
    }
    TF_LAUNCH(launch_tf_dense<T>(dense(kALayerNorm, p.x, p.lnf, p.lnf + D, p.out_proj_w,
                                       p.out_proj_b, kEStoreF32, p.proj, E, D),
                                 B, E, D, stream));
    if (!beam) {
      // kernel A's tile kernel and merge (vocab_head.cu): two launches
      TF_LAUNCH(vocab_argmax_launch(a[kDtype], B, V, E, p.proj, p.table, p.out_bias, nullptr,
                                    p.part_v, p.part_i, nblk, p.word, p.flag, stream));
      TF_LAUNCH(true);
      greedy_finish<<<1, kTailThreads, 0, stream>>>(p.word, p.done, p.flag,
                                                    p.words_tm + (long)t * B, B, pad, stop,
                                                    early);
      TF_LAUNCH(true);
    } else {
      TF_LAUNCH(MT == 8 ? launch_topk_partial<T, 8>(p.proj, p.table, p.out_bias, nullptr, W,
                                                    p.part_v, p.part_i, p.part_m, p.part_s, B,
                                                    V, E, p.flag, stream)
                        : launch_topk_partial<T, 16>(p.proj, p.table, p.out_bias, nullptr, W,
                                                     p.part_v, p.part_i, p.part_m, p.part_s, B,
                                                     V, E, p.flag, stream));
      topk_combine<<<B, kCombineThreads, 0, stream>>>(p.part_v, p.part_i, p.part_m, p.part_s,
                                                      nblk, W, p.vals, p.ids_k, p.lse, p.flag);
      TF_LAUNCH(true);
      beam_select<<<1, kTailThreads, 0, stream>>>(
          p.vals, p.ids_k, p.lse, p.scores, p.done, p.lens, p.word, p.src_rows,
          p.words_tm + (long)t * B, p.srcs_tm + (long)t * B, p.flag, n_img, W, pad, stop, early);
      TF_LAUNCH(true);
      if (t + 1 < S) {
        beam_reorder<T><<<dim3(B, L, 2), kTailThreads, 0, stream>>>(
            kc, vc, kc_alt, vc_alt, p.src_rows, B, S, D, t + 1, p.flag);
        TF_LAUNCH(true);
        T* tmp = kc;
        kc = kc_alt;
        kc_alt = tmp;
        tmp = vc;
        vc = vc_alt;
        vc_alt = tmp;
      }
    }
    if (t + 1 < S) TF_LAUNCH(embed(t + 1));
  }
#undef TF_LAUNCH
  *launches = n;
  return 0;
}

static int decode_entry(const int* a, void* const* ptrs, cudaStream_t stream, int* launches,
                        bool beam) {
  *launches = 0;
  const int D = a[kDim], heads = a[kHeads], W = a[kBeam];
  if (a[kLayers] < 1 || D < 8 || D % 8 || a[kEmb] % 8 || a[kFfn] % 8 || heads < 1 ||
      D % heads || a[kSlots] < 1 || a[kImages] < 1 || a[kSteps] < 1 || a[kVocab] < 1 ||
      (beam ? (W < 1 || W > kMaxBeam || W > a[kVocab]) : W != 0))
    return (int)cudaErrorInvalidValue;
  const TfPtrs& p = *reinterpret_cast<const TfPtrs*>(ptrs);
  // int8 streams need their scales; int8 memory (greedy only) its scales
  if ((a[kWInt8] && (!p.s_qkv || !p.s_misc || !p.s_fc1 || !p.s_fc2)) ||
      (a[kMemInt8] && (beam || !p.mem_scale)))
    return (int)cudaErrorInvalidValue;
  if (a[kDtype] == kBF16) return decode<__nv_bfloat16>(a, p, stream, launches);
  if (a[kDtype] == kF32) return decode<float>(a, p, stream, launches);
  return (int)cudaErrorInvalidValue;
}

}  // namespace capk

extern "C" {

// One greedy decode (kernel D) enqueued on `stream`. args: capk::TfArg's
// fields (kBeam = 0); ptrs: capk::TfPtrs's fields (the beam-only ones may be
// null, and the scales unless kWInt8 / kMemInt8). words_tm [T, B] must hold <pad>, word [B] the start id, done [B] and
// flag [1] zeros. *launches gets the number of kernels enqueued. Returns a
// CUDA error code (cudaErrorInvalidValue for shapes the kernels do not take).
int capk_fused_greedy_decode(const int* args, void* const* ptrs, cudaStream_t stream,
                             int* launches) {
  return capk::decode_entry(args, ptrs, stream, launches, false);
}

// One beam-search decode (kernel E), 1 <= kBeam <= 8 slot-major rows per
// image, float memory (kMemInt8 = 0). As capk_fused_greedy_decode, and: srcs_tm [T, B] must hold the
// identity back-pointers (row r: r / n_img), scores [B] 0 for slot 0 and
// -1e9 for the others, lens [B] zeros. done [B] holds the finished flags.
int capk_fused_beam_decode(const int* args, void* const* ptrs, cudaStream_t stream,
                           int* launches) {
  return capk::decode_entry(args, ptrs, stream, launches, true);
}

}  // extern "C"
