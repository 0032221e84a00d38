// The whole transformer decode, greedy (kernel D) and beam search (kernel E),
// enqueued on one stream from one C call per decode; the wrapper captures
// that call once per decode shape in a CUDA graph and replays it
// (ops/kernels/fused_transformer.py).
//
// Replaces myimagecaptioningmodel_tpu/ops/pallas/fused_transformer.py::
// fused_greedy_decode (:1061) and ::fused_beam_decode (:1198), with their
// int8_stream and int8_kv modes. The TPU kernel is one program with a
// sequential grid over the T steps: it keeps the KV caches in VMEM and
// streams the layer weights and the image memory through DMA rings every
// step. An H100 SM has 227 KB of shared memory and the L2 50 MB, so here
// caches, weights and memory live in device memory, and a step is a chain of
// kernels, split where a product's output feeds the next product's whole
// contraction. Per layer and step:
//
//   qkv     LayerNorm(x) @ w_qkv + b; the epilogue writes q and appends k, v
//           to the cache at step t (before attention reads it);
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
// (vocab_head.cu; greedy) or kernel C's (topk_head.cu; beam, k = W), and
//   greedy_finish  early-stop bookkeeping and row t of the ids, or
//   beam_select    per image the top W of the W * W candidates (ties to the
//                  lowest flat index w * W + k), finished/length bookkeeping,
//                  words and back-pointers of step t;
//   beam_reorder   the caches' positions <= t gathered by source row into the
//                  second cache buffer (the host swaps the two each step);
// and the next word's embedding: its table row (<pad> -> 0) @ in_proj + b +
// pos[t + 1] into x (none after the last step: pos has max_positions rows).
// 37 kernels a greedy step at 4 layers (38 beam; 13 more beyond 16 rows,
// tf_layernorm's, design step 2). Early stop: greedy_finish
// / beam_select set a device flag once every row (beam) is done, and every
// later kernel reads it and returns at once.
//
// What bounds it on an H100: bytes (chip_smoke.bound_tf). Each step reads
// the layer weights (117 MB in bf16 at D = 1024, F = 4096, L = 4; 59 MB as
// int8), the table (6.4 MB), the image memory and the caches: 1.4 ms for a
// 35-step greedy decode at B = 8, ~40 us a step. The products have 8-512
// rows, below the card's ~295 bf16 operations per byte. Per step that is 29
// products of 2-8 MB each, 0.6-2.5 us of bytes apiece: less than one
// kernel's ramp-up and tail. So the design attacks the gaps between kernels
// as much as the bytes inside them:
//
// 1. One CUDA graph per decode shape. The kernel sequence of a decode is
//    fixed by its shape (early stop is the device flag; the cache swap is
//    fixed per step), so the wrapper captures this file's C call once and
//    replays it; the host's ~1,300 enqueues become one graph launch.
// 2. One weight-streaming product (tf_stream, stream_product.cuh, which
//    kernel B's products share) for bf16 activations with bf16
//    or int8 weights, at every row count (1-512). The weight is the 16-row
//    side of mma.sync m16n8k16 (output columns x K, fragments by
//    ldmatrix.trans from the row-major [K, N] slab) and the batch rows its
//    8-wide side, so 8 rows need no padding and a block takes up to 128
//    rows against one weight slab (512 rows read each slab 4 times, from L2
//    after the first). A block owns 64 output columns and a K range; slabs
//    of [32 k, 64 columns] (128-byte row segments in bf16, 64 in int8) and
//    the matching activation rows arrive by 16-byte cp.async through a ring
//    of 16 stages (up to 16 rows), 6 or 4; when the ring holds the block's
//    whole K range (every product up to 16 rows) the block waits once and
//    multiplies without a barrier a stage. int8 slabs are copied raw and
//    each fragment is widened to bf16 (exact) as it is formed. K is split across blocks until a product has
//    >= 128 of them (so the N = 1024 and N = 256 products fill the 132 SMs
//    too). The splits of a column tile are one thread block cluster (at most
//    8 blocks): each split stores its float32 partial sums straight into the
//    shared memory of the block that finalizes their row, one slot per
//    (split, warp group); after one cluster barrier that block sums its
//    rows' slots in split order and runs the epilogue: one rounding of the
//    float32 sum to T, the rounded int8 scale, the rounded bias, then the
//    mode (q|k|v into q and the caches, residual add, GELU, store, float32
//    store, embedding + position). No workspace, no counter, no atomic: a
//    decode is deterministic.
//    LayerNorm, up to 16 rows: the per-row statistics pass, fused into the
//    epilogue of the product that last wrote x. Every writer of x (the
//    residual products and the embedding) also writes, per row and 64-column
//    tile, the tile's mean and sum of squared deviations; a LayerNorm
//    product merges a row's D / 64 pairs (a warp per row: the mean of the
//    means, then the squared deviations plus 64 (mean_t - mean)^2), stages
//    the raw float32 x slices through its ring and normalizes them to bf16
//    as each fragment is formed. No extra kernel at the serving batch.
//    Beyond 16 rows, a normalized bf16 copy of x, written once a sublayer by
//    tf_layernorm (a warp per row, two passes), and a plain-rows product: at
//    32-512 rows every one of a product's 128+ blocks normalizing its rows
//    again cost more (measured: at 128 rows the qkv product took 27-36 us
//    that way, 14 with the copy) than the 13 extra kernels a step.
//    float32 keeps the FMA product of fused_step.cu's kind (tf_dense: a
//    warp owns a 16-byte column vector, 2-8 warps split K, the batch rows
//    staged once per block, LayerNorm statistics from x in the block): a
//    dispatch by compute dtype, since the tensor cores take no float32.
// 3. Programmatic dependent launch on every kernel of the step up to 16
//    rows (launch_k, common.cuh; beyond, it measured slower: decode()). A
//    product issues its weight slabs (and its epilogue's bias, scale and
//    position) before griddep_wait(): the weights do not depend on the
//    kernel before it, so they stream in under that kernel.
//    Nothing is read from a predecessor's outputs or written before the
//    wait; each kernel lets its dependents launch once its inputs are in
//    (the products: once their activation rows are requested). The
//    early-stop flag is read before the wait (a 1 is final: it only goes
//    0 -> 1 in a decode) and again after it. The products' blocks take
//    45-100 KB of shared memory, so that the next kernel's fit beside them.
// 4. E's head is kernel C's tile and merge kernels, as D's is kernel A's.
// The attentions, greedy_finish, beam_select and beam_reorder are as
// before, each launched with programmatic dependent launch.
//
// What is left (PERF.md): at 8 rows a product takes ~5.5 us on the
// decode's critical path against 0.6-2.5 us of bytes (the wait's release,
// the activation rows' L2 round trip, the cluster barrier, the epilogue);
// the attentions take a third of a B = 8 decode.
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
// per output channel; the epilogue multiplies the rounded product by the
// scale rounded to T, in T, before the bias: (x @ w_q) * s + b as
// layers.dense does. Half the bytes of the bf16 streams are read. The
// cross-attention memory may be int8 with a float32 scale per (layer, K|V,
// channel) (greedy only): the attention multiplies the query by K's scale
// (float, then rounded to T) and the float context by V's before its one
// rounding.
//
// Shapes: the bf16 path takes D, F and E in multiples of 64 (whole column
// tiles and K ranges) and D <= 1024 beyond 16 rows (tf_layernorm); others
// return cudaErrorInvalidValue.
#include "stream_product.cuh"
#include "topk_head.cuh"
#include "vocab_head.cuh"

namespace capk {

constexpr int kMaxBeam = 8;  // fused_transformer.py's BEAM_MAX: W * W <= 64 candidates
constexpr float kNegInf = -1e9f;
constexpr int kAttnThreads = 128;
constexpr int kTailThreads = 256;

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

// ---- products (TfDense and the epilogue: stream_product.cuh) ---------------------

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

// ---- float32: the FMA product ----

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
  if (pdl_enter(p.skip)) return;
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
    epilogue<T>(p, sum, row, col, N, p.bias[col], p.w_scale ? p.w_scale[col] : 1.f,
                p.e_mode == kEEmbed ? p.pos[col] : 0.f,
                p.e_mode == kEResidual ? static_cast<const float*>(p.out)[(long)row * N + col]
                                       : 0.f);
  }
}

template <typename WT, int MT>
static bool launch_fma_tile(const TfDense& p, int M, int N, int K, bool pdl,
                            cudaStream_t stream) {
  constexpr int CV = TfTile<MT>::CV, KS = TfTile<MT>::KS;
  static const bool raised = raise_smem_limit(tf_dense<float, WT, MT, CV, KS>);
  const size_t smem = (size_t)MT * K * sizeof(float);
  if (!raised || smem > kMaxDynamicSmem || N % Vec<float>::W != 0) return false;
  const int cols = CV * Vec<float>::W;
  return launch_k(pdl, tf_dense<float, WT, MT, CV, KS>,
                  dim3((N + cols - 1) / cols, (M + MT - 1) / MT), CV * KS * 32, smem, stream, p,
                  M, N, K) == cudaSuccess;
}

template <typename WT>
static bool launch_fma(const TfDense& p, int M, int N, int K, bool pdl, cudaStream_t stream) {
  if (M > 8 && (size_t)16 * K * sizeof(float) <= kMaxDynamicSmem)
    return launch_fma_tile<WT, 16>(p, M, N, K, pdl, stream);
  return launch_fma_tile<WT, 8>(p, M, N, K, pdl, stream);
}

// ---- bf16 and int8 weight streams: the weight-streaming product ----
// (stream_product.cuh), and what D and E add to it: x's statistics for a
// product called on its own, the LayerNorm rows beyond wsp::kLnRows rows

namespace wsp {

// x's tile statistics, as the x-writing epilogues leave them, for a product
// called on its own (capk_stream_product): a warp per (row, 64-column tile).
__global__ void __launch_bounds__(256) tile_stats(const float* __restrict__ x, int M, int D,
                                                  float2* __restrict__ stats) {
  const int row = blockIdx.y * 8 + threadIdx.x / 32, lane = threadIdx.x & 31;
  if (row >= M) return;
  const float2 v = *reinterpret_cast<const float2*>(x + (long)row * D + blockIdx.x * kNT +
                                                    2 * lane);
  tile_row_stats(v.x, v.y, stats + (long)blockIdx.x * M + row, lane);
}

// The LayerNorm rows of the products with more than kLnRows rows: x [M, D]
// float32 -> xn bf16, a warp per row (mean, then the squared deviations,
// float32), the row's loads in flight together.
constexpr int kLnMaxChunks = 8;  // float4 chunks a lane: D <= 1024
__global__ void __launch_bounds__(256)
    tf_layernorm(const float* __restrict__ x, const float* __restrict__ g,
                 const float* __restrict__ b, bf* __restrict__ xn, int M, int D,
                 const int* __restrict__ skip) {
  if (pdl_enter(skip)) return;
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x & 31;
  if (row >= M) return;
  const float* xr = x + (long)row * D;
  float4 v[kLnMaxChunks];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kLnMaxChunks; ++i) {
    const int k = 4 * (lane + 32 * i);
    v[i] = k < D ? *reinterpret_cast<const float4*>(xr + k) : make_float4(0.f, 0.f, 0.f, 0.f);
    s += (v[i].x + v[i].y) + (v[i].z + v[i].w);
  }
  const float mean = warp_sum(s) / D;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < kLnMaxChunks; ++i) {
    if (4 * (lane + 32 * i) >= D) continue;
    const float d0 = v[i].x - mean, d1 = v[i].y - mean, d2 = v[i].z - mean, d3 = v[i].w - mean;
    q = fmaf(d0, d0, fmaf(d1, d1, fmaf(d2, d2, fmaf(d3, d3, q))));
  }
  const float rs = rsqrtf(warp_sum(q) / D + kLnEps);
#pragma unroll
  for (int i = 0; i < kLnMaxChunks; ++i) {
    const int k = 4 * (lane + 32 * i);
    if (k >= D) continue;
    const float4 gg = __ldg(reinterpret_cast<const float4*>(g + k));
    const float4 bb = __ldg(reinterpret_cast<const float4*>(b + k));
    *reinterpret_cast<uint2*>(xn + (long)row * D + k) =
        make_uint2(pack_bf16x2((v[i].x - mean) * rs * gg.x + bb.x,
                               (v[i].y - mean) * rs * gg.y + bb.y),
                   pack_bf16x2((v[i].z - mean) * rs * gg.z + bb.z,
                               (v[i].w - mean) * rs * gg.w + bb.w));
  }
}

static bool launch_layernorm(const float* x, const float* g, const float* b, bf* xn, int M,
                             int D, const int* skip, bool pdl, cudaStream_t stream) {
  if (D % 4 || D > 128 * kLnMaxChunks) return false;
  return launch_k(pdl, tf_layernorm, (M + 7) / 8, 256, 0, stream, x, g, b, xn, M, D, skip) ==
         cudaSuccess;
}

}  // namespace wsp

// A product of the decode: T weights, or int8 weights when the product has
// their scales; float32 on the FMA product, bf16 on the weight-streaming one.
template <typename T>
static bool launch_tf_dense(const TfDense& p, int M, int N, int K, bool pdl,
                            cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value)
    return p.w_scale != nullptr ? launch_fma<int8_t>(p, M, N, K, pdl, stream)
                                : launch_fma<float>(p, M, N, K, pdl, stream);
  else
    return p.w_scale != nullptr ? wsp::launch<int8_t>(p, M, N, K, pdl, stream)
                                : wsp::launch<bf>(p, M, N, K, pdl, stream);
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
  if (pdl_enter(skip)) return;
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
                             int heads, const int* skip, bool pdl, cudaStream_t stream,
                             const float* k_scale = nullptr, const float* v_scale = nullptr) {
  const int dh = D / heads;
  const size_t smem = ((size_t)dh + n_slots) * sizeof(float);
  if (smem > 48 * 1024) return false;
  return launch_k(pdl, tf_attention<T, KT>, dim3(n_grp, heads), kAttnThreads, smem, stream,
                  static_cast<const T*>(q), static_cast<const KT*>(k), static_cast<const KT*>(v),
                  k_scale, v_scale, static_cast<T*>(out), n_grp, per_grp, ld_grp, n_slots, D,
                  dh, skip) == cudaSuccess;
}

// ---- the step's tail -------------------------------------------------------------

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
  if (pdl_enter(flag)) return;
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
  if (pdl_enter(skip)) return;
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
  float* stats;  // x's row statistics for the bf16 products, [D / 64][B] float2
  void* xn;      // LayerNorm rows, bf16 [B, D], beyond wsp::kLnRows rows
};
static_assert(sizeof(TfPtrs) == 50 * sizeof(void*), "one pointer per field");

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
  const int B = n_img * (beam ? W : 1);
  const long cache_layer = (long)B * S * D;
  const bool w8 = a[kWInt8] != 0, m8 = a[kMemInt8] != 0;
  // Programmatic dependent launch on every kernel up to 16 rows: there it
  // hides the kernels' ramps and streams each product's weights in under the
  // kernel before it; beyond, the dependents' early blocks and prefetches
  // slowed the decodes (measured on an H100: bf16 32 rows +2%, 512 rows
  // +11%, float32 32 rows +7%; PERF.md §6)
  const bool pdl = B <= wsp::kLnRows;
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
    d.stats = reinterpret_cast<float2*>(p.stats);
    return d;
  };
  // A LayerNorm product's rows: normalized by the product itself, or beyond
  // wsp::kLnRows rows (bf16) by tf_layernorm into xn first (one more kernel)
  const bool xn_rows = std::is_same<T, __nv_bfloat16>::value && B > wsp::kLnRows;
  const int ln_mode = xn_rows ? kARows : kALayerNorm;
  const void* ln_in = xn_rows ? p.xn : p.x;
  auto norm = [&](const float* g, const float* b) {
    return wsp::launch_layernorm(p.x, g, b, static_cast<bf*>(p.xn), B, D, p.flag, pdl, stream);
  };
  auto embed = [&](int t) {  // x = table[word] @ in_proj + b + pos[t]
    TfDense d = dense(kAGather, p.table, nullptr, nullptr, p.in_proj_w, p.in_proj_b, kEEmbed,
                      p.x, D, E);
    d.pos = p.pos + (long)t * D;
    return launch_tf_dense<T>(d, B, D, E, pdl, stream);
  };

  TF_LAUNCH(embed(0));
  for (int t = 0; t < S; ++t) {
    for (int l = 0; l < L; ++l) {
      const float* ln = p.ln + (long)l * 6 * D;
      const float* bm = p.b_misc + (long)l * 4 * D;
      const float* sm = scale(p.s_misc, (long)l * 3 * D);
      if (xn_rows) TF_LAUNCH(norm(ln, ln + D));
      TfDense qkv = dense(ln_mode, ln_in, ln, ln + D, at(p.w_qkv, (long)l * D * 3 * D, w8),
                          p.b_qkv + (long)l * 3 * D, kEQkv, p.q, 3 * D, D,
                          scale(p.s_qkv, (long)l * 3 * D));
      qkv.kc = kc + l * cache_layer;
      qkv.vc = vc + l * cache_layer;
      qkv.t = t;
      qkv.n_steps = S;
      TF_LAUNCH(launch_tf_dense<T>(qkv, B, 3 * D, D, pdl, stream));
      TF_LAUNCH(launch_attention<T>(p.q, kc + l * cache_layer, vc + l * cache_layer, p.ctx, B,
                                    1, (long)S * D, t + 1, D, heads, p.flag, pdl, stream));
      TF_LAUNCH(launch_tf_dense<T>(dense(kARows, p.ctx, nullptr, nullptr,
                                         at(p.w_o, (long)l * D * D, w8), bm, kEResidual, p.x, D,
                                         D, sm),
                                   B, D, D, pdl, stream));
      if (xn_rows) TF_LAUNCH(norm(ln + 2 * D, ln + 3 * D));
      TF_LAUNCH(launch_tf_dense<T>(dense(ln_mode, ln_in, ln + 2 * D, ln + 3 * D,
                                         at(p.w_xq, (long)l * D * D, w8), bm + D, kEStore, p.q,
                                         D, D, w8 ? sm + D : nullptr),
                                   B, D, D, pdl, stream));
      const long mk = (long)(2 * l) * n_img * M * D, mv = mk + (long)n_img * M * D;
      TF_LAUNCH(m8 ? launch_attention<T, int8_t>(p.q, at(p.mem_kv, mk, true),
                                                 at(p.mem_kv, mv, true), p.ctx, n_img,
                                                 beam ? W : 1, (long)M * D, M, D, heads, p.flag,
                                                 pdl, stream, p.mem_scale + (long)(2 * l) * D,
                                                 p.mem_scale + (long)(2 * l + 1) * D)
                   : launch_attention<T>(p.q, at(p.mem_kv, mk, false), at(p.mem_kv, mv, false),
                                         p.ctx, n_img, beam ? W : 1, (long)M * D, M, D, heads,
                                         p.flag, pdl, stream));
      TF_LAUNCH(launch_tf_dense<T>(dense(kARows, p.ctx, nullptr, nullptr,
                                         at(p.w_xo, (long)l * D * D, w8), bm + 2 * D, kEResidual,
                                         p.x, D, D, w8 ? sm + 2 * D : nullptr),
                                   B, D, D, pdl, stream));
      if (xn_rows) TF_LAUNCH(norm(ln + 4 * D, ln + 5 * D));
      TF_LAUNCH(launch_tf_dense<T>(dense(ln_mode, ln_in, ln + 4 * D, ln + 5 * D,
                                         at(p.w_fc1, (long)l * D * F, w8), p.b_fc1 + (long)l * F,
                                         kEGelu, p.hmid, F, D, scale(p.s_fc1, (long)l * F)),
                                   B, F, D, pdl, stream));
      TF_LAUNCH(launch_tf_dense<T>(dense(kARows, p.hmid, nullptr, nullptr,
                                         at(p.w_fc2, (long)l * F * D, w8), bm + 3 * D,
                                         kEResidual, p.x, D, F, scale(p.s_fc2, (long)l * D)),
                                   B, D, F, pdl, stream));
    }
    if (xn_rows) TF_LAUNCH(norm(p.lnf, p.lnf + D));
    TF_LAUNCH(launch_tf_dense<T>(dense(ln_mode, ln_in, p.lnf, p.lnf + D, p.out_proj_w,
                                       p.out_proj_b, kEStoreF32, p.proj, E, D),
                                 B, E, D, pdl, stream));
    if (!beam) {
      // kernel A's tile kernel and merge (vocab_head.cu): two launches
      TF_LAUNCH(vocab_argmax_launch(a[kDtype], B, V, E, p.proj, p.table, p.out_bias, nullptr,
                                    p.part_v, p.part_i, vocab_argmax_width(V), p.word, p.flag,
                                    pdl, stream));
      TF_LAUNCH(true);
      TF_LAUNCH(launch_k(pdl, greedy_finish, 1, kGreedyFinishThreads, 0, stream, p.word, p.done, p.flag,
                         p.words_tm + (long)t * B, B, pad, stop, early) == cudaSuccess);
    } else {
      // kernel C's tile kernel and merge (topk_head.cu): two launches
      TF_LAUNCH(topk_head_launch(a[kDtype], B, V, E, W, p.proj, p.table, p.out_bias, nullptr,
                                 p.part_v, p.part_i, p.part_m, p.part_s, p.vals, p.ids_k, p.lse,
                                 p.flag, pdl, stream));
      TF_LAUNCH(true);
      TF_LAUNCH(launch_k(pdl, beam_select, 1, kTailThreads, 0, stream, p.vals, p.ids_k, p.lse,
                         p.scores, p.done, p.lens, p.word, p.src_rows, p.words_tm + (long)t * B,
                         p.srcs_tm + (long)t * B, p.flag, n_img, W, pad, stop,
                         early) == cudaSuccess);
      if (t + 1 < S) {
        TF_LAUNCH(launch_k(pdl, beam_reorder<T>, dim3(B, L, 2), kTailThreads, 0, stream, kc, vc,
                           kc_alt, vc_alt, p.src_rows, B, S, D, t + 1, p.flag) == cudaSuccess);
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
  // the weight-streaming products take whole 64-column tiles
  if (a[kDtype] == kBF16 && (D % wsp::kNT || a[kFfn] % wsp::kNT || a[kEmb] % wsp::kNT))
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
// null, and the scales unless kWInt8 / kMemInt8; stats holds 2 (D / 64) B
// floats, for bf16). words_tm [T, B] must hold <pad>,
// word [B] the start id, done [B] and flag [1] zeros. *launches gets the
// number of kernels enqueued. Returns a CUDA error code
// (cudaErrorInvalidValue for shapes the kernels do not take).
int capk_fused_greedy_decode(const int* args, void* const* ptrs, cudaStream_t stream,
                             int* launches) {
  return capk::decode_entry(args, ptrs, stream, launches, false);
}

// One beam-search decode (kernel E), 1 <= kBeam <= 8 slot-major rows per
// image, float memory (kMemInt8 = 0). As capk_fused_greedy_decode, and:
// srcs_tm [T, B] must hold the identity back-pointers (row r: r / n_img),
// scores [B] 0 for slot 0 and -1e9 for the others, lens [B] zeros. done [B]
// holds the finished flags.
int capk_fused_beam_decode(const int* args, void* const* ptrs, cudaStream_t stream,
                           int* launches) {
  return capk::decode_entry(args, ptrs, stream, launches, true);
}

// One weight-streaming product on its own (bf16 activations, bf16 or int8
// weights), as a decode runs it. args: M, N, K, a_mode, e_mode, w_int8, pad,
// t, n_steps, pdl (launched with programmatic dependent launch, as in a
// decode: calls in a row overlap as a decode's products do); ptrs: a, ln_g,
// ln_b, word, w, w_scale, bias, out, kc, vc, pos, stats, xn (capk::TfDense's
// fields; a LayerNorm product reads x's statistics [K / 64][M] from stats,
// as capk_tile_stats leaves them, and beyond wsp::kLnRows rows normalizes x
// into xn [M, K] bf16 first, as a decode does; kEResidual and kEEmbed write
// the statistics, [N / 64][M]). Returns a CUDA error code.
int capk_stream_product(const int* args, void* const* ptrs, cudaStream_t stream) {
  capk::TfDense d{};
  d.a_mode = args[3];
  d.e_mode = args[4];
  d.pad = args[6];
  d.t = args[7];
  d.n_steps = args[8];
  d.a = ptrs[0];
  d.ln_g = static_cast<const float*>(ptrs[1]);
  d.ln_b = static_cast<const float*>(ptrs[2]);
  d.word = static_cast<const int*>(ptrs[3]);
  d.w = ptrs[4];
  d.w_scale = static_cast<const float*>(ptrs[5]);
  d.bias = static_cast<const float*>(ptrs[6]);
  d.out = ptrs[7];
  d.kc = ptrs[8];
  d.vc = ptrs[9];
  d.pos = static_cast<const float*>(ptrs[10]);
  d.stats = static_cast<float2*>(ptrs[11]);
  if ((args[5] != 0) != (d.w_scale != nullptr) || d.a_mode < capk::kARows ||
      d.a_mode > capk::kAGather || d.e_mode < capk::kEStore || d.e_mode > capk::kEEmbed)
    return (int)cudaErrorInvalidValue;
  if (d.a_mode == capk::kALayerNorm && args[0] > capk::wsp::kLnRows) {
    __nv_bfloat16* xn = static_cast<__nv_bfloat16*>(ptrs[12]);
    if (xn == nullptr || !capk::wsp::launch_layernorm(static_cast<const float*>(d.a), d.ln_g,
                                                      d.ln_b, xn, args[0], args[2], nullptr,
                                                      args[9] != 0, stream))
      return (int)cudaErrorInvalidValue;
    d.a_mode = capk::kARows;
    d.a = xn;
  }
  const bool pdl = args[9] != 0;
  const bool ok = args[5] ? capk::wsp::launch<int8_t>(d, args[0], args[1], args[2], pdl, stream)
                          : capk::wsp::launch<__nv_bfloat16>(d, args[0], args[1], args[2], pdl,
                                                             stream);
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// The K splits (a cluster's blocks) of a weight-streaming product of M rows,
// [K, N] weights: split s takes the 32-row K chunks [s c / S, (s + 1) c / S),
// c = K / 32.
int capk_stream_product_splits(int M, int N, int K) { return capk::wsp::plan(M, N, K).splits; }

// x [M, D]'s per-row statistics of each 64-column tile into stats [D / 64][M]
// (mean, sum of squared deviations), as a decode's x-writing products leave
// them. Returns a CUDA error code.
int capk_tile_stats(const float* x, int M, int D, float* stats, cudaStream_t stream) {
  if (M < 1 || D < capk::wsp::kNT || D % capk::wsp::kNT) return (int)cudaErrorInvalidValue;
  capk::wsp::tile_stats<<<dim3(D / capk::wsp::kNT, (M + 7) / 8), 256, 0, stream>>>(
      x, M, D, reinterpret_cast<float2*>(stats));
  return (int)cudaGetLastError();
}

}  // extern "C"
