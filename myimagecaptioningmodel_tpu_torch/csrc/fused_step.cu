// One adaptive-attention LSTM decode step as six launches from one C call
// (plus the vocab argmax of vocab_head.cu).
//
// Replaces myimagecaptioningmodel_tpu/ops/pallas/fused_step.py::
// fused_decode_step (formula in that module's docstring). The TPU kernel is a
// single program that keeps about 90 MB of weights, image keys/values and
// vocab table resident in VMEM across all 35 steps. An H100 SM has 227 KB of
// shared memory, so here the step is split where a product's output feeds the
// next product's whole contraction:
//
//   gate       [word_emb ; h_prev] @ [w_word_cat ; w_hh_cat] + gxb, then the
//              LSTM cell and the sentinel in the epilogue. A block owns 8 (bf16)
//              or 4 (f32) hidden units j and all five column slices
//              {j, H+j, 2H+j, 3H+j, 4H+j}, 2-4 warps per slice, so the
//              epilogue needs nothing from other blocks. Writes h', c',
//              sentinel.
//   dense      act((A [+ A2]) @ W + b), K split over the warps of a block:
//              p_hid = tanh(h' Wp + bp); hid_emb and sent_key in one launch
//              (grid z = 2); out = tanh((ctx + p_hid) Wout + bout) with the
//              input add fused; proj = out Wproj + bproj.
//   attention  one 1024-thread block per batch row: the 49 image scores and the
//              sentinel score (a warp per slot), softmax and context, all in
//              float32 as the TPU kernel does; img_k and img_v are read in the
//              compute dtype.
//
// With the head that is 8 launches per step, about 280 per 35-step decode;
// the launch overhead at small batch is accepted here (a CUDA graph over the
// step loop is later work).
//
// What bounds it on an H100: per step the weights (about 21 MB in bf16: the
// [1280, 5120] gate matrix, four [1024, 1024], one [1024, 256]) and, at
// B = 128, 26 MB of img_k/img_v are read, plus 6.4 MB of vocab table in the
// head, so the step is bandwidth-bound at small batch. The products are built
// for that: a warp owns one 16-byte column vector of a weight (8 bf16
// columns), and 2-8 warps split K between them lane by lane, so each lane has
// only a few independent 16-byte loads and all of them are in flight at once
// (one warp per vector over the whole K leaves too few loads in flight to
// cover the latency at B = 8). Every weight byte is read once per 8- or
// 16-row tile of the batch; the batch rows are staged once per block in
// shared memory, the lane partial sums meet in one warp reduce-scatter and
// the warps' in shared memory. The [B, 5H] gate pre-activations and the
// [B, k, H] attention tanh never reach device memory. The products use FMA on
// CUDA cores (no tensor cores yet): at B = 128 their 2.6 GFLOP per step make
// the FMA rate the bound, which mma.sync / wgmma would lift.
//
// Dataflow kept from the reference: the h-recurrent product and the sentinel
// gate read h_prev, p_hid reads h'. gxb already folds the global-feature gate
// parts and all three gate biases (including gate_h's).
#include "common.cuh"

namespace capk {

// ---- gate --------------------------------------------------------------------

template <typename T, int MT, int KS>
__global__ void __launch_bounds__(5 * KS * 32)
    gate_kernel(const T* __restrict__ word_emb,  // [M, E]
                const float* __restrict__ h,     // [M, H]
                const float* __restrict__ c,     // [M, H]
                const T* __restrict__ w_word,    // [E, 5H]
                const T* __restrict__ w_hh,      // [H, 5H]
                const float* __restrict__ gxb,   // [M, 5H]
                float* __restrict__ h_out, float* __restrict__ c_out,
                float* __restrict__ sent_out,  // [M, H] each
                int M, int E, int H) {
  constexpr int W = Vec<T>::W, NVAL = MT * W, PER = NVAL / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  T* At = reinterpret_cast<T*>(smem);  // [E + H][MT]
  __shared__ float part[KS][5][NVAL];
  const int K = E + H, m0 = blockIdx.y * MT, j0 = blockIdx.x * W;
  const long N5 = 5L * H;
  stage_rows<T, MT>(At, m0, M, K, [&](int row, int k) -> float {
    return k < E ? ld(word_emb, (long)row * E + k) : h[(long)row * H + (k - E)];
  });
  __syncthreads();

  // warp (g, s): gate slice g, K split s
  const int warp = threadIdx.x / 32, g = warp % 5, s = warp / 5, lane = threadIdx.x & 31;
  float acc[NVAL];
#pragma unroll
  for (int i = 0; i < NVAL; ++i) acc[i] = 0.f;
  const long col0 = (long)g * H + j0;
  colvec_product<T, MT, KS>(At, w_word + col0, N5, 0, E, s, lane, acc);
  colvec_product<T, MT, KS>(At, w_hh + col0, N5, E, K, s, lane, acc);
  warp_reduce_scatter<NVAL>(acc, lane);
#pragma unroll
  for (int i = 0; i < PER; ++i) part[s][g][PER * lane + i] = acc[i];
  __syncthreads();

  for (int t = threadIdx.x; t < NVAL; t += blockDim.x) {
    const int row = m0 + t / W, j = j0 + t % W;
    if (row >= M) continue;
    float z[5];
#pragma unroll
    for (int q = 0; q < 5; ++q) {
      z[q] = gxb[row * N5 + (long)q * H + j];
#pragma unroll
      for (int x = 0; x < KS; ++x) z[q] += part[x][q][t];
    }
    const float gi = sigmoid(z[0]), gf = sigmoid(z[1]), gg = tanhf(z[2]);
    const float go = sigmoid(z[3]), gs = sigmoid(z[4]);
    const long o = (long)row * H + j;
    const float c_new = gf * c[o] + gi * gg;
    const float tc = tanhf(c_new);
    c_out[o] = c_new;
    h_out[o] = go * tc;
    sent_out[o] = gs * tc;
  }
}

// ---- dense -------------------------------------------------------------------

struct DenseArgs {
  const float* a;     // [M, K]
  const float* a2;    // [M, K] added to a before the product, or null
  const void* w;      // [K, N] compute dtype
  const float* bias;  // [N]
  float* out;         // [M, N]
  int act;            // 0: none, 1: tanh
};

// A block takes CV 16-byte column vectors with K split over KS warps each:
// at MT = 8 one vector and 8 splits (many blocks, few loads per lane: the
// weight read is latency-bound), at MT = 16 four vectors and 2 splits (the
// staged batch rows serve four vectors).
template <int MT>
struct DenseTile {
  static constexpr int CV = MT <= 8 ? 1 : 4, KS = MT <= 8 ? 8 : 2;
};

template <typename T, int MT, int CV, int KS>
__global__ void __launch_bounds__(CV * KS * 32)
    dense_kernel(DenseArgs p0, DenseArgs p1, int M, int N, int K) {
  constexpr int W = Vec<T>::W, NVAL = MT * W, PER = NVAL / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  T* At = reinterpret_cast<T*>(smem);  // [K][MT]
  __shared__ float part[KS][CV][NVAL];
  const DenseArgs p = blockIdx.z == 0 ? p0 : p1;
  const int m0 = blockIdx.y * MT;
  stage_rows<T, MT>(At, m0, M, K, [&](int row, int k) -> float {
    const long i = (long)row * K + k;
    return p.a2 != nullptr ? p.a[i] + p.a2[i] : p.a[i];
  });
  __syncthreads();

  // warp (v, s): column vector v of the block, K split s
  const int warp = threadIdx.x / 32, v = warp % CV, s = warp / CV, lane = threadIdx.x & 31;
  const int col0 = (blockIdx.x * CV + v) * W;
  float acc[NVAL];
#pragma unroll
  for (int i = 0; i < NVAL; ++i) acc[i] = 0.f;
  if (col0 < N)
    colvec_product<T, MT, KS>(At, static_cast<const T*>(p.w) + col0, N, 0, K, s, lane, acc);
  warp_reduce_scatter<NVAL>(acc, lane);
#pragma unroll
  for (int i = 0; i < PER; ++i) part[s][v][PER * lane + i] = acc[i];
  __syncthreads();

  for (int t = threadIdx.x; t < CV * NVAL; t += blockDim.x) {
    const int tv = t / NVAL, tt = t % NVAL;
    const int row = m0 + tt / W, col = (blockIdx.x * CV + tv) * W + tt % W;
    if (row >= M || col >= N) continue;
    float y = p.bias[col];
#pragma unroll
    for (int x = 0; x < KS; ++x) y += part[x][tv][tt];
    if (p.act == 1) y = tanhf(y);
    p.out[(long)row * N + col] = y;
  }
}

// ---- attention ---------------------------------------------------------------

constexpr int kAttnThreads = 1024;

template <typename T>
__global__ void __launch_bounds__(kAttnThreads)
    attention_kernel(const T* __restrict__ img_k,         // [M, S, H]
                     const T* __restrict__ img_v,         // [M, S, H]
                     const float* __restrict__ hid_emb,   // [M, H]
                     const float* __restrict__ sent_key,  // [M, H]
                     const float* __restrict__ sentinel,  // [M, H]
                     const T* __restrict__ w_score,       // [H]
                     const float* __restrict__ b_score,   // [1]
                     float* __restrict__ ctx,             // [M, H]
                     int S, int H) {
  constexpr int W = Vec<T>::W;
  extern __shared__ __align__(16) float fsm[];
  float* he = fsm;          // [H] hid_emb row
  float* ws = fsm + H;      // [H] score weights
  float* e = fsm + 2 * H;   // [S + 1] scores, slot S is the sentinel
  float* a = e + S + 1;     // [S + 1] exp(e - max)
  const int row = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarp = blockDim.x >> 5;
  const long base = (long)row * S * H;
  for (int x = tid; x < H; x += blockDim.x) {
    he[x] = hid_emb[(long)row * H + x];
    ws[x] = ld(w_score, x);
  }
  __syncthreads();

  for (int s = warp; s <= S; s += nwarp) {
    float sum = 0.f;
    if (s < S) {
      const T* key = img_k + base + (long)s * H;
#pragma unroll 4
      for (int x = lane * W; x < H; x += 32 * W) {
        float kf[W];
        load_vec<T>(key + x, kf);
#pragma unroll
        for (int j = 0; j < W; ++j) sum += tanhf(kf[j] + he[x + j]) * ws[x + j];
      }
    } else {
      for (int x = lane; x < H; x += 32)
        sum += tanhf(sent_key[(long)row * H + x] + he[x]) * ws[x];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) e[s] = sum + b_score[0];
  }
  __syncthreads();
  float mx = -INFINITY;
  for (int s = 0; s <= S; ++s) mx = fmaxf(mx, e[s]);
  for (int s = tid; s <= S; s += blockDim.x) a[s] = expf(e[s] - mx);
  __syncthreads();
  float denom = 0.f;
  for (int s = 0; s <= S; ++s) denom += a[s];
  for (int x = tid; x < H; x += blockDim.x) {
    float sum = 0.f;
#pragma unroll 7
    for (int s = 0; s < S; ++s) sum = fmaf(a[s], ld(img_v, base + (long)s * H + x), sum);
    sum = fmaf(a[S], sentinel[(long)row * H + x], sum);
    ctx[(long)row * H + x] = sum / denom;
  }
}

// ---- launchers ---------------------------------------------------------------

// K splits of the gate product: 4 at MT = 8 (640 threads), 2 at MT = 16,
// where each thread holds twice the accumulators (320 threads)
template <int MT>
constexpr int kGateSplit = MT <= 8 ? 4 : 2;

template <typename T, int MT>
static bool launch_gate(int M, int E, int H, const void* word_emb, const float* h,
                        const float* c, const void* w_word, const void* w_hh,
                        const float* gxb, float* h_out, float* c_out, float* sent_out,
                        cudaStream_t stream) {
  constexpr int KS = kGateSplit<MT>;
  static const bool raised = raise_smem_limit(gate_kernel<T, MT, KS>);
  const size_t smem = (size_t)MT * (E + H) * sizeof(T);
  if (!raised || smem > kMaxDynamicSmem) return false;
  dim3 grid(H / Vec<T>::W, (M + MT - 1) / MT);
  gate_kernel<T, MT, KS><<<grid, 5 * KS * 32, smem, stream>>>(
      static_cast<const T*>(word_emb), h, c, static_cast<const T*>(w_word),
      static_cast<const T*>(w_hh), gxb, h_out, c_out, sent_out, M, E, H);
  return true;
}

template <typename T, int MT>
static bool launch_dense(int nprob, int M, int N, int K, const DenseArgs& p0,
                         const DenseArgs& p1, cudaStream_t stream) {
  constexpr int CV = DenseTile<MT>::CV, KS = DenseTile<MT>::KS;
  static const bool raised = raise_smem_limit(dense_kernel<T, MT, CV, KS>);
  const size_t smem = (size_t)MT * K * sizeof(T);
  if (!raised || smem > kMaxDynamicSmem) return false;
  const int cols_per_block = CV * Vec<T>::W;
  dim3 grid((N + cols_per_block - 1) / cols_per_block, (M + MT - 1) / MT, nprob);
  dense_kernel<T, MT, CV, KS><<<grid, CV * KS * 32, smem, stream>>>(p0, p1, M, N, K);
  return true;
}

template <typename T>
static bool launch_attention(int M, int S, int H, const void* img_k, const void* img_v,
                             const float* hid_emb, const float* sent_key,
                             const float* sentinel, const void* w_score,
                             const float* b_score, float* ctx, cudaStream_t stream) {
  const size_t smem = (2 * (size_t)H + 2 * (size_t)(S + 1)) * sizeof(float);
  if (smem > 48 * 1024) return false;
  attention_kernel<T><<<M, kAttnThreads, smem, stream>>>(
      static_cast<const T*>(img_k), static_cast<const T*>(img_v), hid_emb, sent_key,
      sentinel, static_cast<const T*>(w_score), b_score, ctx, S, H);
  return true;
}

template <typename T, int MT>
static int step(int M, int E, int H, int S, const void* word_emb, const float* h,
                const float* c, const void* img_k, const void* img_v,
                const void* w_word, const void* w_hh, const float* gxb,
                const void* w_p, const float* b_p, const void* w_he,
                const float* b_he, const void* w_se, const float* b_se,
                const void* w_out, const float* b_out, const void* w_proj,
                const float* b_proj, const void* w_score, const float* b_score,
                float* ws, cudaStream_t stream) {
  const long mh = (long)M * H;
  float *h_new = ws, *c_new = ws + mh, *sent = ws + 2 * mh, *p_hid = ws + 3 * mh;
  float *hid_emb = ws + 4 * mh, *sent_key = ws + 5 * mh, *ctx = ws + 6 * mh;
  float *out = ws + 7 * mh, *proj = ws + 8 * mh;
  cudaError_t err;
#define CAPK_STEP(...)                                    \
  if (!(__VA_ARGS__)) return (int)cudaErrorInvalidValue;  \
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  CAPK_STEP(launch_gate<T, MT>(M, E, H, word_emb, h, c, w_word, w_hh, gxb, h_new,
                               c_new, sent, stream));
  const DenseArgs none{};
  CAPK_STEP(launch_dense<T, MT>(1, M, H, H, DenseArgs{h_new, nullptr, w_p, b_p, p_hid, 1},
                                none, stream));
  CAPK_STEP(launch_dense<T, MT>(2, M, H, H,
                                DenseArgs{p_hid, nullptr, w_he, b_he, hid_emb, 0},
                                DenseArgs{sent, nullptr, w_se, b_se, sent_key, 0},
                                stream));
  CAPK_STEP(launch_attention<T>(M, S, H, img_k, img_v, hid_emb, sent_key, sent,
                                w_score, b_score, ctx, stream));
  CAPK_STEP(launch_dense<T, MT>(1, M, H, H, DenseArgs{ctx, p_hid, w_out, b_out, out, 1},
                                none, stream));
  CAPK_STEP(launch_dense<T, MT>(1, M, E, H,
                                DenseArgs{out, nullptr, w_proj, b_proj, proj, 0}, none,
                                stream));
#undef CAPK_STEP
  return 0;
}

}  // namespace capk

extern "C" {

// One decode step up to the head. ws is a float32 workspace of
// 8 * M * H + M * E elements; on return it holds, in order, h' [M, H],
// c' [M, H], sentinel, p_hid, hid_emb, sent_key, ctx, out (each [M, H]) and
// proj [M, E]. H and E must be multiples of 8. Returns a CUDA error code
// (cudaErrorInvalidValue for shapes the kernels do not take).
int capk_fused_step(int dtype, int M, int E, int H, int S, const void* word_emb,
                    const float* h, const float* c, const void* img_k,
                    const void* img_v, const void* w_word, const void* w_hh,
                    const float* gxb, const void* w_p, const float* b_p,
                    const void* w_he, const float* b_he, const void* w_se,
                    const float* b_se, const void* w_out, const float* b_out,
                    const void* w_proj, const float* b_proj, const void* w_score,
                    const float* b_score, float* ws, cudaStream_t stream) {
  if (M < 1 || E % 8 != 0 || H % 8 != 0) return (int)cudaErrorInvalidValue;
#define CAPK_ARGS                                                                  \
  M, E, H, S, word_emb, h, c, img_k, img_v, w_word, w_hh, gxb, w_p, b_p, w_he, b_he, \
      w_se, b_se, w_out, b_out, w_proj, b_proj, w_score, b_score, ws, stream
  int rc;
  if (dtype == capk::kBF16) {
    using T = __nv_bfloat16;
    rc = M <= 8 ? capk::step<T, 8>(CAPK_ARGS) : capk::step<T, 16>(CAPK_ARGS);
  } else if (dtype == capk::kF32) {
    rc = M <= 8 ? capk::step<float, 8>(CAPK_ARGS) : capk::step<float, 16>(CAPK_ARGS);
  } else {
    rc = (int)cudaErrorInvalidValue;
  }
#undef CAPK_ARGS
  return rc;
}

}  // extern "C"
