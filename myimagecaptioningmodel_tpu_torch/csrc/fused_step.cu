// Kernel B: the adaptive-attention LSTM decode step, and the whole greedy
// decode built from it, enqueued on one stream from one C call; the wrappers
// capture a whole decode (greedy: this file's capk_lstm_greedy_decode; beam:
// the per-step call with kernel C and the selection, inference/beam.py) once
// per decode shape in a CUDA graph and replay it (ops/kernels/fused_step.py).
//
// Replaces myimagecaptioningmodel_tpu/ops/pallas/fused_step.py::
// fused_decode_step (formula in that module's docstring). The TPU kernel is a
// single program that keeps about 90 MB of weights, image keys/values and
// vocab table resident in VMEM across all 35 steps. An H100 SM has 227 KB of
// shared memory, so here the step is split where a product's output feeds the
// next product's whole contraction, six kernels a step:
//
//   gate       [word_emb ; h_prev] @ w_gate + gxb, then the LSTM cell and the
//              sentinel in the epilogue: h', c', sentinel. w_gate is packed
//              once at load (pack_weights) with its five gate columns
//              {j, H+j, 2H+j, 3H+j, 4H+j} interleaved as [K, H / 16, 5, 16],
//              so a block's 80 columns hold the five gates of 16 hidden units
//              and the cell needs nothing from other blocks. In the whole
//              decode the word rows are gathered in the product's prologue
//              from the table by the previous step's ids (<pad> -> zeros).
//   p_hid      tanh(h' Wp + bp);
//   he + se    hid_emb = p_hid Whe + bhe and sent_key = sentinel Wse + bse,
//              one launch (two problems side by side);
//   attention  a thread-block cluster of 8 per image (for up to 8 of its
//              rows: beam rows share their image), each block owning H / 8
//              columns: its slice's partial tanh(k + hid_emb) . w_score for
//              the 49 image slots and the sentinel of each row, pushed to
//              every block of the cluster through distributed shared memory
//              and summed there in slice order; every block takes the
//              float32 softmax of each row's 50 scores and writes ctx +
//              p_hid for its slice. The block's slice of the image's keys
//              and values arrives by cp.async before griddep_wait(): the
//              memory is constant over a decode, and read once for all the
//              image's rows.
//   out        tanh((ctx + p_hid) Wout + bout);
//   proj       out Wproj + bproj;
// then, in the whole greedy decode, kernel A's two kernels (vocab_head.cu)
// and greedy_finish: row t of the ids, <pad> after <stop> with early stop,
// and a device flag once every row is done, on which every later kernel
// returns at once. 9 kernels a greedy step, 315 a 35-step decode: one graph
// launch for the host.
//
// What bounds it on an H100: bytes. A step reads the weights (about 21 MB
// in bf16: [1280, 5120] gate, four [1024, 1024], one [1024, 256]), each
// image's keys and values (1.6 MB at 8 images, 26 MB at 128) and, with the
// head, 6.4 MB of vocab table: ~9 us at B = 8 (chip_smoke.bound_b). At 512
// beam rows the products' 10.7 GFLOP a step are ~11 us at the bf16 tensor
// rate. The bf16 products are stream_product.cuh's weight-streaming
// mma.sync product (kernels D's and E's), in B's own modes: the weight
// slabs issued before griddep_wait(), K split across a thread-block cluster
// and the partial sums added in split order through distributed shared
// memory (no workspace, no atomic: a decode is deterministic); float32
// activation rows staged as they are and rounded to bf16 as each fragment is
// formed; float32 sums and bias, not rounded (the TPU kernel's numerics);
// the cell in the gate product's epilogue. Up to 16 rows every kernel of the
// step is launched with programmatic dependent launch, as D's.
//
// float32 keeps the FMA products (gate_kernel, dense_kernel: a warp owns one
// 16-byte column vector of a weight, 2-8 warps split K, the batch rows staged
// once per block): the tensor cores take no float32.
//
// Dataflow kept from the reference: the h-recurrent product and the sentinel
// gate read h_prev, p_hid reads h'. gxb already folds the global-feature gate
// parts and all three gate biases (including gate_h's).
//
// Shapes: H and E multiples of 64 (the products' column tiles and K stages;
// the attention's 8 slices of whole 16-byte vectors); others return
// cudaErrorInvalidValue.
#include "stream_product.cuh"
#include "vocab_head.cuh"

namespace capk {

// ---- float32: the FMA products ----------------------------------------------

// Gate column of gate q of hidden unit j in pack_weights' interleaved layout.
__device__ __forceinline__ long gate_col(int q, int j) {
  return (long)(j / 16) * 80 + q * 16 + j % 16;
}

// Word rows: [M, E] rows, or table rows gathered by `word` (<pad>: zeros).
template <typename T>
__device__ __forceinline__ float word_value(const T* rows, const int* word, int pad, int row,
                                            int E, int k) {
  if (word == nullptr) return ld(rows, (long)row * E + k);
  const int wd = word[row];
  return wd == pad ? 0.f : ld(rows, (long)wd * E + k);
}

template <typename T, int MT, int KS>
__global__ void __launch_bounds__(5 * KS * 32)
    gate_kernel(const T* __restrict__ rows, const int* __restrict__ word, int pad,
                const float* __restrict__ h,   // [M, H]
                const float* __restrict__ c,   // [M, H]
                const T* __restrict__ w_gate,  // [E + H, 5H], interleaved
                const float* __restrict__ gxb,  // [M, 5H]
                float* __restrict__ h_out, float* __restrict__ c_out,
                float* __restrict__ sent_out,  // [M, H] each
                int M, int E, int H, const int* __restrict__ skip) {
  if (pdl_enter(skip)) return;
  constexpr int W = Vec<T>::W, NVAL = MT * W, PER = NVAL / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  T* At = reinterpret_cast<T*>(smem);  // [E + H][MT]
  __shared__ float part[KS][5][NVAL];
  const int K = E + H, m0 = blockIdx.y * MT, j0 = blockIdx.x * W;
  const long N5 = 5L * H;
  stage_rows<T, MT>(At, m0, M, K, [&](int row, int k) -> float {
    return k < E ? word_value(rows, word, pad, row, E, k) : h[(long)row * H + (k - E)];
  });
  __syncthreads();

  // warp (g, s): gate g, K split s
  const int warp = threadIdx.x / 32, g = warp % 5, s = warp / 5, lane = threadIdx.x & 31;
  float acc[NVAL];
#pragma unroll
  for (int i = 0; i < NVAL; ++i) acc[i] = 0.f;
  colvec_product<T, MT, KS>(At, w_gate + gate_col(g, j0), N5, 0, K, s, lane, acc);
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

struct DenseArgs {
  const float* a;     // [M, K]
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
    dense_kernel(DenseArgs p0, DenseArgs p1, int M, int N, int K, const int* __restrict__ skip) {
  if (pdl_enter(skip)) return;
  constexpr int W = Vec<T>::W, NVAL = MT * W, PER = NVAL / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  T* At = reinterpret_cast<T*>(smem);  // [K][MT]
  __shared__ float part[KS][CV][NVAL];
  const DenseArgs p = blockIdx.z == 0 ? p0 : p1;
  const int m0 = blockIdx.y * MT;
  stage_rows<T, MT>(At, m0, M, K, [&](int row, int k) -> float { return p.a[(long)row * K + k]; });
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

// K splits of the gate product: 4 at MT = 8 (640 threads), 2 at MT = 16,
// where each thread holds twice the accumulators (320 threads)
template <int MT>
constexpr int kGateSplit = MT <= 8 ? 4 : 2;

// ---- attention ---------------------------------------------------------------

constexpr int kSlices = 8;  // blocks of a cluster, each owning H / 8 columns
constexpr int kAttnRows = 8;  // rows of one image a cluster takes, at most
constexpr int kAttnThreads = 256;

// The cluster's barrier in two halves: arrive (relaxed: orders nothing) once
// this block runs, wait before writing into another block's shared memory.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Floats of shared memory after the image slice: score weights, the rows'
// hid_emb, sent_key, sentinel and p_hid slices, every slice's partial
// scores, the scores, each row's max and sum.
__host__ __device__ constexpr int attn_floats(int HS, int S) {
  return HS + 4 * kAttnRows * HS + (kSlices + 1) * kAttnRows * (S + 1) + 2 * kAttnRows;
}

// Cluster (image, group): the rows [g0, g0 + nr) of one image (beam rows
// share theirs; greedy rows have one each), block `rank` owning columns
// [rank H / 8, (rank + 1) H / 8) of H. The image's slice is read once for
// all its rows.
template <typename T>
__global__ void __launch_bounds__(kAttnThreads)
    lstm_attention(const T* __restrict__ img_k,  // [n_img, S, H]
                   const T* __restrict__ img_v,  // [n_img, S, H]
                   const float* __restrict__ hid_emb, const float* __restrict__ sent_key,
                   const float* __restrict__ sentinel,
                   const float* __restrict__ p_hid,  // [M, H] each
                   const T* __restrict__ w_score,    // [H]
                   const float* __restrict__ b_score,  // [1]
                   float* __restrict__ ctxp,         // [M, H] ctx + p_hid
                   int S, int H, int rows_per_img, const int* __restrict__ skip) {
  constexpr int VW = 16 / (int)sizeof(T);  // elements of a 16-byte chunk
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), img = blockIdx.y;
  const int g0 = blockIdx.z * kAttnRows, nr = min(kAttnRows, rows_per_img - g0);
  const long row0 = (long)img * rows_per_img + g0;
  const int HS = H / kSlices, col0 = rank * HS, S1 = S + 1;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid & 31;
  extern __shared__ __align__(16) unsigned char att_smem[];
  T* ks = reinterpret_cast<T*>(att_smem);  // [S][HS] the slice of the image's keys
  T* vs = ks + (long)S * HS;               // [S][HS] and values
  float* ws = reinterpret_cast<float*>(vs + (long)S * HS);  // [HS] score weights
  float* he = ws + HS;                       // [kAttnRows][HS] the rows' hid_emb,
  float* sk = he + kAttnRows * HS;           // sent_key,
  float* sn = sk + kAttnRows * HS;           // sentinel
  float* ph = sn + kAttnRows * HS;           // and p_hid slices
  float* part = ph + kAttnRows * HS;         // [kSlices][kAttnRows][S + 1] partial scores
  float* e = part + kSlices * kAttnRows * S1;  // [kAttnRows][S + 1] scores, then exp(e - max)
  float* rmax = e + kAttnRows * S1;          // [kAttnRows]
  float* rsum = rmax + kAttnRows;            // [kAttnRows]

  if (flag_set(skip)) return;
  // the image slice and the score weights: constant over a decode
  const long ib = (long)img * S * H + col0;
  const int cpr = HS / VW;  // 16-byte chunks of a slot's slice
  for (int i = tid; i < 2 * S * cpr; i += kAttnThreads) {
    const int which = i / (S * cpr), s = (i / cpr) % S, ch = i % cpr;
    cp_async16((which ? vs : ks) + (long)s * HS + ch * VW,
               (which ? img_v : img_k) + ib + (long)s * H + ch * VW, 16);
  }
  cp_async_commit();
  for (int x = tid; x < HS; x += kAttnThreads) ws[x] = ld(w_score, col0 + x);
  const float bias = __ldg(b_score);
  griddep_wait();
  if (flag_set(skip)) {
    cp_async_wait<0>();
    return;
  }
  griddep_launch_dependents();
  cluster_arrive_relaxed();  // this block runs: the others may write into its shared memory
  for (int i = tid; i < nr * HS; i += kAttnThreads) {  // the four loads of an element together
    const long o = (row0 + i / HS) * H + col0 + i % HS;
    he[i] = __ldcg(hid_emb + o);
    sk[i] = __ldcg(sent_key + o);
    sn[i] = __ldcg(sentinel + o);
    ph[i] = __ldcg(p_hid + o);
  }
  cp_async_wait<0>();
  __syncthreads();
  cluster_wait();  // every block of the cluster runs

  // this slice's partial score of (row r, slot s) (slot S: the sentinel),
  // pushed to every block of the cluster, into the slice's own row
  for (int i = warp; i < nr * S1; i += kAttnThreads / 32) {
    const int r = i / S1, s = i % S1;
    const float* hr = he + r * HS;
    float sum = 0.f;
    for (int x = lane; x < HS; x += 32) {
      const float k = s < S ? ld(ks, (long)s * HS + x) : sk[r * HS + x];
      sum += tanhf(k + hr[x]) * ws[x];
    }
    sum = warp_sum(sum);
    if (lane < kSlices)
      cluster.map_shared_rank(part, lane)[(rank * kAttnRows + r) * S1 + s] = sum;
  }
  cluster.sync();  // every slice's partials are in place

  // the scores (the slices in order), their float32 softmax, ctx + p_hid
  for (int i = tid; i < nr * S1; i += kAttnThreads) {
    float v = 0.f;
    for (int q = 0; q < kSlices; ++q) v += part[q * kAttnRows * S1 + i];
    e[i] = v + bias;
  }
  __syncthreads();
  if (tid < nr) {
    const float* er = e + tid * S1;
    float mx = -INFINITY, den = 0.f;
    for (int s = 0; s < S1; ++s) mx = fmaxf(mx, er[s]);
    for (int s = 0; s < S1; ++s) den += expf(er[s] - mx);
    rmax[tid] = mx;
    rsum[tid] = den;
  }
  __syncthreads();
  for (int i = tid; i < nr * S1; i += kAttnThreads) e[i] = expf(e[i] - rmax[i / S1]);
  __syncthreads();
  for (int i = tid; i < nr * HS; i += kAttnThreads) {
    const int r = i / HS, x = i % HS;
    const float* a = e + r * S1;
    float acc = 0.f;
#pragma unroll 7
    for (int s = 0; s < S; ++s) acc = fmaf(a[s], ld(vs, (long)s * HS + x), acc);
    acc = fmaf(a[S], sn[i], acc);
    ctxp[(row0 + r) * H + col0 + x] = acc / rsum[r] + ph[i];
  }
}

// ---- launchers ---------------------------------------------------------------

template <typename T>
static bool launch_attention(int M, int S, int H, int rows_per_img, const void* img_k,
                             const void* img_v, const float* hid_emb, const float* sent_key,
                             const float* sentinel, const float* p_hid, const void* w_score,
                             const float* b_score, float* ctxp, const int* skip, bool pdl,
                             cudaStream_t stream) {
  static const bool raised = raise_smem_limit(lstm_attention<T>);
  const int HS = H / kSlices;
  const size_t smem =
      2 * (size_t)S * HS * sizeof(T) + (size_t)attn_floats(HS, S) * sizeof(float);
  if (!raised || smem > kMaxDynamicSmem) return false;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kSlices, M / rows_per_img, (rows_per_img + kAttnRows - 1) / kAttnRows);
  cfg.blockDim = kAttnThreads;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;  // a row's slices
  attr[0].val.clusterDim.x = kSlices;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pdl ? 2 : 1;
  return cudaLaunchKernelEx(&cfg, lstm_attention<T>, static_cast<const T*>(img_k),
                            static_cast<const T*>(img_v), hid_emb, sent_key, sentinel, p_hid,
                            static_cast<const T*>(w_score), b_score, ctxp, S, H, rows_per_img,
                            skip) == cudaSuccess;
}

template <int MT>
static bool launch_gate_fma(int M, int E, int H, const float* rows, const int* word, int pad,
                            const float* h, const float* c, const float* w_gate,
                            const float* gxb, float* h_out, float* c_out, float* sent_out,
                            const int* skip, bool pdl, cudaStream_t stream) {
  constexpr int KS = kGateSplit<MT>;
  static const bool raised = raise_smem_limit(gate_kernel<float, MT, KS>);
  const size_t smem = (size_t)MT * (E + H) * sizeof(float);
  if (!raised || smem > kMaxDynamicSmem) return false;
  return launch_k(pdl, gate_kernel<float, MT, KS>, dim3(H / Vec<float>::W, (M + MT - 1) / MT),
                  5 * KS * 32, smem, stream, rows, word, pad, h, c, w_gate, gxb, h_out, c_out,
                  sent_out, M, E, H, skip) == cudaSuccess;
}

template <int MT>
static bool launch_dense_fma(int nprob, int M, int N, int K, const DenseArgs& p0,
                             const DenseArgs& p1, const int* skip, bool pdl,
                             cudaStream_t stream) {
  constexpr int CV = DenseTile<MT>::CV, KS = DenseTile<MT>::KS;
  static const bool raised = raise_smem_limit(dense_kernel<float, MT, CV, KS>);
  const size_t smem = (size_t)MT * K * sizeof(float);
  if (!raised || smem > kMaxDynamicSmem) return false;
  const int cols_per_block = CV * Vec<float>::W;
  return launch_k(pdl, dense_kernel<float, MT, CV, KS>,
                  dim3((N + cols_per_block - 1) / cols_per_block, (M + MT - 1) / MT, nprob),
                  CV * KS * 32, smem, stream, p0, p1, M, N, K, skip) == cudaSuccess;
}

// ---- one step, one decode ----------------------------------------------------

// fused_step.py's _PTR_FIELDS then _WORK_FIELDS, in order
struct LstmPtrs {
  // the packed weights (pack_weights), in the compute dtype T; biases float32
  const void* w_gate;  // [E + H, 5H], gate columns interleaved
  const void* w_p;
  const float* b_p;
  const void* w_hs;  // [2, H, H]: hid_emb, sent_emb
  const float* b_hs;  // [2, H]
  const void* w_out;
  const float* b_out;
  const void* w_proj;  // [H, E]
  const float* b_proj;
  const void* w_score;  // [H]
  const float* b_score;  // [1]
  const void* table;     // [V, E]: the word rows' gather table and the head's
  const float* head_bias;  // [V]
  // the batch's
  const float* gxb;  // [M, 5H]
  const void* img_k;  // [n_img, S, H]
  const void* img_v;
  // state and scratch
  const void* word_emb;  // one step without `word`: [M, E] word rows
  int* word;             // [M] the previous step's ids, gathered by the gate (or null)
  float *h0, *c0, *h1, *c1;  // step t reads h_{t % 2}, c_{t % 2} and writes the others
  float* ws;  // p_hid, sentinel, hid_emb, sent_key, ctx + p_hid, out [M, H] each; proj [M, E]
  float* part_v;  // kernel A's partials [M, vocab_argmax_width(V)] (whole decode)
  int* part_i;
  int *done, *flag;  // [M], [1]; flag also a one-step call's skip (may be null)
  int* ids_tm;       // [steps, M]
};
static_assert(sizeof(LstmPtrs) == 28 * sizeof(void*), "one pointer per field");

// fused_step.py's ints, in order
enum LstmArg : int {
  kLDtype, kLRows, kLEmb, kLHidden, kLSlots, kLImages, kLVocab, kLSteps, kLStart, kLPad,
  kLStop, kLEarly, kLNumArgs
};

// Enqueues step t (h, c from buffer t % 2 into the other) up to proj; adds
// the kernels enqueued to *n. Returns a CUDA error code.
template <typename T>
static int lstm_step(const int* a, const LstmPtrs& p, int t, bool pdl, cudaStream_t stream,
                     int* n) {
  const int M = a[kLRows], E = a[kLEmb], H = a[kLHidden], S = a[kLSlots], pad = a[kLPad];
  const int rows_per_img = M / a[kLImages];
  const long mh = (long)M * H;
  const float* h = t % 2 ? p.h1 : p.h0;
  const float* c = t % 2 ? p.c1 : p.c0;
  float* h_out = t % 2 ? p.h0 : p.h1;
  float* c_out = t % 2 ? p.c0 : p.c1;
  float *p_hid = p.ws, *sent = p.ws + mh, *hid_emb = p.ws + 2 * mh, *sent_key = p.ws + 3 * mh;
  float *ctxp = p.ws + 4 * mh, *out = p.ws + 5 * mh, *proj = p.ws + 6 * mh;
  const bool gather = p.word != nullptr;
  cudaError_t err;
#define CAPK_STEP(...)                                              \
  do {                                                              \
    if (!(__VA_ARGS__)) return (int)cudaErrorInvalidValue;          \
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err; \
    ++*n;                                                           \
  } while (0)
  if constexpr (std::is_same<T, bf>::value) {
    // the weight-streaming product in kernel B's modes: A = [word rows,
    // k < k_split ; float32 rows a2], float32 sums
    auto prod = [&](const float* a2, int k_split, const void* w, const float* bias, int e_mode,
                    float* o, int nprob) {
      TfDense d{};
      d.a_mode = k_split > 0 && gather ? kAGather : kARows;
      d.a = gather ? p.table : p.word_emb;
      d.word = p.word;
      d.pad = pad;
      d.w = w;
      d.bias = bias;
      d.e_mode = e_mode;
      d.out = o;
      d.skip = p.flag;
      d.a2 = a2;
      d.k_split = k_split;
      d.nprob = nprob;
      return d;
    };
    TfDense gate = prod(h, E, p.w_gate, nullptr, kELstm, h_out, 1);
    gate.gxb = p.gxb;
    gate.c_in = c;
    gate.c_out = c_out;
    gate.s_out = sent;
    CAPK_STEP(wsp::launch<bf, 5, true>(gate, M, 5 * H, E + H, pdl, stream));
    CAPK_STEP(wsp::launch<bf, 4, true>(prod(h_out, 0, p.w_p, p.b_p, kEF32Tanh, p_hid, 1), M, H,
                                       H, pdl, stream));
    CAPK_STEP(wsp::launch<bf, 4, true>(prod(p_hid, 0, p.w_hs, p.b_hs, kEF32, hid_emb, 2), M, H,
                                       H, pdl, stream));
    CAPK_STEP(launch_attention<T>(M, S, H, rows_per_img, p.img_k, p.img_v, hid_emb, sent_key,
                                  sent, p_hid, p.w_score, p.b_score, ctxp, p.flag, pdl, stream));
    CAPK_STEP(wsp::launch<bf, 4, true>(prod(ctxp, 0, p.w_out, p.b_out, kEF32Tanh, out, 1), M, H,
                                       H, pdl, stream));
    CAPK_STEP(wsp::launch<bf, 4, true>(prod(out, 0, p.w_proj, p.b_proj, kEF32, proj, 1), M, E,
                                       H, pdl, stream));
  } else {
    const float* w_hs = static_cast<const float*>(p.w_hs);
    const DenseArgs none{};
    auto fma = [&](auto mt) {
      constexpr int MT = decltype(mt)::value;
      CAPK_STEP(launch_gate_fma<MT>(
          M, E, H, static_cast<const float*>(gather ? p.table : p.word_emb), p.word, pad, h, c,
          static_cast<const float*>(p.w_gate), p.gxb, h_out, c_out, sent, p.flag, pdl, stream));
      CAPK_STEP(launch_dense_fma<MT>(1, M, H, H, DenseArgs{h_out, p.w_p, p.b_p, p_hid, 1}, none,
                                     p.flag, pdl, stream));
      CAPK_STEP(launch_dense_fma<MT>(2, M, H, H, DenseArgs{p_hid, w_hs, p.b_hs, hid_emb, 0},
                                     DenseArgs{sent, w_hs + (long)H * H, p.b_hs + H, sent_key, 0},
                                     p.flag, pdl, stream));
      CAPK_STEP(launch_attention<T>(M, S, H, rows_per_img, p.img_k, p.img_v, hid_emb, sent_key,
                                    sent, p_hid, p.w_score, p.b_score, ctxp, p.flag, pdl,
                                    stream));
      CAPK_STEP(launch_dense_fma<MT>(1, M, H, H, DenseArgs{ctxp, p.w_out, p.b_out, out, 1}, none,
                                     p.flag, pdl, stream));
      CAPK_STEP(launch_dense_fma<MT>(1, M, E, H, DenseArgs{out, p.w_proj, p.b_proj, proj, 0},
                                     none, p.flag, pdl, stream));
      return 0;
    };
    const int rc = M <= 8 ? fma(std::integral_constant<int, 8>{})
                          : fma(std::integral_constant<int, 16>{});
    if (rc) return rc;
  }
#undef CAPK_STEP
  return 0;
}

// Programmatic dependent launch on every kernel of a step up to 16 rows, as
// kernels D and E (beyond, D and E measured it slower).
static bool step_pdl(int M) { return M <= wsp::kLnRows; }

template <typename T>
static int lstm_greedy_decode(const int* a, const LstmPtrs& p, cudaStream_t stream,
                              int* launches) {
  const int M = a[kLRows], E = a[kLEmb], H = a[kLHidden], V = a[kLVocab];
  const bool pdl = step_pdl(M);
  float* proj = p.ws + 6L * M * H;
  int n = 0;
  for (int t = 0; t < a[kLSteps]; ++t) {
    const int rc = lstm_step<T>(a, p, t, pdl, stream, &n);
    if (rc) return rc;
    // kernel A's tile kernel and merge (vocab_head.cu): two launches
    if (!vocab_argmax_launch(a[kLDtype], M, V, E, proj, p.table, p.head_bias, nullptr,
                             p.part_v, p.part_i, vocab_argmax_width(V), p.word, p.flag, pdl,
                             stream))
      return (int)cudaErrorInvalidValue;
    if (launch_k(pdl, greedy_finish, 1, kGreedyFinishThreads, 0, stream, p.word, p.done, p.flag,
                 p.ids_tm + (long)t * M, M, a[kLPad], a[kLStop], a[kLEarly]) != cudaSuccess)
      return (int)cudaErrorInvalidValue;
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    n += 3;
  }
  *launches = n;
  return 0;
}

static int check_args(const int* a, const LstmPtrs& p) {
  const int M = a[kLRows], E = a[kLEmb], H = a[kLHidden];
  if (M < 1 || E < 64 || E % 64 || H < 64 || H % 64 || a[kLSlots] < 1 || a[kLImages] < 1 ||
      M % a[kLImages] || (a[kLDtype] != kBF16 && a[kLDtype] != kF32) ||
      (p.word == nullptr && p.word_emb == nullptr))
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace capk

extern "C" {

// One decode step of kernel B up to proj, enqueued on `stream`. args:
// capk::LstmArg's fields (steps, start, stop and early unused); ptrs:
// capk::LstmPtrs's fields: h0, c0 in; h1, c1 and ws out; the word rows
// gathered from `table` by `word` if it is not null, else word_emb [M, E];
// flag, if not null, a device flag on which every kernel returns at once.
// img_k and img_v hold n_img images (args' kLImages, dividing M): row r
// attends to image r / (M / n_img). Returns a CUDA error code
// (cudaErrorInvalidValue for shapes the kernels do not take).
int capk_fused_step(const int* args, void* const* ptrs, cudaStream_t stream) {
  const capk::LstmPtrs& p = *reinterpret_cast<const capk::LstmPtrs*>(ptrs);
  if (const int rc = capk::check_args(args, p)) return rc;
  int n = 0;
  const bool pdl = capk::step_pdl(args[capk::kLRows]);
  return args[capk::kLDtype] == capk::kBF16
             ? capk::lstm_step<__nv_bfloat16>(args, p, 0, pdl, stream, &n)
             : capk::lstm_step<float>(args, p, 0, pdl, stream, &n);
}

// One greedy decode of kernel B with kernel A's head, all steps enqueued on
// `stream`. args: capk::LstmArg's fields; ptrs: capk::LstmPtrs's fields
// (word_emb may be null). h0, c0 must hold zeros, word [M] the start id,
// done [M] and flag [1] zeros, ids_tm [steps, M] <pad>. *launches gets the
// number of kernels enqueued. Returns a CUDA error code.
int capk_lstm_greedy_decode(const int* args, void* const* ptrs, cudaStream_t stream,
                            int* launches) {
  *launches = 0;
  const capk::LstmPtrs& p = *reinterpret_cast<const capk::LstmPtrs*>(ptrs);
  if (const int rc = capk::check_args(args, p)) return rc;
  if (p.word == nullptr || p.flag == nullptr || p.done == nullptr || p.ids_tm == nullptr ||
      args[capk::kLSteps] < 1 || args[capk::kLVocab] < 1)
    return (int)cudaErrorInvalidValue;
  return args[capk::kLDtype] == capk::kBF16
             ? capk::lstm_greedy_decode<__nv_bfloat16>(args, p, stream, launches)
             : capk::lstm_greedy_decode<float>(args, p, stream, launches);
}

// One of kernel B's bf16 products on its own, as a step runs it (a
// decode of up to 16 rows launches it with programmatic dependent launch:
// `pdl`). args: M, N, K, e_mode (capk::kEF32, kEF32Tanh or kELstm), k_split,
// nprob, gather, pad, pdl; ptrs: a, word, a2, w, bias, out, gxb, c_in,
// c_out, s_out (capk::TfDense's fields: A = [a's rows, or the table rows of
// `word` with gather, columns [0, k_split) ; the float32 rows a2]; kELstm:
// w interleaved as pack_weights leaves it, out h', and c', sentinel).
// Returns a CUDA error code.
int capk_lstm_product(const int* args, void* const* ptrs, cudaStream_t stream) {
  capk::TfDense d{};
  d.e_mode = args[3];
  d.k_split = args[4];
  d.nprob = args[5];
  d.a_mode = args[6] ? capk::kAGather : capk::kARows;
  d.pad = args[7];
  d.a = ptrs[0];
  d.word = static_cast<const int*>(ptrs[1]);
  d.a2 = static_cast<const float*>(ptrs[2]);
  d.w = ptrs[3];
  d.bias = static_cast<const float*>(ptrs[4]);
  d.out = ptrs[5];
  d.gxb = static_cast<const float*>(ptrs[6]);
  d.c_in = static_cast<const float*>(ptrs[7]);
  d.c_out = static_cast<float*>(ptrs[8]);
  d.s_out = static_cast<float*>(ptrs[9]);
  const bool pdl = args[8] != 0;
  if ((d.k_split > 0 && d.a == nullptr) || (args[6] && d.word == nullptr) ||
      (d.e_mode == capk::kELstm && (!d.gxb || !d.c_in || !d.c_out || !d.s_out)))
    return (int)cudaErrorInvalidValue;
  const bool ok = d.e_mode == capk::kELstm
                      ? capk::wsp::launch<__nv_bfloat16, 5, true>(d, args[0], args[1], args[2],
                                                                  pdl, stream)
                      : capk::wsp::launch<__nv_bfloat16, 4, true>(d, args[0], args[1], args[2],
                                                                  pdl, stream);
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// The K splits (a cluster's blocks) of kernel B's product of M rows, [K, N]
// weights (all nprob problems' columns), the gate's (80 columns a block) or
// another's (64): split s takes the 32-row K chunks [s c / S, (s + 1) c / S),
// c = K / 32.
int capk_lstm_product_splits(int M, int N, int K, int gate) {
  return capk::wsp::plan(M, N, K, gate ? capk::wsp::Cols<5>::NT : capk::wsp::kNT).splits;
}

}  // extern "C"
