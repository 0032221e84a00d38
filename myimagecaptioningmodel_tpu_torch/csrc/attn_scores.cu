// The batched additive-attention scores of the LSTM training forward and
// their hand-written backward (kernel H):
//
//   z[t, b, k, h] = tanh(img_k[b, k, h] + h_emb[t, b, h])       rounded to T
//   e[t, b, k]    = sum_h z w[h]  (float accumulation, stored as T) + bias
//
//   dz      = (de w) (1 - z^2)                                   rounded to T
//   dw[h]   = sum_{t, b, k} z de,     db = sum de                  (float)
//   dh_emb  = sum_k dz,               dimg_k = sum_t dz            (float)
//
// Not a port of a TPU kernel: it replaces
// myimagecaptioningmodel_tpu/ops/attention.py:42 attn_scores_fused_bwd, a
// jax.custom_vjp whose backward computes each gradient as its own reduction
// over a recomputed z, which XLA fuses so that no [T, B, k, H] tensor is ever
// written. Eager PyTorch fuses nothing: autograd of the same expression
// writes z, de w, dz and reads each again for every reduction (at T = 34,
// B = 128, k = 49, H = 1024 each such tensor is 437 MB in bf16). These
// kernels give the card the property XLA gives the TPU: the forward reads
// img_k and h_emb and writes e; the backward reads them and de and writes
// the three gradients.
//
// Every elementwise operation is the plain version's, rounded where it
// rounds (ops/kernels/attention.py, the JAX backward op by op): in bf16 the
// sum before the tanh, z, z de, de w, z^2, 1 - z^2 and dz each round to T;
// the products and differences use __fmul_rn / __fsub_rn so that float32
// contracts nothing into an FMA the plain version does not do. Sums are
// float32 in a fixed order.
//
// What bounds it on an H100: the tanh. One pass evaluates T B k H of them
// (218.4 M at the shape above); the bytes are ~22 MB forward and ~44 MB
// backward, a few µs at 3.35 TB/s. So the design keeps every operand on
// chip and spends the time on the arithmetic:
//
//   1. attn_scores_fwd: grid (B, ceil(T / kTT)), 256 threads. Block (b, tile)
//      takes kTT = 8 time steps of image b; warp w takes slots k = w, w + 8,
//      ...; per slot each lane walks h = lane, lane + 32, ... and keeps kTT
//      float sums, one per step, reading img_k[b, k, h] and w[h] once for
//      the kTT steps (h_emb's kTT rows stay in L1). A butterfly over the
//      warp's lanes (fixed order) ends each sum; lane 0 rounds it, adds the
//      bias and stores e.
//   2. attn_scores_bwd: grid (B, ceil(H / HT)), HT threads (128; fewer for
//      k > 96). Thread (b, h) owns one column: for t, for k it recomputes z
//      once and forms dz, adds dz into dh_emb's sum (stored at the end of
//      each t) and into its slot's dimg_k sum (k float sums a column, in
//      shared memory, stored at the end), and z de into its share of dw
//      (written to dw_part[b, h]). Each output element is written by one
//      thread, once.
//   3. attn_scores_dw_reduce: dw[h] = sum over b of dw_part[b, h] in b
//      order; one more block sums de for db in a fixed order (strided per
//      thread, then a tree in shared memory).
//
// No atomics: reruns give the same bits. Any T, B, k, H >= 1 (k up to
// 1,600: the backward's shared sums); float32 or bf16 operands, the
// gradients' storage float32 or bf16 each.
#include "common.cuh"

namespace capk {
namespace attn {

constexpr int kTT = 8;            // time steps a forward block takes
constexpr int kFwdThreads = 256;  // 8 warps
constexpr int kReduceThreads = 256;

template <typename T>
__device__ __forceinline__ float rnd(float x);
template <>
__device__ __forceinline__ float rnd<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float rnd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void put(float* p, long i, float v) { p[i] = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, long i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// z = tanh(a + b) as the plain version computes it in T
template <typename T>
__device__ __forceinline__ float z_of(float a, float b) {
  return rnd<T>(tanhf(rnd<T>(__fadd_rn(a, b))));
}

// store a float sum into float32 or bf16 storage
__device__ __forceinline__ void store(void* p, int code, long i, float v) {
  if (code == kBF16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(p)[i] = v;
}

template <typename T>
__global__ void __launch_bounds__(kFwdThreads)
    attn_scores_fwd(int T_, int B, int K, int H, const T* __restrict__ ik,
                    const T* __restrict__ he, const T* __restrict__ w,
                    const T* __restrict__ bias, T* __restrict__ e) {
  const int b = blockIdx.x, t0 = blockIdx.y * kTT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nt = min(kTT, T_ - t0);
  const float bv = bias != nullptr ? ld(bias, 0) : 0.f;
  const long row = (long)B * H;  // h_emb's stride between time steps
  const T* heb = he + (long)t0 * row + (long)b * H;
  for (int k = warp; k < K; k += kFwdThreads / 32) {
    const T* ikr = ik + ((long)b * K + k) * H;
    float acc[kTT];
#pragma unroll
    for (int j = 0; j < kTT; ++j) acc[j] = 0.f;
    for (int h = lane; h < H; h += 32) {
      const float a = ld(ikr, h), wv = ld(w, h);
#pragma unroll
      for (int j = 0; j < kTT; ++j)
        if (j < nt) acc[j] = fmaf(z_of<T>(a, ld(heb, j * row + h)), wv, acc[j]);
    }
#pragma unroll
    for (int j = 0; j < kTT; ++j) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], off);
    }
    if (lane == 0) {
      for (int j = 0; j < nt; ++j) {
        float v = rnd<T>(acc[j]);
        if (bias != nullptr) v = __fadd_rn(v, bv);
        put(e, ((long)(t0 + j) * B + b) * K + k, v);
      }
    }
  }
}

template <typename T>
__global__ void attn_scores_bwd(int T_, int B, int K, int H, const T* __restrict__ ik,
                                const T* __restrict__ he, const T* __restrict__ w,
                                const T* __restrict__ de, int dh_code, void* __restrict__ dh,
                                int dk_code, void* __restrict__ dk,
                                float* __restrict__ dw_part) {
  extern __shared__ float dks[];  // [K][HT]: this block's dimg_k sums
  const int HT = blockDim.x, tid = threadIdx.x;
  const int b = blockIdx.x, h = blockIdx.y * HT + tid;
  if (h >= H) return;  // a column past the edge: no other thread reads its sums
  for (int k = 0; k < K; ++k) dks[k * HT + tid] = 0.f;
  const float wv = ld(w, h);
  const T* ikc = ik + (long)b * K * H + h;  // img_k[b, k, h] at ikc[k * H]
  float dw_acc = 0.f;
  for (int t = 0; t < T_; ++t) {
    const long tb = (long)t * B + b;
    const float hv = ld(he, tb * H + h);
    const T* der = de + tb * K;  // the same address across the block: a broadcast
    float dh_acc = 0.f;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const float d = ld(der, k);
      const float z = z_of<T>(ld(ikc, (long)k * H), hv);
      dw_acc += rnd<T>(__fmul_rn(z, d));
      const float one_m_z2 = rnd<T>(__fsub_rn(1.f, rnd<T>(__fmul_rn(z, z))));
      const float dz = rnd<T>(__fmul_rn(rnd<T>(__fmul_rn(d, wv)), one_m_z2));
      dh_acc += dz;
      dks[k * HT + tid] += dz;
    }
    store(dh, dh_code, tb * H + h, dh_acc);
  }
  for (int k = 0; k < K; ++k) store(dk, dk_code, ((long)b * K + k) * H + h, dks[k * HT + tid]);
  dw_part[(long)b * H + h] = dw_acc;
}

// Blocks [0, ceil(H / kReduceThreads)): dw[h] = sum_b dw_part[b, h], in b
// order. The block after them, when db is given: db = sum of the n de values.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
    attn_scores_dw_reduce(int B, int H, const float* __restrict__ dw_part, int dw_code,
                   void* __restrict__ dw, const T* __restrict__ de, long n, int db_code,
                   void* __restrict__ db) {
  const int hb = (H + kReduceThreads - 1) / kReduceThreads;
  if ((int)blockIdx.x < hb) {
    const int h = blockIdx.x * kReduceThreads + threadIdx.x;
    if (h >= H) return;
    float s = 0.f;
    for (int i = 0; i < B; ++i) s += dw_part[(long)i * H + h];
    store(dw, dw_code, h, s);
    return;
  }
  __shared__ float part[kReduceThreads];
  float s = 0.f;
  for (long i = threadIdx.x; i < n; i += kReduceThreads) s += ld(de, i);
  part[threadIdx.x] = s;
  __syncthreads();
  for (int half = kReduceThreads / 2; half > 0; half >>= 1) {
    if ((int)threadIdx.x < half) part[threadIdx.x] += part[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) store(db, db_code, 0, part[0]);
}

// Columns a backward block takes for K slots, and its shared bytes: the
// widest of 128, 64, 32 whose sums fit the 48 KB a block gets without the
// opt-in; beyond, 32 columns and the opt-in (0 when even that does not fit).
inline int bwd_columns(int K, size_t* smem) {
  for (int ht = 128; ht >= 32; ht >>= 1) {
    *smem = (size_t)K * ht * sizeof(float);
    if (*smem <= 48 * 1024) return ht;
  }
  return *smem <= kMaxDynamicSmem ? 32 : 0;
}

template <typename T>
cudaError_t launch_fwd(int T_, int B, int K, int H, const void* ik, const void* he,
                       const void* w, const void* bias, void* e, cudaStream_t stream) {
  const dim3 grid(B, (T_ + kTT - 1) / kTT);
  attn_scores_fwd<T><<<grid, kFwdThreads, 0, stream>>>(
      T_, B, K, H, static_cast<const T*>(ik), static_cast<const T*>(he),
      static_cast<const T*>(w), static_cast<const T*>(bias), static_cast<T*>(e));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(int T_, int B, int K, int H, const void* ik, const void* he,
                       const void* w, const void* de, int dh_code, void* dh, int dk_code,
                       void* dk, float* dw_part, int dw_code, void* dw, int db_code,
                       void* db, cudaStream_t stream) {
  size_t smem = 0;
  const int ht = bwd_columns(K, &smem);
  if (ht == 0) return cudaErrorInvalidValue;
  if (smem > 48 * 1024 && !raise_smem_limit(attn_scores_bwd<T>)) return cudaGetLastError();
  const dim3 grid(B, (H + ht - 1) / ht);
  attn_scores_bwd<T><<<grid, ht, smem, stream>>>(
      T_, B, K, H, static_cast<const T*>(ik), static_cast<const T*>(he),
      static_cast<const T*>(w), static_cast<const T*>(de), dh_code, dh, dk_code, dk, dw_part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int blocks = (H + kReduceThreads - 1) / kReduceThreads + (db != nullptr ? 1 : 0);
  attn_scores_dw_reduce<T><<<blocks, kReduceThreads, 0, stream>>>(
      B, H, dw_part, dw_code, dw, static_cast<const T*>(de), (long)T_ * B * K, db_code, db);
  return cudaGetLastError();
}

inline bool storage_ok(int code) { return code == kF32 || code == kBF16; }

}  // namespace attn
}  // namespace capk

extern "C" {

// e[T, B, K] (dtype) = tanh(img_k[B, K, H] + h_emb[T, B, H]) @ w[H] + bias[1];
// every operand contiguous and of dtype (float32 or bf16); bias may be null.
// Returns cudaGetLastError() (cudaErrorInvalidValue for shapes or dtypes the
// kernel does not take).
int capk_attn_scores(int dtype, int T, int B, int K, int H, const void* img_k,
                     const void* h_emb, const void* w, const void* bias, void* e,
                     cudaStream_t stream) {
  if (T < 1 || B < 1 || K < 1 || H < 1 || !capk::attn::storage_ok(dtype))
    return (int)cudaErrorInvalidValue;
  return (int)(dtype == capk::kBF16
                   ? capk::attn::launch_fwd<__nv_bfloat16>(T, B, K, H, img_k, h_emb, w, bias,
                                                           e, stream)
                   : capk::attn::launch_fwd<float>(T, B, K, H, img_k, h_emb, w, bias, e,
                                                   stream));
}

// The backward of capk_attn_scores for de[T, B, K] (dtype): dh[T, B, H],
// dk[B, K, H], dw[H] and db[1] (db may be null), each stored as float32 or
// bf16 by its own code; dw_part holds B x H floats of scratch.
int capk_attn_scores_bwd(int dtype, int T, int B, int K, int H, const void* img_k,
                         const void* h_emb, const void* w, const void* de, int dh_code,
                         void* dh, int dk_code, void* dk, float* dw_part, int dw_code, void* dw,
                         int db_code, void* db, cudaStream_t stream) {
  using capk::attn::storage_ok;
  if (T < 1 || B < 1 || K < 1 || H < 1 || !storage_ok(dtype) || !storage_ok(dh_code) ||
      !storage_ok(dk_code) || !storage_ok(dw_code) || (db != nullptr && !storage_ok(db_code)))
    return (int)cudaErrorInvalidValue;
  return (int)(dtype == capk::kBF16
                   ? capk::attn::launch_bwd<__nv_bfloat16>(T, B, K, H, img_k, h_emb, w, de,
                                                           dh_code, dh, dk_code, dk, dw_part,
                                                           dw_code, dw, db_code, db, stream)
                   : capk::attn::launch_bwd<float>(T, B, K, H, img_k, h_emb, w, de, dh_code,
                                                   dh, dk_code, dk, dw_part, dw_code, dw,
                                                   db_code, db, stream));
}

}  // extern "C"
