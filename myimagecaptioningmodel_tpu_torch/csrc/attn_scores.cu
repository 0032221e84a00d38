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
// sum before the tanh, z, z de, de w, z^2, 1 - z^2 and dz each round to T.
// Sums are float32 in a fixed order, so reruns give the same bits; no
// atomics.
//
// What bounds it on an H100: the tanh. One pass evaluates T B k H of them
// (218.4 M at the shape above), 52 µs at the special-function units' 16
// results a clock an SM; the bytes are ~22 MB forward and ~44 MB backward
// (7 and 13 µs at 3.35 TB/s), the elementwise operations 3 / 20 µs on the
// 32-bit lanes. So every operand stays on chip and the rest of an element's
// work has to fit beside its tanh: the special-function unit takes a warp's
// tanh in 8 clocks of its quarter SM. The bf16 path (the training step's) is
// built for that:
//
//   - the tanh is one tanh.approx.f32 (MUFU.TANH) on the bf16 sum, rounded
//     to bf16. Its relative error is up to 2^-11 (PTX ISA), under half a
//     bf16 ulp, so z is the plain version's or its bf16 neighbour;
//     chip_smoke.h_tanh_terms carries that through each sum. (The packed
//     tanh.approx.bf16x2 gives no more: it issues at half the rate, the same
//     16 results a clock an SM.)
//   - the elementwise operations are packed bf16x2 (add, mul, sub, each
//     rounded once as the plain version's op; explicit .rn, so that nothing
//     contracts into an fma), two elements an instruction;
//   - every sum runs on the tensor cores (mma.sync m16n8k16, bf16 operands,
//     float32 accumulators): z is formed straight in the A fragment's
//     registers, and the products that sum it are exact (by w, by 1 or 0).
//
//   1. attn_scores_fwd_bf16: grid (B, gy), 32 warps; block b takes image b,
//      and each warp a task of 16 rows (2 time steps x 8 slots) over all of
//      H: A = z rows, B = w in every column, 32 h a step (two mma), the h of
//      a lane's fragment registers permuted so that each of img_k's row, the
//      two h_emb rows and w arrives as one 16-byte load, the next step's in
//      flight. img_k[b] (98 KB) and h_emb[:, b] (68 KB) stay in L1 (no shared
//      memory: the carveout leaves L1 all of it), read from device memory
//      once, reused by the 17 time pairs and the 7 slot groups. Padded rows
//      (k >= K, an odd T's last pair) are computed on a real row and not
//      stored; 49 slots pad to 56.
//   2. attn_scores_bwd_bf16: grid (B, ceil(H / 128), ceil(k / 64)), 8 warps,
//      two blocks an SM; warp (b, 16 columns of H) keeps img_k's pairs for
//      its columns and up to 64 slots in registers and walks the time pairs:
//      z once per element, then dz and z de for a 16 x 16 tile (16 h x 2 t x
//      8 k, pairs along k) in A-fragment registers, and three mma: by a slot
//      selector into dimg_k's accumulators (which stay in registers over all
//      of T), by a time selector into dh_emb's (stored after each pair), by
//      ones into dw's. de is staged in shared memory 64 steps at a time,
//      h_emb's next pair is loaded while this one computes. One pass over the
//      inputs. More than 64 slots: each 64 a block, dh_emb's partial sums to
//      scratch and summed in slot order by attn_scores_dh_sum.
//   3. attn_scores_dw_reduce: dw[h] = sum of the B (times slot blocks)
//      partials in order; B more blocks sum each image's de (strided per
//      thread, then a tree in shared memory), and attn_scores_db_sum the B
//      partials (a warp, then a butterfly) for db.
//
// float32 keeps the FMA kernels: libm tanhf, products by __fmul_rn /
// __fsub_rn so nothing contracts into an FMA the plain version does not do:
//
//   attn_scores_fwd_f32: grid (B, ceil(T / 8)), 8 warps; warp w takes slots
//      w, w + 8, ..., each lane h = lane, lane + 32, ... and 8 float sums,
//      one per time step, ended by a butterfly; attn_scores_bwd_f32: thread
//      (b, h) owns one column, walks (t, k), and keeps dimg_k's sums in
//      shared memory (k up to 1,600).
//
// Any T, B, k, H >= 1; float32 or bf16 operands, the gradients' storage
// float32 or bf16 each.
#include "common.cuh"
#include "mma.cuh"

namespace capk {
namespace attn {

using bf16 = __nv_bfloat16;

constexpr int kReduceThreads = 256;

__device__ __forceinline__ void store(void* p, int code, long i, float v) {
  if (code == kBF16)
    static_cast<bf16*>(p)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(p)[i] = v;
}

// ---- float32 ----------------------------------------------------------------

constexpr int kTT = 8;            // time steps a forward block takes
constexpr int kFwdThreads = 256;  // 8 warps

__device__ __forceinline__ float z_f32(float a, float b) { return tanhf(__fadd_rn(a, b)); }

__global__ void __launch_bounds__(kFwdThreads)
    attn_scores_fwd_f32(int T_, int B, int K, int H, const float* __restrict__ ik,
                        const float* __restrict__ he, const float* __restrict__ w,
                        const float* __restrict__ bias, float* __restrict__ e) {
  const int b = blockIdx.x, t0 = blockIdx.y * kTT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nt = min(kTT, T_ - t0);
  const long row = (long)B * H;  // h_emb's stride between time steps
  const float* heb = he + (long)t0 * row + (long)b * H;
  for (int k = warp; k < K; k += kFwdThreads / 32) {
    const float* ikr = ik + ((long)b * K + k) * H;
    float acc[kTT];
#pragma unroll
    for (int j = 0; j < kTT; ++j) acc[j] = 0.f;
    for (int h = lane; h < H; h += 32) {
      const float a = ikr[h], wv = w[h];
#pragma unroll
      for (int j = 0; j < kTT; ++j)
        if (j < nt) acc[j] = fmaf(z_f32(a, heb[j * row + h]), wv, acc[j]);
    }
#pragma unroll
    for (int j = 0; j < kTT; ++j) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], off);
    }
    if (lane == 0) {
      for (int j = 0; j < nt; ++j)
        e[((long)(t0 + j) * B + b) * K + k] = bias != nullptr ? __fadd_rn(acc[j], bias[0]) : acc[j];
    }
  }
}

__global__ void attn_scores_bwd_f32(int T_, int B, int K, int H, const float* __restrict__ ik,
                                    const float* __restrict__ he, const float* __restrict__ w,
                                    const float* __restrict__ de, int dh_code,
                                    void* __restrict__ dh, int dk_code, void* __restrict__ dk,
                                    float* __restrict__ dw_part) {
  extern __shared__ float dks[];  // [K][HT]: this block's dimg_k sums
  const int HT = blockDim.x, tid = threadIdx.x;
  const int b = blockIdx.x, h = blockIdx.y * HT + tid;
  if (h >= H) return;  // a column past the edge: no other thread reads its sums
  for (int k = 0; k < K; ++k) dks[k * HT + tid] = 0.f;
  const float wv = w[h];
  const float* ikc = ik + (long)b * K * H + h;  // img_k[b, k, h] at ikc[k * H]
  float dw_acc = 0.f;
  for (int t = 0; t < T_; ++t) {
    const long tb = (long)t * B + b;
    const float hv = he[tb * H + h];
    const float* der = de + tb * K;  // the same address across the block: a broadcast
    float dh_acc = 0.f;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const float d = der[k];
      const float z = z_f32(ikc[(long)k * H], hv);
      dw_acc += __fmul_rn(z, d);
      const float dz = __fmul_rn(__fmul_rn(d, wv), __fsub_rn(1.f, __fmul_rn(z, z)));
      dh_acc += dz;
      dks[k * HT + tid] += dz;
    }
    store(dh, dh_code, tb * H + h, dh_acc);
  }
  for (int k = 0; k < K; ++k) store(dk, dk_code, ((long)b * K + k) * H + h, dks[k * HT + tid]);
  dw_part[(long)b * H + h] = dw_acc;
}

// Columns a float32 backward block takes for K slots, and its shared bytes:
// the widest of 128, 64, 32 whose sums fit the 48 KB a block gets without
// the opt-in; beyond, 32 columns and the opt-in (0 when even that does not
// fit).
inline int bwd_columns_f32(int K, size_t* smem) {
  for (int ht = 128; ht >= 32; ht >>= 1) {
    *smem = (size_t)K * ht * sizeof(float);
    if (*smem <= 48 * 1024) return ht;
  }
  return *smem <= kMaxDynamicSmem ? 32 : 0;
}

// ---- bf16 -------------------------------------------------------------------

constexpr int kFwdWarps = 32;  // a forward block: 32 row tasks at a time
constexpr int kBwdWarps = 8;   // a backward block: 8 x 16 columns of H
constexpr int kBwdGroups = 8;  // slot groups of 8 a backward block takes
constexpr int kBwdSlots = 8 * kBwdGroups;
constexpr int kDeSteps = 64;   // time steps of de staged at a time (even)
constexpr uint32_t kOnes = 0x3f803f80u;  // (1, 1) in bf16

// Packed bf16 arithmetic, each element rounded once to nearest even. The
// explicit .rn keeps ptxas from contracting a product and a sum into one
// fma (it did, for 1 - z^2, through __hmul2 and __hsub2).
__device__ __forceinline__ uint32_t add2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t sub2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("sub.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t mul2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// tanh on the special-function unit (MUFU.TANH)
__device__ __forceinline__ float tanh_mufu(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// z of two elements: the bf16 sum, its tanh, rounded to bf16 (the low
// element is the low half, as in memory)
__device__ __forceinline__ uint32_t z_pair(uint32_t a, uint32_t b) {
  const uint32_t x = add2(a, b);
  return pack_bf16x2(tanh_mufu(__uint_as_float(x << 16)),
                     tanh_mufu(__uint_as_float(x & 0xffff0000u)));
}

__device__ __forceinline__ uint32_t bits(const bf16* p, long i) {
  return __ldg(reinterpret_cast<const unsigned short*>(p) + i);
}
// the element twice, in both halves
__device__ __forceinline__ uint32_t dup(uint32_t v) { return v | (v << 16); }

// p[h .. h + 7] as 16 bytes, zero past n. VEC: n % 8 == 0 and p 16-byte
// aligned, one load; else element by element.
template <bool VEC>
__device__ __forceinline__ uint4 load8(const bf16* __restrict__ p, int h, int n) {
  if constexpr (VEC) {
    return h < n ? __ldg(reinterpret_cast<const uint4*>(p + h)) : make_uint4(0, 0, 0, 0);
  } else {
    uint32_t q[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = h + 2 * i;
      q[i] = (j < n ? bits(p, j) : 0u) | ((j + 1 < n ? bits(p, j + 1) : 0u) << 16);
    }
    return make_uint4(q[0], q[1], q[2], q[3]);
  }
}

template <typename D>
__device__ __forceinline__ D to(float v);
template <>
__device__ __forceinline__ float to<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ bf16 to<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Row task (t0, t0 + 1) x (k0 .. k0 + 7) of image b: lane (g, c) holds rows
// g = (t0, k0 + g) and g + 8 = (t0 + 1, k0 + g) of the A fragment; a step
// takes h0 .. h0 + 31, and lane c's columns are h0 + 8c .. 8c + 3 (first
// mma) and 8c + 4 .. 8c + 7 (second), whose img_k, h_emb and w values are
// one 16-byte load each. B holds w in every column.
template <bool VEC>
__global__ void __launch_bounds__(kFwdWarps * 32)
    attn_scores_fwd_bf16(int T_, int B, int K, int H, const bf16* __restrict__ ik,
                         const bf16* __restrict__ he, const bf16* __restrict__ w,
                         const bf16* __restrict__ bias, bf16* __restrict__ e) {
  const int b = blockIdx.x, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int groups = (K + 7) >> 3, tasks = ((T_ + 1) >> 1) * groups;
  const float bv = bias != nullptr ? __bfloat162float(bias[0]) : 0.f;
  for (int task = blockIdx.y * kFwdWarps + warp; task < tasks; task += gridDim.y * kFwdWarps) {
    const int t0 = 2 * (task / groups), k = (task % groups) * 8 + g;
    const bool second = t0 + 1 < T_;
    // rows past the edge read a real row and are not stored
    const bf16* ikr = ik + ((long)b * K + min(k, K - 1)) * H;
    const bf16* h0r = he + ((long)t0 * B + b) * H;
    const bf16* h1r = he + ((long)(second ? t0 + 1 : t0) * B + b) * H;
    float d0[4] = {0.f, 0.f, 0.f, 0.f}, d1[4] = {0.f, 0.f, 0.f, 0.f};
    const auto step = [&](const uint4& a, const uint4& p, const uint4& q, const uint4& wv) {
      const uint32_t f0[4] = {z_pair(a.x, p.x), z_pair(a.x, q.x), z_pair(a.y, p.y),
                              z_pair(a.y, q.y)};
      mma_bf16(d0, f0, wv.x, wv.y);
      const uint32_t f1[4] = {z_pair(a.z, p.z), z_pair(a.z, q.z), z_pair(a.w, p.w),
                              z_pair(a.w, q.w)};
      mma_bf16(d1, f1, wv.z, wv.w);
    };
    // whole steps (every lane's 8 columns inside H) load 16 bytes a row
    // unmasked, the next step's loads in flight during this one's tanh
    const int whole = VEC ? H / 32 : 0;
    if (whole > 0) {
      const uint4 *ra = reinterpret_cast<const uint4*>(ikr) + c,
                  *rp = reinterpret_cast<const uint4*>(h0r) + c,
                  *rq = reinterpret_cast<const uint4*>(h1r) + c,
                  *rw = reinterpret_cast<const uint4*>(w) + c;
      uint4 a = __ldg(ra), p = __ldg(rp), q = __ldg(rq), wv = __ldg(rw);
#pragma unroll 2
      for (int s = 1; s <= whole; ++s) {
        uint4 na = a, np = p, nq = q, nw = wv;
        if (s < whole) {
          na = __ldg(ra + 4 * s), np = __ldg(rp + 4 * s), nq = __ldg(rq + 4 * s);
          nw = __ldg(rw + 4 * s);
        }
        step(a, p, q, wv);
        a = na, p = np, q = nq, wv = nw;
      }
    }
    for (int h = 32 * whole + 8 * c; h - 8 * c < H; h += 32)  // the rest, masked
      step(load8<VEC>(ikr, h, H), load8<VEC>(h0r, h, H), load8<VEC>(h1r, h, H),
           load8<VEC>(w, h, H));
    if (c == 0 && k < K) {  // column 0: rows g (t0, k) and g + 8 (t0 + 1, k)
      float v = round_bf16(d0[0] + d1[0]);
      if (bias != nullptr) v = __fadd_rn(v, bv);
      e[((long)t0 * B + b) * K + k] = __float2bfloat16_rn(v);
      if (second) {
        v = round_bf16(d0[2] + d1[2]);
        if (bias != nullptr) v = __fadd_rn(v, bv);
        e[((long)(t0 + 1) * B + b) * K + k] = __float2bfloat16_rn(v);
      }
    }
  }
}

// Warp (b, columns h0 .. h0 + 15, slots k0 .. k0 + 63). The A fragment of a
// tile is 16 h x (2 t x 8 k): lane (g, c) holds h = h0 + g (a0, a2) and
// h0 + g + 8 (a1, a3), at t0 (a0, a1) and t0 + 1 (a2, a3), each register
// the pair k = 2c, 2c + 1 of the group. The selectors (B, 16 x 8): column
// n takes slot n of both times (dimg_k), or time n of every slot (dh_emb,
// columns 0 and 1), or everything (dw). img_k's pairs and dimg_k's sums
// stay in registers over all of T; de waits in shared memory 64 steps at a
// time; h_emb is loaded a time pair ahead. DH: dh_emb's storage, or float
// partial sums of a slot block.
template <typename DH>
__global__ void __launch_bounds__(kBwdWarps * 32, 2)
    attn_scores_bwd_bf16(int T_, int B, int K, int H, const bf16* __restrict__ ik,
                         const bf16* __restrict__ he, const bf16* __restrict__ w,
                         const bf16* __restrict__ de, DH* __restrict__ dh, int dk_code,
                         void* __restrict__ dk, float* __restrict__ dw_part) {
  constexpr int kPairs = kBwdSlots / 2;
  __shared__ uint32_t des[kDeSteps * kPairs];  // de pairs [t][k / 2], zero past the edge
  const int b = blockIdx.x, chunk = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int h0 = (blockIdx.y * kBwdWarps + warp) * 16, hA = h0 + g, hB = hA + 8;
  const int k0 = chunk * kBwdSlots, groups = min(kBwdGroups, (K - k0 + 7) >> 3);
  const bool live = h0 < H, inA = hA < H, inB = hB < H;
  const long BH = (long)B * H;
  dh += (long)chunk * T_ * BH + (long)b * H + hA;  // dh_emb[t, b, hA] at dh[t BH]
  const bf16* heA = he + (long)b * H + hA;         // h_emb[t, b, hA] at heA[t BH]

  uint32_t ikA[kBwdGroups], ikB[kBwdGroups];
  float dk_acc[kBwdGroups][4];
#pragma unroll
  for (int j = 0; j < kBwdGroups; ++j) {
    const int k = k0 + 8 * j + 2 * c;
    const long r0 = ((long)b * K + k) * H, r1 = r0 + H;
    const bool k0in = j < groups && k < K, k1in = j < groups && k + 1 < K;
    ikA[j] = (k0in && inA ? bits(ik, r0 + hA) : 0u) |
             ((k1in && inA ? bits(ik, r1 + hA) : 0u) << 16);
    ikB[j] = (k0in && inB ? bits(ik, r0 + hB) : 0u) |
             ((k1in && inB ? bits(ik, r1 + hB) : 0u) << 16);
#pragma unroll
    for (int i = 0; i < 4; ++i) dk_acc[j][i] = 0.f;
  }
  const uint32_t wA = inA ? dup(bits(w, hA)) : 0u, wB = inB ? dup(bits(w, hB)) : 0u;
  const uint32_t sel_k = (2 * c == g ? 0x3f80u : 0u) | (2 * c + 1 == g ? 0x3f800000u : 0u);
  const uint32_t sel_t0 = g == 0 ? kOnes : 0u, sel_t1 = g == 1 ? kOnes : 0u;
  float dw_acc[4] = {0.f, 0.f, 0.f, 0.f};

  // h_emb at (t, hA) and (t, hB), zero past the edge, raw: loaded a time
  // pair ahead, put in both halves (dup) when its pair comes
  uint32_t nx[2][2];
  const auto he_raw = [&](int t, uint32_t(&v)[2]) {
    const bf16* r = heA + t * BH;
    v[0] = t < T_ && inA ? bits(r, 0) : 0u;
    v[1] = t < T_ && inB ? bits(r, 8) : 0u;
  };
  he_raw(0, nx[0]);
  he_raw(1, nx[1]);

  for (int ts = 0; ts < T_; ts += kDeSteps) {
    __syncthreads();  // the previous steps' de is read
#pragma unroll
    for (int i = threadIdx.x; i < kDeSteps * kPairs; i += kBwdWarps * 32) {
      const int t = ts + i / kPairs, k = k0 + 2 * (i % kPairs);
      const long r = ((long)t * B + b) * K;
      des[i] = t < T_ ? (k < K ? bits(de, r + k) : 0u) |
                            (k + 1 < K ? bits(de, r + k + 1) << 16 : 0u)
                      : 0u;
    }
    __syncthreads();
    if (!live) continue;
    for (int t0 = ts; t0 < min(ts + kDeSteps, T_); t0 += 2) {
      const uint32_t hA0 = dup(nx[0][0]), hB0 = dup(nx[0][1]);
      const uint32_t hA1 = dup(nx[1][0]), hB1 = dup(nx[1][1]);
      he_raw(t0 + 2, nx[0]);
      he_raw(t0 + 3, nx[1]);
      const uint32_t* dr = des + (t0 - ts) * kPairs + c;
      float dh_acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < kBwdGroups; ++j) {
        if (j >= groups) break;
        const uint32_t de0 = dr[4 * j], de1 = dr[kPairs + 4 * j];
        const uint32_t z[4] = {z_pair(ikA[j], hA0), z_pair(ikB[j], hB0), z_pair(ikA[j], hA1),
                               z_pair(ikB[j], hB1)};
        const uint32_t dew[4] = {mul2(de0, wA), mul2(de0, wB), mul2(de1, wA), mul2(de1, wB)};
        const uint32_t zde[4] = {mul2(z[0], de0), mul2(z[1], de0), mul2(z[2], de1),
                                 mul2(z[3], de1)};
        uint32_t dz[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) dz[i] = mul2(dew[i], sub2(kOnes, mul2(z[i], z[i])));
        mma_bf16(dk_acc[j], dz, sel_k, sel_k);
        mma_bf16(dh_acc, dz, sel_t0, sel_t1);
        mma_bf16(dw_acc, zde, kOnes, kOnes);
      }
      if (c == 0) {  // columns 0, 1: (hA, t0), (hA, t0 + 1), (hB, t0), (hB, t0 + 1)
        DH* r = dh + t0 * BH;
        if (inA) r[0] = to<DH>(dh_acc[0]);
        if (inB) r[8] = to<DH>(dh_acc[2]);
        if (t0 + 1 < T_) {
          if (inA) r[BH] = to<DH>(dh_acc[1]);
          if (inB) r[BH + 8] = to<DH>(dh_acc[3]);
        }
      }
    }
  }
  if (!live) return;
#pragma unroll
  for (int j = 0; j < kBwdGroups; ++j) {
    if (j >= groups) break;
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // (hA, 2c), (hA, 2c + 1), (hB, 2c), (hB, 2c + 1)
      const int k = k0 + 8 * j + 2 * c + (i & 1), h = i < 2 ? hA : hB;
      if (k < K && h < H) store(dk, dk_code, ((long)b * K + k) * H + h, dk_acc[j][i]);
    }
  }
  if (c == 0) {  // every column holds the sum: rows hA (c0) and hB (c2)
    const long o = ((long)chunk * B + b) * H;
    if (inA) dw_part[o + hA] = dw_acc[0];
    if (inB) dw_part[o + hB] = dw_acc[2];
  }
}

// dh_emb[i] = sum over the slot blocks of their partial sums, in order.
__global__ void __launch_bounds__(kReduceThreads)
    attn_scores_dh_sum(long n, int chunks, const float* __restrict__ part, int code,
                       void* __restrict__ dh) {
  for (long i = (long)blockIdx.x * kReduceThreads + threadIdx.x; i < n;
       i += (long)gridDim.x * kReduceThreads) {
    float s = 0.f;
    for (int c = 0; c < chunks; ++c) s += part[c * n + i];
    store(dh, code, i, s);
  }
}

// Blocks [0, ceil(H / kReduceThreads)): dw[h] = sum of the R partials
// dw_part[r, h], in r order. The B blocks after them, when db_part is
// given: image i's T x K de values, strided per thread then a tree in
// shared memory, into db_part[i].
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
    attn_scores_dw_reduce(int R, int H, const float* __restrict__ dw_part, int dw_code,
                          void* __restrict__ dw, int T_, int B, int K, const T* __restrict__ de,
                          float* __restrict__ db_part) {
  const int hb = (H + kReduceThreads - 1) / kReduceThreads;
  if ((int)blockIdx.x < hb) {
    const int h = blockIdx.x * kReduceThreads + threadIdx.x;
    if (h >= H) return;
    float s = 0.f;
#pragma unroll 8
    for (int i = 0; i < R; ++i) s += dw_part[(long)i * H + h];
    store(dw, dw_code, h, s);
    return;
  }
  const int i = blockIdx.x - hb;
  __shared__ float part[kReduceThreads];
  float s = 0.f;
#pragma unroll 4
  for (int j = threadIdx.x; j < T_ * K; j += kReduceThreads)
    s += ld(de, ((long)(j / K) * B + i) * K + j % K);
  part[threadIdx.x] = s;
  __syncthreads();
  for (int half = kReduceThreads / 2; half > 0; half >>= 1) {
    if ((int)threadIdx.x < half) part[threadIdx.x] += part[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) db_part[i] = part[0];
}

// db = sum of the B images' partials: one warp, lane l summing l, l + 32,
// ... in order, then a butterfly.
__global__ void attn_scores_db_sum(int B, const float* __restrict__ db_part, int db_code,
                                   void* __restrict__ db) {
  float s = 0.f;
  for (int i = threadIdx.x; i < B; i += 32) s += db_part[i];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (threadIdx.x == 0) store(db, db_code, 0, s);
}

// Slot blocks of the bf16 backward (1 for float32).
inline int bwd_chunks(int dtype, int K) {
  return dtype == kBF16 ? (K + kBwdSlots - 1) / kBwdSlots : 1;
}

// Float32 scratch of the backward, in rows of B x H floats: dw's partial
// sums (a row a slot block), with more than one slot block T rows more of
// each for dh_emb's partial sums, and a last row for db's B partials.
inline int scratch_rows(int dtype, int T_, int K) {
  const int chunks = bwd_chunks(dtype, K);
  return chunks + (chunks > 1 ? chunks * T_ : 0) + 1;
}

inline int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return n;
}

template <bool VEC>
cudaError_t launch_fwd_bf16(int T_, int B, int K, int H, const bf16* ik, const bf16* he,
                            const bf16* w, const bf16* bias, bf16* e, cudaStream_t stream) {
  static const cudaError_t carved = cudaFuncSetAttribute(
      attn_scores_fwd_bf16<VEC>, cudaFuncAttributePreferredSharedMemoryCarveout,
      0);  // no shared memory: L1 takes all of it
  if (carved != cudaSuccess) return carved;
  // one block an image while the card has SMs for them: the image's rows
  // then share one L1; blocks of a small batch split its row tasks
  const int tasks = ((T_ + 1) / 2) * ((K + 7) / 8);
  const int gy = max(1, min((tasks + kFwdWarps - 1) / kFwdWarps, sm_count() / B));
  attn_scores_fwd_bf16<VEC><<<dim3(B, gy), kFwdWarps * 32, 0, stream>>>(T_, B, K, H, ik, he, w,
                                                                         bias, e);
  return cudaGetLastError();
}

cudaError_t launch_fwd(int dtype, int T_, int B, int K, int H, const void* ik, const void* he,
                       const void* w, const void* bias, void* e, cudaStream_t stream) {
  if (dtype == kF32) {
    attn_scores_fwd_f32<<<dim3(B, (T_ + kTT - 1) / kTT), kFwdThreads, 0, stream>>>(
        T_, B, K, H, static_cast<const float*>(ik), static_cast<const float*>(he),
        static_cast<const float*>(w), static_cast<const float*>(bias), static_cast<float*>(e));
    return cudaGetLastError();
  }
  const auto aligned = [](const void* p) { return p == nullptr || (uintptr_t)p % 16 == 0; };
  const bf16 *ikb = static_cast<const bf16*>(ik), *heb = static_cast<const bf16*>(he),
             *wb = static_cast<const bf16*>(w), *bb = static_cast<const bf16*>(bias);
  bf16* eb = static_cast<bf16*>(e);
  if (H % 8 == 0 && aligned(ik) && aligned(he) && aligned(w))
    return launch_fwd_bf16<true>(T_, B, K, H, ikb, heb, wb, bb, eb, stream);
  return launch_fwd_bf16<false>(T_, B, K, H, ikb, heb, wb, bb, eb, stream);
}

cudaError_t launch_bwd(int dtype, int T_, int B, int K, int H, const void* ik, const void* he,
                       const void* w, const void* de, int dh_code, void* dh, int dk_code,
                       void* dk, float* scratch, int dw_code, void* dw, int db_code, void* db,
                       cudaStream_t stream) {
  const int chunks = bwd_chunks(dtype, K);
  if (dtype == kF32) {
    size_t smem = 0;
    const int ht = bwd_columns_f32(K, &smem);
    if (ht == 0) return cudaErrorInvalidValue;
    if (smem > 48 * 1024 && !raise_smem_limit(attn_scores_bwd_f32)) return cudaGetLastError();
    attn_scores_bwd_f32<<<dim3(B, (H + ht - 1) / ht), ht, smem, stream>>>(
        T_, B, K, H, static_cast<const float*>(ik), static_cast<const float*>(he),
        static_cast<const float*>(w), static_cast<const float*>(de), dh_code, dh, dk_code, dk,
        scratch);
  } else {
    const dim3 grid(B, (H + 16 * kBwdWarps - 1) / (16 * kBwdWarps), chunks);
    const auto run = [&](auto* dh_out) {
      attn_scores_bwd_bf16<<<grid, kBwdWarps * 32, 0, stream>>>(
          T_, B, K, H, static_cast<const bf16*>(ik), static_cast<const bf16*>(he),
          static_cast<const bf16*>(w), static_cast<const bf16*>(de), dh_out, dk_code, dk,
          scratch);
    };
    if (chunks > 1)  // dh_emb's partial sums of each slot block, summed below
      run(scratch + (long)chunks * B * H);
    else if (dh_code == kBF16)
      run(static_cast<bf16*>(dh));
    else
      run(static_cast<float*>(dh));
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (chunks > 1) {
    const long n = (long)T_ * B * H;
    const int blocks = (int)min((n + kReduceThreads - 1) / kReduceThreads, 4096L);
    attn_scores_dh_sum<<<blocks, kReduceThreads, 0, stream>>>(
        n, chunks, scratch + (long)chunks * B * H, dh_code, dh);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  float* db_part =
      db != nullptr ? scratch + (long)(scratch_rows(dtype, T_, K) - 1) * B * H : nullptr;
  const int blocks = (H + kReduceThreads - 1) / kReduceThreads + (db != nullptr ? B : 0);
  if (dtype == kBF16)
    attn_scores_dw_reduce<bf16><<<blocks, kReduceThreads, 0, stream>>>(
        chunks * B, H, scratch, dw_code, dw, T_, B, K, static_cast<const bf16*>(de), db_part);
  else
    attn_scores_dw_reduce<float><<<blocks, kReduceThreads, 0, stream>>>(
        B, H, scratch, dw_code, dw, T_, B, K, static_cast<const float*>(de), db_part);
  err = cudaGetLastError();
  if (err != cudaSuccess || db == nullptr) return err;
  attn_scores_db_sum<<<1, 32, 0, stream>>>(B, db_part, db_code, db);
  return cudaGetLastError();
}

inline bool storage_ok(int code) { return code == kF32 || code == kBF16; }

__global__ void tanh_probe(const bf16* __restrict__ x, float* __restrict__ t, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) t[i] = tanh_mufu(__bfloat162float(x[i]));
}

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
  return (int)capk::attn::launch_fwd(dtype, T, B, K, H, img_k, h_emb, w, bias, e, stream);
}

// Float32 scratch the backward takes, in rows of B x H floats.
int capk_attn_scores_bwd_scratch_rows(int dtype, int T, int K) {
  return capk::attn::scratch_rows(dtype, T, K);
}

// The backward of capk_attn_scores for de[T, B, K] (dtype): dh[T, B, H],
// dk[B, K, H], dw[H] and db[1] (db may be null), each stored as float32 or
// bf16 by its own code; scratch holds capk_attn_scores_bwd_scratch_rows x B
// x H floats.
int capk_attn_scores_bwd(int dtype, int T, int B, int K, int H, const void* img_k,
                         const void* h_emb, const void* w, const void* de, int dh_code,
                         void* dh, int dk_code, void* dk, float* scratch, int dw_code, void* dw,
                         int db_code, void* db, cudaStream_t stream) {
  using capk::attn::storage_ok;
  if (T < 1 || B < 1 || K < 1 || H < 1 || !storage_ok(dtype) || !storage_ok(dh_code) ||
      !storage_ok(dk_code) || !storage_ok(dw_code) || (db != nullptr && !storage_ok(db_code)))
    return (int)cudaErrorInvalidValue;
  return (int)capk::attn::launch_bwd(dtype, T, B, K, H, img_k, h_emb, w, de, dh_code, dh,
                                     dk_code, dk, scratch, dw_code, dw, db_code, db, stream);
}

// t[i] = tanh.approx.f32(x[i]) for n bf16 x: the bf16 kernels' tanh before
// its rounding, for reading its error on the card.
int capk_attn_tanh_bf16(const void* x, float* t, int n, cudaStream_t stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  capk::attn::tanh_probe<<<(n + 255) / 256, 256, 0, stream>>>(
      static_cast<const capk::attn::bf16*>(x), t, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
