// Train-mode batch norm's four passes (kernel I), over a channel-last
// activation x[M, C] (M = B*H*W rows, C channels, row-major):
//   bn_stats:     s[c] = sum_{m < rows} x[m, c], q[c] = sum x[m, c]^2
//   bn_apply:     mean = s / n, var = max(q / n - mean^2, 0),
//                 inv = 1 / sqrt(var + eps), y = (x - mean) * (inv * scale)
//                 + offset rounded to T, then clamp(y, 0, 6) with ACT
//   bn_grad_sums: g_off[c] = ratio * sum_{m < rows} dy'[m, c],
//                 g_sc[c] = ratio * sum dy'[m, c] * xhat[m, c],
//                 xhat = (x - mean) * inv, dy' = dy * relu6'(y) with ACT
//                 (y recomputed from x; relu6' is 1 in (0, 6), 1/2 at 0
//                 and at 6, 0 outside: the gradient of jnp.clip), else dy
//   bn_dx:        exact: dx = (scale * inv / n) * (n * dy' - g_off - xhat *
//                 g_sc); subset: dx = dy' * (scale * inv)
// T is float32, bfloat16 or float64; the statistics and every sum are float
// (double for float64 x), as the JAX package's.
//
// Replaces no Pallas kernel: the JAX package's hand-written BN VJP,
// myimagecaptioningmodel_tpu/ops/layers.py:188 _bn_train, :284
// _bn_train_subset and the BN half of ops/pallas/matmul_bn.py:120
// _conv1x1_bn_bwd, which XLA fuses into one read of the activation a pass
// (and the relu6 after it, layers.py:365, into the normalize pass). The
// wrappers (ops/kernels/batch_norm.py) split the four where a process group
// all-reduces its sums.
//
// What bounds it on an H100: bytes. Every pass is a few operations per
// element (bf16: 16 bytes an element over the four, 3.35 TB/s). The design
// streams: 16-byte vector loads and stores along C (8 bf16, 4 float32 or 2
// float64 channels a thread, where C and the addresses allow; else 4, 2 or
// 1), each thread on fixed channels so their per-channel constants live in
// registers, a block of 256 threads covering up to 32 vectors of a row and
// the rest of its threads the next rows (a warp's accesses contiguous), and
// about 4 blocks an SM (kTargetBlocks) over the rows at every shape of
// MobileNetV2 (M 6,272 .. 1,605,632 at B = 128, C 16 .. 1,280; any C >= 1).
// Each thread loads kUnroll rows ahead before it uses them.
//
// The two sums: each block adds its rows per channel (each thread its own
// rows in order, then the threads of a column in threadIdx.y order; in
// double for float32 and float64 x, in float for bf16, kernel F's policy)
// and writes one partial row; bn_merge adds the partial rows in a fixed
// order (in double). No atomics: the order depends on the shapes and the
// addresses' alignment only, so reruns give the same bits.
//
// Rounding: each operation is an explicit __f*_rn / __d*_rn in the plain
// version's order, so ptxas contracts nothing and bn_grad_sums / bn_dx
// recompute bit for bit the y that bn_apply stored (the ReLU6 ties), and y,
// dy' and dx round as the plain PyTorch versions do; only the sums' order
// differs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace capk {
namespace bn {

enum Code : int { kF32 = 0, kBF16 = 1, kF64 = 3 };

constexpr int kThreads = 256;
constexpr int kTargetBlocks = 4 * 132;
constexpr int kUnroll = 4;
constexpr int kMergeGroups = 8;

// S: the statistics' and parameters' type; R: the running sums' (double
// for float32 x, as kernel F's float32 statistics: within about one float32
// rounding of the exact sums, whatever the order; float for bf16 x)
template <typename T>
struct Acc {
  using S = float;
  using R = float;
};
template <>
struct Acc<float> {
  using S = float;
  using R = double;
};
template <>
struct Acc<double> {
  using S = double;
  using R = double;
};

// IEEE operations with their rounding pinned (no fma contraction)
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float fma(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ float root(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ double fma(double a, double b, double c) { return __fma_rn(a, b, c); }
__device__ __forceinline__ double root(double a) { return __dsqrt_rn(a); }

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ double widen(double v) { return v; }
template <typename T>
__device__ __forceinline__ T narrow(typename Acc<T>::S v) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return __float2bfloat16_rn(v);
  } else {
    return v;
  }
}

// V consecutive T, one aligned load or store
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

template <typename S>
__device__ __forceinline__ S eps() {
  return S(1e-5);  // float32: the float nearest 1e-5, as torch's var + 1e-5
}

// 1 / sqrt(var + eps), as torch.rsqrt(var + eps) on the CPU
template <typename S>
__device__ __forceinline__ S inv_std(S var) {
  return div(S(1), root(add(var, eps<S>())));
}

// the BN output before its activation, rounded to T
template <typename T, typename S>
__device__ __forceinline__ T normalized(S x, S mean, S a, S offset) {
  return narrow<T>(add(mul(sub(x, mean), a), offset));
}

// jnp.clip(y, 0, 6)'s gradient at the stored y
template <typename S>
__device__ __forceinline__ S relu6_slope(S y) {
  return (y > S(0) && y < S(6)) ? S(1) : ((y == S(0) || y == S(6)) ? S(0.5) : S(0));
}

// thread -> (first channel, live) for vector column blockIdx.x * tx + threadIdx.x
template <int V>
__device__ __forceinline__ int first_channel(int C, bool& live) {
  const int vc = blockIdx.x * blockDim.x + threadIdx.x;
  live = vc < C / V;
  return vc * V;
}

// Per-block partial sums over rows [blockIdx.y * chunk, + chunk) of the
// first `rows`: MODE 0 (x, x^2), MODE 1 (dy', dy' * xhat), in R. part holds
// two arrays of nparts x C: part[k * nparts * C + blockIdx.y * C + c].
template <typename T, int V, int MODE, bool ACT>
__global__ void __launch_bounds__(kThreads)
    bn_partials(const T* __restrict__ x, const T* __restrict__ dy, int C, long rows, long chunk,
                const typename Acc<T>::S* __restrict__ mean,
                const typename Acc<T>::S* __restrict__ var,
                const typename Acc<T>::S* __restrict__ scale,
                const typename Acc<T>::S* __restrict__ offset, typename Acc<T>::R* __restrict__ part,
                int nparts) {
  using S = typename Acc<T>::S;
  using R = typename Acc<T>::R;
  using P = Pack<T, V>;
  __shared__ R sh[2][kThreads * V];
  bool live;
  const int c0 = first_channel<V>(C, live);
  S m[V], inv[V], a[V], off[V];
  R acc0[V], acc1[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    acc0[j] = R(0);
    acc1[j] = R(0);
    m[j] = inv[j] = a[j] = off[j] = S(0);
  }
  if (MODE == 1 && live) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      m[j] = mean[c0 + j];
      inv[j] = inv_std(var[c0 + j]);
      a[j] = mul(inv[j], scale[c0 + j]);
      off[j] = offset[c0 + j];
    }
  }
  const long r0 = (long)blockIdx.y * chunk;
  const long r1 = r0 + chunk < rows ? r0 + chunk : rows;
  const long step = (long)blockDim.y;
  if (live) {
    for (long r = r0 + threadIdx.y; r < r1; r += step * kUnroll) {
      P xs[kUnroll], ds[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long rr = r + u * step;
        if (rr < r1) {
          xs[u] = *reinterpret_cast<const P*>(x + rr * C + c0);
          if (MODE == 1) ds[u] = *reinterpret_cast<const P*>(dy + rr * C + c0);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (r + u * step < r1) {
#pragma unroll
          for (int j = 0; j < V; ++j) {
            const S xv = widen(xs[u].v[j]);
            if (MODE == 0) {
              acc0[j] = add(acc0[j], R(xv));
              acc1[j] = fma(R(xv), R(xv), acc1[j]);
            } else {
              S d = widen(ds[u].v[j]);
              if (ACT) d = mul(d, relu6_slope<S>(widen(normalized<T, S>(xv, m[j], a[j], off[j]))));
              acc0[j] = add(acc0[j], R(d));
              acc1[j] = fma(R(d), R(mul(sub(xv, m[j]), inv[j])), acc1[j]);
            }
          }
        }
      }
    }
  }
  const int width = blockDim.x * V;  // channels of this block's columns
#pragma unroll
  for (int j = 0; j < V; ++j) {
    sh[0][threadIdx.y * width + threadIdx.x * V + j] = acc0[j];
    sh[1][threadIdx.y * width + threadIdx.x * V + j] = acc1[j];
  }
  __syncthreads();
  const int t = threadIdx.y * blockDim.x + threadIdx.x;
  const int c = blockIdx.x * width + t;
  if (t < width && c < C) {
    R s0 = R(0), s1 = R(0);
    for (int y = 0; y < (int)blockDim.y; ++y) {
      s0 = add(s0, sh[0][y * width + t]);
      s1 = add(s1, sh[1][y * width + t]);
    }
    part[(long)blockIdx.y * C + c] = s0;
    part[((long)nparts + blockIdx.y) * C + c] = s1;
  }
}

// out0[c] = ratio * sum_p part[p, c], out1 likewise over the second array:
// warps on 32 channels, kMergeGroups groups over the partial rows, then the
// groups in order; in double, rounded once to S before the ratio.
template <typename S, typename R>
__global__ void __launch_bounds__(32 * kMergeGroups)
    bn_merge(const R* __restrict__ part, int nparts, int C, S ratio, S* __restrict__ out0,
             S* __restrict__ out1) {
  __shared__ double sh[2][kMergeGroups][32];
  const int c = blockIdx.x * 32 + threadIdx.x;
  double s0 = 0.0, s1 = 0.0;
  if (c < C) {
    for (int p = threadIdx.y; p < nparts; p += kMergeGroups) {
      s0 += (double)part[(long)p * C + c];
      s1 += (double)part[((long)nparts + p) * C + c];
    }
  }
  sh[0][threadIdx.y][threadIdx.x] = s0;
  sh[1][threadIdx.y][threadIdx.x] = s1;
  __syncthreads();
  if (threadIdx.y == 0 && c < C) {
    s0 = 0.0;
    s1 = 0.0;
    for (int g = 0; g < kMergeGroups; ++g) {
      s0 = __dadd_rn(s0, sh[0][g][threadIdx.x]);
      s1 = __dadd_rn(s1, sh[1][g][threadIdx.x]);
    }
    out0[c] = mul((S)s0, ratio);
    out1[c] = mul((S)s1, ratio);
  }
}

// y = normalized (+ clamp), the statistics from the sums; block row 0 writes
// mean and var
template <typename T, int V, bool ACT>
__global__ void __launch_bounds__(kThreads)
    bn_apply(const T* __restrict__ x, int C, long M, long chunk,
             const typename Acc<T>::S* __restrict__ s, const typename Acc<T>::S* __restrict__ q,
             typename Acc<T>::S n, const typename Acc<T>::S* __restrict__ scale,
             const typename Acc<T>::S* __restrict__ offset, T* __restrict__ y,
             typename Acc<T>::S* __restrict__ mean_out, typename Acc<T>::S* __restrict__ var_out) {
  using S = typename Acc<T>::S;
  using P = Pack<T, V>;
  bool live;
  const int c0 = first_channel<V>(C, live);
  if (!live) return;
  S m[V], a[V], off[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    m[j] = div(s[c0 + j], n);
    S v = sub(div(q[c0 + j], n), mul(m[j], m[j]));
    v = v < S(0) ? S(0) : v;
    a[j] = mul(inv_std(v), scale[c0 + j]);
    off[j] = offset[c0 + j];
    if (blockIdx.y == 0 && threadIdx.y == 0) {
      mean_out[c0 + j] = m[j];
      var_out[c0 + j] = v;
    }
  }
  const long r0 = (long)blockIdx.y * chunk;
  const long r1 = r0 + chunk < M ? r0 + chunk : M;
  const long step = (long)blockDim.y;
  for (long r = r0 + threadIdx.y; r < r1; r += step * kUnroll) {
    P xs[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (r + u * step < r1) xs[u] = *reinterpret_cast<const P*>(x + (r + u * step) * C + c0);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r + u * step < r1) {
        P out;
#pragma unroll
        for (int j = 0; j < V; ++j) {
          T yv = normalized<T, S>(widen(xs[u].v[j]), m[j], a[j], off[j]);
          if (ACT) {
            const S w = widen(yv);
            if (w < S(0)) yv = narrow<T>(S(0));
            if (w > S(6)) yv = narrow<T>(S(6));
          }
          out.v[j] = yv;
        }
        *reinterpret_cast<P*>(y + (r + u * step) * C + c0) = out;
      }
    }
  }
}

// dx; x is read for xhat (EXACT) and for the ReLU6's slope (ACT)
template <typename T, int V, bool ACT, bool EXACT>
__global__ void __launch_bounds__(kThreads)
    bn_dx(const T* __restrict__ dy, const T* __restrict__ x, int C, long M, long chunk,
          const typename Acc<T>::S* __restrict__ mean, const typename Acc<T>::S* __restrict__ var,
          const typename Acc<T>::S* __restrict__ scale,
          const typename Acc<T>::S* __restrict__ offset,
          const typename Acc<T>::S* __restrict__ g_off,
          const typename Acc<T>::S* __restrict__ g_sc, typename Acc<T>::S n, T* __restrict__ dx) {
  using S = typename Acc<T>::S;
  using P = Pack<T, V>;
  constexpr bool kReadX = ACT || EXACT;
  bool live;
  const int c0 = first_channel<V>(C, live);
  if (!live) return;
  S m[V], inv[V], a[V], off[V], k[V], go[V], gs[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    m[j] = mean[c0 + j];
    inv[j] = inv_std(var[c0 + j]);
    a[j] = mul(inv[j], scale[c0 + j]);
    off[j] = offset[c0 + j];
    // exact: scale * inv / n; subset: scale * inv
    k[j] = EXACT ? div(mul(scale[c0 + j], inv[j]), n) : mul(scale[c0 + j], inv[j]);
    go[j] = EXACT ? g_off[c0 + j] : S(0);
    gs[j] = EXACT ? g_sc[c0 + j] : S(0);
  }
  const long r0 = (long)blockIdx.y * chunk;
  const long r1 = r0 + chunk < M ? r0 + chunk : M;
  const long step = (long)blockDim.y;
  for (long r = r0 + threadIdx.y; r < r1; r += step * kUnroll) {
    P ds[kUnroll], xs[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long rr = r + u * step;
      if (rr < r1) {
        ds[u] = *reinterpret_cast<const P*>(dy + rr * C + c0);
        if (kReadX) xs[u] = *reinterpret_cast<const P*>(x + rr * C + c0);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long rr = r + u * step;
      if (rr < r1) {
        P out;
#pragma unroll
        for (int j = 0; j < V; ++j) {
          S d = widen(ds[u].v[j]);
          S xv = kReadX ? widen(xs[u].v[j]) : S(0);
          if (ACT) d = mul(d, relu6_slope<S>(widen(normalized<T, S>(xv, m[j], a[j], off[j]))));
          S g;
          if (EXACT) {
            const S xh = mul(sub(xv, m[j]), inv[j]);
            g = mul(k[j], sub(sub(mul(n, d), go[j]), mul(xh, gs[j])));
          } else {
            g = mul(d, k[j]);
          }
          out.v[j] = narrow<T>(g);
        }
        *reinterpret_cast<P*>(dx + rr * C + c0) = out;
      }
    }
  }
}

// ---- host side -----------------------------------------------------------------

struct Geo {
  int vec, tx, ty, cblocks, mblocks;
  long chunk;
};

inline int esize(int code) {
  return code == kF32 ? 4 : code == kBF16 ? 2 : code == kF64 ? 8 : 0;
}

// The launch geometry for `rows` rows of C channels: the widest vector (<=
// 16 bytes) that divides C and the addresses' alignment (align = OR of the
// operands' addresses), up to 32 vector columns a block split evenly over
// the column blocks, the rest of 256 threads on rows, about kTargetBlocks
// blocks, at least kUnroll rows a thread row where the rows allow.
inline Geo geometry(int code, int C, long rows, int align) {
  Geo g{};
  const int es = esize(code);
  if (es == 0 || C < 1 || rows < 0) return g;
  int v = 16 / es;
  while (v > 1 && (C % v != 0 || (align % (v * es)) != 0)) v >>= 1;
  const int L = C / v;
  g.vec = v;
  g.cblocks = (L + 31) / 32;
  g.tx = (L + g.cblocks - 1) / g.cblocks;
  g.ty = kThreads / g.tx;
  const long want = (kTargetBlocks + g.cblocks - 1) / g.cblocks;
  const long most = (rows + (long)g.ty * kUnroll - 1) / ((long)g.ty * kUnroll);
  long mb = most < want ? most : want;
  if (mb < 1) mb = 1;
  g.chunk = rows > 0 ? (rows + mb - 1) / mb : 0;
  g.mblocks = rows > 0 ? (int)((rows + g.chunk - 1) / g.chunk) : 1;
  return g;
}

template <typename F>
cudaError_t with_type(int code, F&& f) {
  switch (code) {
    case kF32:
      return f((float*)nullptr);
    case kBF16:
      return f((__nv_bfloat16*)nullptr);
    case kF64:
      return f((double*)nullptr);
  }
  return cudaErrorInvalidValue;
}

template <typename T, typename F>
cudaError_t with_vec(int vec, F&& f) {
  switch (vec) {
    case 1:
      return f(std::integral_constant<int, 1>());
    case 2:
      if constexpr (2 * sizeof(T) <= 16) return f(std::integral_constant<int, 2>());
      break;
    case 4:
      if constexpr (4 * sizeof(T) <= 16) return f(std::integral_constant<int, 4>());
      break;
    case 8:
      if constexpr (8 * sizeof(T) <= 16) return f(std::integral_constant<int, 8>());
      break;
  }
  return cudaErrorInvalidValue;
}

template <typename F>
cudaError_t with_flag(bool b, F&& f) {
  return b ? f(std::true_type()) : f(std::false_type());
}

// both sums: partial rows, then their merge
template <int MODE>
cudaError_t sums(int code, int C, long rows, int align, const void* x, const void* dy,
                 const void* mean, const void* var, const void* scale, const void* offset, int act,
                 double ratio, void* part, int nparts, void* out0, void* out1,
                 cudaStream_t stream) {
  const Geo g = geometry(code, C, rows, align);
  if (g.vec < 1 || g.mblocks != nparts) return cudaErrorInvalidValue;
  return with_type(code, [&](auto* tp) {
    using T = std::remove_pointer_t<decltype(tp)>;
    using S = typename Acc<T>::S;
    using R = typename Acc<T>::R;
    return with_vec<T>(g.vec, [&](auto vc) {
      constexpr int V = decltype(vc)::value;
      return with_flag(MODE == 1 && act, [&](auto ac) {
        constexpr bool A = decltype(ac)::value;
        bn_partials<T, V, MODE, A><<<dim3(g.cblocks, g.mblocks), dim3(g.tx, g.ty), 0, stream>>>(
            (const T*)x, (const T*)dy, C, rows, g.chunk, (const S*)mean, (const S*)var,
            (const S*)scale, (const S*)offset, (R*)part, nparts);
        cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return err;
        bn_merge<S, R><<<(C + 31) / 32, dim3(32, kMergeGroups), 0, stream>>>(
            (const R*)part, nparts, C, (S)ratio, (S*)out0, (S*)out1);
        return cudaGetLastError();
      });
    });
  });
}

}  // namespace bn
}  // namespace capk

extern "C" {

// Partial rows (blocks over the rows) of capk_bn_stats / capk_bn_grad_sums
// for `rows` rows of C channels of dtype `code` at addresses whose OR is
// `align` (0 for operands the kernels do not take).
int capk_bn_partial_rows(int code, int rows, int C, int align) {
  return capk::bn::geometry(code, C, rows, align).mblocks;
}

// s[C], q[C] = sums of x[m, c] and x[m, c]^2 over m < rows; part holds
// 2 x nparts x C of the running sums' dtype (double for float32 and
// float64 x, float for bf16), nparts = capk_bn_partial_rows.
// Returns cudaGetLastError() (cudaErrorInvalidValue for what it does not
// take).
int capk_bn_stats(int code, int M, int C, int rows, int align, const void* x, void* part,
                  int nparts, void* s, void* q, cudaStream_t stream) {
  if (rows > M) return (int)cudaErrorInvalidValue;
  return (int)capk::bn::sums<0>(code, C, rows, align, x, nullptr, nullptr, nullptr, nullptr,
                                nullptr, 0, 1.0, part, nparts, s, q, stream);
}

// y[M, C] (+ mean[C], var[C]) from the sums s, q over n rows.
int capk_bn_apply(int code, int M, int C, int align, const void* x, const void* s, const void* q,
                  double n, const void* scale, const void* offset, int act, void* y, void* mean,
                  void* var, cudaStream_t stream) {
  using namespace capk::bn;
  const Geo g = geometry(code, C, M, align);
  if (g.vec < 1 || M < 1) return (int)cudaErrorInvalidValue;
  return (int)with_type(code, [&](auto* tp) {
    using T = std::remove_pointer_t<decltype(tp)>;
    using S = typename Acc<T>::S;
    return with_vec<T>(g.vec, [&](auto vc) {
      constexpr int V = decltype(vc)::value;
      return with_flag(act != 0, [&](auto ac) {
        constexpr bool A = decltype(ac)::value;
        capk::bn::bn_apply<T, V, A><<<dim3(g.cblocks, g.mblocks), dim3(g.tx, g.ty), 0, stream>>>(
            (const T*)x, C, (long)M, g.chunk, (const S*)s, (const S*)q, (S)n, (const S*)scale,
            (const S*)offset, (T*)y, (S*)mean, (S*)var);
        return cudaGetLastError();
      });
    });
  });
}

// g_off[C], g_sc[C] = ratio x the sums of dy' and dy' * xhat over m < rows.
int capk_bn_grad_sums(int code, int C, int rows, int align, const void* dy, const void* x,
                      const void* mean, const void* var, const void* scale, const void* offset,
                      int act, double ratio, void* part, int nparts, void* g_off, void* g_sc,
                      cudaStream_t stream) {
  return (int)capk::bn::sums<1>(code, C, rows, align, x, dy, mean, var, scale, offset, act, ratio,
                                part, nparts, g_off, g_sc, stream);
}

// dx[M, C]: exact != 0 the exact BN's (g_off, g_sc the global sums over n
// rows), else the subset's; x may be null for the subset without act.
int capk_bn_dx(int code, int M, int C, int align, const void* dy, const void* x, const void* mean,
               const void* var, const void* scale, const void* offset, const void* g_off,
               const void* g_sc, double n, int act, int exact, void* dx, cudaStream_t stream) {
  using namespace capk::bn;
  const Geo g = geometry(code, C, M, align);
  if (g.vec < 1 || M < 1 || ((exact || act) && x == nullptr)) return (int)cudaErrorInvalidValue;
  return (int)with_type(code, [&](auto* tp) {
    using T = std::remove_pointer_t<decltype(tp)>;
    using S = typename Acc<T>::S;
    return with_vec<T>(g.vec, [&](auto vc) {
      constexpr int V = decltype(vc)::value;
      return with_flag(act != 0, [&](auto ac) {
        constexpr bool A = decltype(ac)::value;
        return with_flag(exact != 0, [&](auto ex) {
          constexpr bool E = decltype(ex)::value;
          capk::bn::bn_dx<T, V, A, E><<<dim3(g.cblocks, g.mblocks), dim3(g.tx, g.ty), 0, stream>>>(
              (const T*)dy, (const T*)x, C, (long)M, g.chunk, (const S*)mean, (const S*)var,
              (const S*)scale, (const S*)offset, (const S*)g_off, (const S*)g_sc, (S)n, (T*)dx);
          return cudaGetLastError();
        });
      });
    });
  });
}

}  // extern "C"
