// Eval-mode MobileNetV2 inverted-residual block with batch norm folded into
// its convolutions (kernel G):
//   e   = relu6(x @ we + be)           1x1 expand, float accumulation; 0 outside
//                                      the image (the depthwise's zero padding)
//   d   = round(relu6(dw3x3(e) + bd))  depthwise at stride 1 or 2, float
//   out = round(d @ wp + bp [+ x])     1x1 project, float; the residual in float
// with e kept in float, or rounded to the activation dtype (round_e: the chain
// kernel's rounding, and the encoder's fused path's).
//
// Replaces myimagecaptioningmodel_tpu/ops/pallas/fused_irb.py:187
// fused_inverted_residual and :355 fused_irb_chain. The TPU kernel takes one
// (image, row tile) per grid step with the expanded tensor [rows + 2, W + 2,
// Cexp] in VMEM (up to ~10 MB). An SM has 227 KB of shared memory, so here a
// block takes one (image, tile of th output rows x tw output columns, slice
// of Cexp) and walks its Cexp slice in chunks of 32 channels, one channel per
// lane:
//
//   1. stage the tile's input window, its output pixels' rows and columns
//      plus the 3x3 halo, as float in shared memory, once;
//   2. per chunk: stage the chunk's weights; for each output row, expand the
//      window rows it needs that are not yet expanded (a ring of 3 expanded
//      rows [3][window columns][32]), then its depthwise outputs into
//      ds [pixels][32]; then add ds @ wp[chunk] into a float accumulator
//      [pixels][Cout] in shared memory (a thread owns 16 pixels x 4
//      columns of each 64-column pass, in registers over the chunk);
//   3. the epilogue adds the bias and the residual, rounds once and stores;
//      when the Cexp slices are split over several blocks (splits > 1, to
//      fill the card when the batch gives few tiles), each stores its float
//      partial and irb_reduce adds them in a fixed order, then finishes as
//      the epilogue does.
//
// So the expanded tensor never reaches device memory: a block reads its input
// window (with a 1-row and 1-column halo) once, the weights once per block,
// and writes its output once. The tile is the largest (up to 256 output
// pixels) whose buffers fit the dynamic shared-memory limit, balanced over
// the image; the chain layout differs only in the input row offset and
// strides, and irb_chain_border writes its zero border rows, W tail and
// channel-pad lanes.
//
// What bounds it on an H100: at 224 px the blocks do 60-1,700 operations per
// byte they must move (input, output and weights once), so at the bf16
// tensor-core peak a block is bound by bytes at B=8 and by operations only in
// the 6x-expanded middle of the network; this first kernel multiplies on FMA
// units (a float32 peak 15x below bf16 tensor cores), so its products bound
// it. Expanded rows of a tile's halo are expanded again by the neighbouring
// tile (up to 2x at 112 px, none for whole-image tiles). Tensor-core
// products (wmma / wgmma) and overlapping the staging with the products are
// later work.
#include <algorithm>

#include "common.cuh"

namespace capk {

constexpr int kIrbThreads = 256;
constexpr int kIrbCE = 32;       // expanded channels per chunk, one per lane
constexpr int kIrbMaxPix = 256;  // output pixels of a tile
constexpr int kIrbNT = 64;       // project columns per pass: 16 threads x 4
constexpr int kIrbDLd = kIrbCE + 1;
constexpr int kIrbPJ = 4;  // expand positions per warp pass

// capk_fused_irb's ints, in order (fused_irb.py's _ARG_FIELDS)
enum IrbArg : int {
  kIDtype, kIBatch, kIHeight, kIWidth, kICin, kICexp, kICout, kIStride, kIShortcut, kIRoundE,
  kIXRow0, kIXRowStride, kIXColStride, kIOutRow0, kIOutRowStride, kIOutColStride,
  kIChainRows, kIChainCols, kIChainChans, kINumIrbArgs
};

struct IrbPlan {
  int ho, wo, th, tw, row_tiles, col_tiles, splits, cps;
  size_t smem;
};

struct IrbParams {
  const void* x;
  const void* we;
  const float *be, *wd, *bd;
  const void* wp;
  const float* bp;
  void* out;
  float* part;
  int B, H, W, cin, cexp, cout, stride, shortcut, round_e;
  long x_row0, x_row_stride, x_col_stride, x_batch;
  long out_row0, out_row_stride, out_col_stride, out_batch;
};

__device__ __forceinline__ float relu6f(float v) { return fminf(fmaxf(v, 0.f), 6.f); }
__device__ __forceinline__ float round_as(float v, const float*) { return v; }
__device__ __forceinline__ float round_as(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// Shared-memory floats of a (th x tw) tile, section by section.
struct IrbSmem {
  int xs, es, ds, acc, we, wp, be, bd, wd, total;
  __host__ __device__ IrbSmem(int th, int tw, int s, int cin, int cout) {
    const int wrows = (th - 1) * s + 3, wcols = (tw - 1) * s + 3, P = th * tw;
    int o = 0;
    xs = o;  o += wrows * wcols * cin;
    es = o;  o += 3 * wcols * kIrbCE;
    ds = o;  o += ceil_div(P, 16) * 16 * kIrbDLd;
    o = ceil_div(o, 4) * 4;
    acc = o; o += P * cout;
    we = o;  o += cin * kIrbCE;
    wp = o;  o += kIrbCE * ceil_div(cout, kIrbNT) * kIrbNT;
    be = o;  o += kIrbCE;
    bd = o;  o += kIrbCE;
    wd = o;  o += 9 * kIrbCE;
    total = o;
  }
};

template <typename T>
__global__ void __launch_bounds__(kIrbThreads) irb_fused(IrbParams p, IrbPlan pl) {
  extern __shared__ __align__(16) float sm[];
  const IrbSmem lay(pl.th, pl.tw, p.stride, p.cin, p.cout);
  float *xs = sm + lay.xs, *es = sm + lay.es, *ds = sm + lay.ds, *acc = sm + lay.acc;
  float *we_s = sm + lay.we, *wp_s = sm + lay.wp, *be_s = sm + lay.be, *bd_s = sm + lay.bd;
  float* wd_s = sm + lay.wd;
  const int s = p.stride, cin = p.cin, cout = p.cout, cexp = p.cexp;
  const int wld = ceil_div(cout, kIrbNT) * kIrbNT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid / 32, nwarps = kIrbThreads / 32;

  int bid = blockIdx.x;
  const int ct = bid % pl.col_tiles;
  bid /= pl.col_tiles;
  const int rt = bid % pl.row_tiles, b = bid / pl.row_tiles;
  const int r0 = rt * pl.th, q0 = ct * pl.tw;
  const int th = min(pl.th, pl.ho - r0), tw = min(pl.tw, pl.wo - q0), P = th * tw;
  const int xr = (th - 1) * s + 3, xc = (tw - 1) * s + 3;  // the tile's input window
  const int ir0 = r0 * s - 1, ic0 = q0 * s - 1;           // its origin in the image
  const T* x = static_cast<const T*>(p.x) + (long)b * p.x_batch;
  const T* we = static_cast<const T*>(p.we);
  const T* wp = static_cast<const T*>(p.wp);

  // 1. the input window, as float; zeros outside the image
  for (int i = tid; i < xr * xc * cin; i += kIrbThreads) {
    const int k = i % cin, rest = i / cin, wc = rest % xc, wr = rest / xc;
    const int ir = ir0 + wr, ic = ic0 + wc;
    xs[i] = (ir >= 0 && ir < p.H && ic >= 0 && ic < p.W)
                ? ld(x, (ir + p.x_row0) * p.x_row_stride + ic * p.x_col_stride + k)
                : 0.f;
  }
  for (int i = tid; i < P * cout; i += kIrbThreads) acc[i] = 0.f;

  const int nchunks = ceil_div(cexp, kIrbCE), split = blockIdx.y;
  const int ch_end = min(nchunks, (split + 1) * pl.cps);
  for (int ch = split * pl.cps; ch < ch_end; ++ch) {
    const int c0 = ch * kIrbCE;
    const bool live = c0 + lane < cexp;
    __syncthreads();  // the previous chunk's readers are done
    for (int i = tid; i < cin * kIrbCE; i += kIrbThreads) {
      const int c = c0 + i % kIrbCE;
      we_s[i] = c < cexp ? ld(we, (long)(i / kIrbCE) * cexp + c) : 0.f;
    }
    for (int i = tid; i < kIrbCE * wld; i += kIrbThreads) {
      const int c = c0 + i / wld, n = i % wld;
      wp_s[i] = c < cexp && n < cout ? ld(wp, (long)c * cout + n) : 0.f;
    }
    if (tid < kIrbCE) {
      be_s[tid] = live ? p.be[c0 + tid] : 0.f;
      bd_s[tid] = live ? p.bd[c0 + tid] : 0.f;
#pragma unroll
      for (int t = 0; t < 9; ++t) wd_s[t * kIrbCE + tid] = live ? p.wd[t * cexp + c0 + tid] : 0.f;
    }
    __syncthreads();

    // 2. expand + depthwise, one output row at a time
    for (int i = 0; i < th; ++i) {
      for (int dy = i == 0 ? 0 : 3 - s; dy < 3; ++dy) {  // window rows not yet expanded
        const int wr = i * s + dy, ir = ir0 + wr;
        const bool row_in = ir >= 0 && ir < p.H;
        const float* xrow = xs + (long)wr * xc * cin;
        float* e = es + (wr % 3) * xc * kIrbCE;
        for (int w0 = warp * kIrbPJ; w0 < xc; w0 += nwarps * kIrbPJ) {
          float a[kIrbPJ] = {};
          if (row_in) {
            for (int k = 0; k < cin; k += 4) {
              const float w_0 = we_s[(k + 0) * kIrbCE + lane], w_1 = we_s[(k + 1) * kIrbCE + lane];
              const float w_2 = we_s[(k + 2) * kIrbCE + lane], w_3 = we_s[(k + 3) * kIrbCE + lane];
#pragma unroll
              for (int j = 0; j < kIrbPJ; ++j) {
                const int wc = min(w0 + j, xc - 1);
                const float4 v = *reinterpret_cast<const float4*>(xrow + wc * cin + k);
                a[j] = fmaf(v.x, w_0, a[j]);
                a[j] = fmaf(v.y, w_1, a[j]);
                a[j] = fmaf(v.z, w_2, a[j]);
                a[j] = fmaf(v.w, w_3, a[j]);
              }
            }
          }
#pragma unroll
          for (int j = 0; j < kIrbPJ; ++j) {
            const int wc = w0 + j, ic = ic0 + wc;
            if (wc >= xc) continue;
            float v = row_in && ic >= 0 && ic < p.W ? relu6f(a[j] + be_s[lane]) : 0.f;
            if (p.round_e) v = round_as(v, we);
            e[wc * kIrbCE + lane] = v;
          }
        }
      }
      __syncthreads();
      for (int j = warp; j < tw; j += nwarps) {
        float a = 0.f;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const float* e = es + ((i * s + dy) % 3) * xc * kIrbCE + j * s * kIrbCE + lane;
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) a = fmaf(e[dx * kIrbCE], wd_s[(dy * 3 + dx) * kIrbCE + lane], a);
        }
        ds[(i * tw + j) * kIrbDLd + lane] = round_as(relu6f(a + bd_s[lane]), we);
      }
      __syncthreads();  // the next row's expand overwrites the ring
    }

    // acc[P][cout] += ds[P][32] @ wp_s[32][cout]
    const int tn = tid % 16, tp = tid / 16;
    for (int n0 = 0; n0 < cout; n0 += kIrbNT) {
      const int n = n0 + 4 * tn;
      if (n >= cout) continue;
      float a[16][4] = {};
      for (int c = 0; c < kIrbCE; ++c) {
        const float4 w = *reinterpret_cast<const float4*>(wp_s + c * wld + n);
#pragma unroll
        for (int jj = 0; jj < 16; ++jj) {
          const int pix = tp + 16 * jj;
          const float d = pix < P ? ds[pix * kIrbDLd + c] : 0.f;
          a[jj][0] = fmaf(d, w.x, a[jj][0]);
          a[jj][1] = fmaf(d, w.y, a[jj][1]);
          a[jj][2] = fmaf(d, w.z, a[jj][2]);
          a[jj][3] = fmaf(d, w.w, a[jj][3]);
        }
      }
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) {
        const int pix = tp + 16 * jj;
        if (pix >= P) continue;
        float4* o = reinterpret_cast<float4*>(acc + pix * cout + n);
        float4 v = *o;
        v.x += a[jj][0];
        v.y += a[jj][1];
        v.z += a[jj][2];
        v.w += a[jj][3];
        *o = v;
      }
    }
  }
  __syncthreads();

  // 3. the epilogue, or this slice's float partial
  T* out = static_cast<T*>(p.out) + (long)b * p.out_batch;
  for (int i = tid; i < P * cout; i += kIrbThreads) {
    const int pix = i / cout, n = i % cout, r = r0 + pix / tw, q = q0 + pix % tw;
    float v = acc[i];
    if (p.part != nullptr) {
      p.part[((((long)split * p.B + b) * pl.ho + r) * pl.wo + q) * cout + n] = v;
      continue;
    }
    v += p.bp[n];
    if (p.shortcut) v += ld(x, (r + p.x_row0) * p.x_row_stride + q * p.x_col_stride + n);
    store_as(out + (r + p.out_row0) * p.out_row_stride + q * p.out_col_stride + n, v);
  }
}

// out = round(sum of the splits' partials in order + bp [+ x]).
template <typename T>
__global__ void __launch_bounds__(256) irb_reduce(IrbParams p, int splits, int ho, int wo) {
  const long total = (long)p.B * ho * wo * p.cout;
  const T* x = static_cast<const T*>(p.x);
  T* out = static_cast<T*>(p.out);
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < total;
       i += (long)gridDim.x * blockDim.x) {
    float v = p.part[i];
    for (int s = 1; s < splits; ++s) v += p.part[s * total + i];
    const int n = i % p.cout;
    long rest = i / p.cout;
    const int q = rest % wo;
    rest /= wo;
    const int r = rest % ho;
    const long b = rest / ho;
    v += p.bp[n];
    if (p.shortcut)
      v += ld(x, b * p.x_batch + (r + p.x_row0) * p.x_row_stride + q * p.x_col_stride + n);
    store_as(out + b * p.out_batch + (r + p.out_row0) * p.out_row_stride + q * p.out_col_stride + n,
             v);
  }
}

// The chain layout's zeros: border rows, W tail and channel-pad lanes.
template <typename T>
__global__ void __launch_bounds__(256)
    irb_chain_border(T* out, long total, int rows, int cols, int chans, int wo, int cout) {
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < total;
       i += (long)gridDim.x * blockDim.x) {
    const int c = i % chans, q = (i / chans) % cols, r = (i / ((long)chans * cols)) % rows;
    if (r == 0 || r == rows - 1 || q >= wo || c >= cout) store_as(out + i, 0.f);
  }
}

static int sm_count() {
  static int cached[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cached[dev] == 0 &&
      cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return cached[dev];
}

// The tile, the grid and the Cexp split for these shapes; false if none fits.
static bool irb_plan(const int* a, IrbPlan* pl) {
  const int B = a[kIBatch], H = a[kIHeight], W = a[kIWidth], s = a[kIStride];
  const int cin = a[kICin], cexp = a[kICexp], cout = a[kICout];
  if (B < 1 || H < 1 || W < 1 || (s != 1 && s != 2) || cin < 8 || cin % 8 || cexp < 8 ||
      cexp % 8 || cout < 8 || cout % 8 || (a[kIShortcut] && (s != 1 || cin != cout)))
    return false;
  const int sms = sm_count();
  if (sms == 0) return false;
  pl->ho = (H - 1) / s + 1;
  pl->wo = (W - 1) / s + 1;
  pl->th = 0;
  for (int tw = std::min(pl->wo, kIrbMaxPix); tw >= 1 && pl->th == 0; tw = tw == 1 ? 0 : ceil_div(tw, 2))
    for (int th = std::min(pl->ho, kIrbMaxPix / tw); th >= 1; --th)
      if ((size_t)IrbSmem(th, tw, s, cin, cout).total * 4 <= kMaxDynamicSmem) {
        pl->th = th;
        pl->tw = tw;
        break;
      }
  if (pl->th == 0) return false;
  pl->row_tiles = ceil_div(pl->ho, pl->th);  // balanced: the last tile is not a sliver
  pl->th = ceil_div(pl->ho, pl->row_tiles);
  pl->col_tiles = ceil_div(pl->wo, pl->tw);
  pl->tw = ceil_div(pl->wo, pl->col_tiles);
  pl->smem = (size_t)IrbSmem(pl->th, pl->tw, s, cin, cout).total * 4;
  const long base = (long)B * pl->row_tiles * pl->col_tiles;
  if (base > INT_MAX) return false;
  const int nchunks = ceil_div(cexp, kIrbCE);
  const int want = ceil_div(2 * sms, (int)std::min(base, (long)2 * sms));  // two waves of blocks
  const int splits = std::min(nchunks, want);
  pl->cps = ceil_div(nchunks, splits);
  pl->splits = ceil_div(nchunks, pl->cps);
  return true;
}

static int grid_for(long total) { return (int)std::min((total + 255) / 256, 4096L); }

template <typename T>
static int irb_launch(const int* a, const IrbParams& p, const IrbPlan& pl, cudaStream_t stream) {
  static const bool raised = raise_smem_limit(irb_fused<T>);
  if (!raised) return (int)cudaErrorInvalidValue;
  irb_fused<T><<<dim3(p.B * pl.row_tiles * pl.col_tiles, pl.splits), kIrbThreads, pl.smem,
                 stream>>>(p, pl);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (pl.splits > 1) {
    irb_reduce<T><<<grid_for((long)p.B * pl.ho * pl.wo * p.cout), 256, 0, stream>>>(
        p, pl.splits, pl.ho, pl.wo);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (a[kIChainRows] > 0) {
    const long total = (long)p.B * a[kIChainRows] * a[kIChainCols] * a[kIChainChans];
    irb_chain_border<T><<<grid_for(total), 256, 0, stream>>>(
        static_cast<T*>(p.out), total, a[kIChainRows], a[kIChainCols], a[kIChainChans], pl.wo,
        p.cout);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace capk

extern "C" {

// The number of Cexp splits capk_fused_irb will use for these ints (then
// `part` must hold splits x B x Hout x Wout x Cout floats when splits > 1),
// or 0 for shapes the kernel does not take.
int capk_fused_irb_splits(const int* args) {
  capk::IrbPlan pl;
  return capk::irb_plan(args, &pl) ? pl.splits : 0;
}

// One block (kernel G) on `stream`. args: capk::IrbArg's fields; ptrs: x,
// we [Cin, Cexp], be [Cexp], wd [9, Cexp], bd [Cexp], wp [Cexp, Cout], bp
// [Cout], out, part (x, we, wp and out in the dtype; the rest float32). x
// pixel (b, r, c) channel k lies at b * x_batch + (r + x_row0) *
// x_row_stride + c * x_col_stride + k with x_batch = (H + 2 x_row0) *
// x_row_stride, and likewise out. chain_rows > 0: out is the chain layout
// [B, chain_rows, chain_cols, chain_chans] and its pad is written with
// zeros. Returns a CUDA error code (cudaErrorInvalidValue for shapes the
// kernel does not take).
int capk_fused_irb(const int* a, void* const* ptrs, cudaStream_t stream) {
  using namespace capk;
  IrbPlan pl;
  if (!irb_plan(a, &pl)) return (int)cudaErrorInvalidValue;
  IrbParams p{};
  p.x = ptrs[0];
  p.we = ptrs[1];
  p.be = static_cast<const float*>(ptrs[2]);
  p.wd = static_cast<const float*>(ptrs[3]);
  p.bd = static_cast<const float*>(ptrs[4]);
  p.wp = ptrs[5];
  p.bp = static_cast<const float*>(ptrs[6]);
  p.out = ptrs[7];
  p.part = static_cast<float*>(ptrs[8]);
  if (pl.splits > 1 && p.part == nullptr) return (int)cudaErrorInvalidValue;
  if (pl.splits == 1) p.part = nullptr;
  p.B = a[kIBatch];
  p.H = a[kIHeight];
  p.W = a[kIWidth];
  p.cin = a[kICin];
  p.cexp = a[kICexp];
  p.cout = a[kICout];
  p.stride = a[kIStride];
  p.shortcut = a[kIShortcut];
  p.round_e = a[kIRoundE];
  p.x_row0 = a[kIXRow0];
  p.x_row_stride = a[kIXRowStride];
  p.x_col_stride = a[kIXColStride];
  p.x_batch = (long)(p.H + 2 * a[kIXRow0]) * a[kIXRowStride];
  p.out_row0 = a[kIOutRow0];
  p.out_row_stride = a[kIOutRowStride];
  p.out_col_stride = a[kIOutColStride];
  p.out_batch = (long)(pl.ho + 2 * a[kIOutRow0]) * a[kIOutRowStride];
  if (a[kIDtype] == kBF16) return irb_launch<__nv_bfloat16>(a, p, pl, stream);
  if (a[kIDtype] == kF32) return irb_launch<float>(a, p, pl, stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
